"""The port's elastic mesh against the reference's, on the CPU.

One counterpart of each case of the reference's ``tests/test_elastic.py``.
Where a case runs the package's own functions, both packages run on the
same inputs and must agree exactly (a proof-of-work chain has no
tolerance): the re-stripe partition for every dead subset, the guarded
collective under each fault kind, the shard oracle's evict, restart and
grace verdicts on the same shard directories, the seeded victim draws,
the membership through the checkpoint sidecar and a torn-tail recovery,
the striped miner's records (``hashes_tried`` included), the in-process
shrink (the port's ``CudaBackend`` of logical miners, with the plain sweep
on the CPU, against the reference's jnp mesh), and the CLI. A three-rank
``mine --elastic`` world with a seeded ``mesh.rank_death`` runs through
both CLIs as rank processes, and every survivor's causal dump must be the
same bytes.
"""
import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from mpi_blockchain_tpu import cli as ref_cli
from mpi_blockchain_tpu import core as ref_core
from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu.parallel import mesh as ref_mesh
from mpi_blockchain_tpu.resilience import elastic as ref_elastic
from mpi_blockchain_tpu.resilience import injection as ref_injection
from mpi_blockchain_tpu.resilience import policy as ref_policy
from mpi_blockchain_tpu.resilience.faultplan import FaultPlan as RefPlan
from mpi_blockchain_tpu.utils import checkpoint as ref_checkpoint
from mpi_blockchain_tpu_torch import chainwatch, cli, core, telemetry
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig
from mpi_blockchain_tpu_torch.meshwatch import shard as mesh_shard
from mpi_blockchain_tpu_torch.meshwatch.world import REPO_ROOT, reap
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.parallel.mesh import NONCE_SPACE, \
    stripe_windows
from mpi_blockchain_tpu_torch.resilience import (RankLossSuspected,
                                                 RetryExhausted, injection,
                                                 policy)
from mpi_blockchain_tpu_torch.resilience.elastic import (
    ElasticMeshBackend, ElasticMiner, ElasticWorld, confirmed_dead,
    guarded_collective)
from mpi_blockchain_tpu_torch.resilience.faultplan import FaultPlan
from mpi_blockchain_tpu_torch.utils import checkpoint

PACKAGES = {
    "port": (ElasticWorld, injection, FaultPlan, confirmed_dead),
    "ref": (ref_elastic.ElasticWorld, ref_injection, RefPlan,
            ref_elastic.confirmed_dead),
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("MPIBT_FAULT_PLAN", raising=False)
    monkeypatch.delenv("MPIBT_MESH_OBS", raising=False)
    telemetry.reset()
    ref_telemetry.reset()
    yield
    injection.disarm()
    ref_injection.disarm()
    mesh_shard.uninstall()
    chainwatch.uninstall()


def _both(fn):
    """``fn(*PACKAGES[name])`` for both packages, each armed plan disarmed
    after its run; returns (port's, reference's)."""
    out = []
    for name in ("port", "ref"):
        try:
            out.append(fn(*PACKAGES[name]))
        finally:
            PACKAGES[name][1].disarm()
    return tuple(out)


# ---- re-striping: the partition property --------------------------------


def _all_windows(stripe, live: list[int], batch: int, space: int):
    return [w for j in range(len(live))
            for w in stripe(j, len(live), batch, space)]


@pytest.mark.parametrize("space,batch", [(1 << 10, 1 << 5), (1000, 48),
                                         (1 << 8, 1 << 8)])
def test_restripe_partitions_space_for_every_dead_subset(space, batch):
    """For every (world_size <= 8, dead subset) pair the survivors' stripes
    tile the space edge to edge (no gap, no overlap), and each survivor's
    windows are the reference's."""
    for world in range(1, 9):
        ranks = list(range(world))
        for k in range(world):
            for dead in itertools.combinations(ranks, k):
                live = [r for r in ranks if r not in dead]
                got = _all_windows(stripe_windows, live, batch, space)
                assert got == _all_windows(ref_mesh.stripe_windows, live,
                                           batch, space)
                windows = sorted(got)
                assert windows[0][0] == 0 and windows[-1][1] == space
                for (s0, e0), (s1, e1) in zip(windows, windows[1:]):
                    assert e0 == s1, (world, dead, windows)
                assert sum(e - s for s, e in windows) == space


def test_stripe_windows_single_rank_is_one_window():
    assert list(stripe_windows(0, 1, 64, 1 << 20)) == \
        list(ref_mesh.stripe_windows(0, 1, 64, 1 << 20)) == [(0, 1 << 20)]


def test_stripe_windows_validates_inputs():
    for bad in ((3, 3, 64), (0, 2, 0)):
        with pytest.raises(ConfigError):
            list(stripe_windows(*bad))


# ---- guarded collectives -------------------------------------------------


def test_guarded_collective_returns_result_and_reraises():
    assert guarded_collective(lambda: 41 + 1, site="t", timeout_s=5) == 42
    with pytest.raises(ZeroDivisionError):
        guarded_collective(lambda: 1 / 0, site="t", timeout_s=5)


def test_guarded_collective_timeout_raises_rank_loss():
    t0 = time.monotonic()
    with pytest.raises(RankLossSuspected) as ei:
        guarded_collective(lambda: time.sleep(10), site="winner_select",
                           timeout_s=0.15)
    assert time.monotonic() - t0 < 5
    assert ei.value.site == "winner_select" and ei.value.elapsed_s >= 0.15
    assert telemetry.default_registry().total(
        "collective_timeouts_total") == 1
    events = telemetry.recent_events(event="collective_timeout")
    assert events and events[-1]["site"] == "winner_select"


def test_guarded_collective_reuses_worker_but_abandons_wedged():
    """Sequential dispatches ride one pooled worker thread; a timed-out
    dispatch abandons its worker, so the next gets a fresh one."""
    idents = [guarded_collective(lambda: threading.get_ident(), site="t",
                                 timeout_s=5) for _ in range(3)]
    assert len(set(idents)) == 1 and idents[0] != threading.get_ident()
    with pytest.raises(RankLossSuspected):
        guarded_collective(lambda: time.sleep(30), site="t",
                           timeout_s=0.05)
    assert guarded_collective(lambda: threading.get_ident(), site="t",
                              timeout_s=5) != idents[0]


@pytest.mark.parametrize("kind", ["raise", "hang", "corrupt", "partial"])
def test_guarded_collective_injected_fault_is_rank_loss(kind):
    """Every parallel.collective fault kind surfaces as suspicion, with the
    reference's message; a disarmed guard passes the call through."""
    spec = {"faults": [{"site": "parallel.collective", "kind": kind,
                        "call": 0, "seconds": 0.01}]}

    def run(world_cls, inj, plan_cls, dead):
        guard = (guarded_collective if inj is injection
                 else ref_elastic.guarded_collective)
        inj.arm(plan_cls.from_dict(spec))
        with pytest.raises(Exception) as ei:
            guard(lambda: 1, site="t", timeout_s=5)
        inj.disarm()
        return type(ei.value).__name__, ei.value.site, str(ei.value), \
            guard(lambda: 1, site="t", timeout_s=5)

    got, want = _both(run)
    assert got == want and got[0] == "RankLossSuspected" and got[3] == 1


# ---- the mesh.rebuild policy entry --------------------------------------


def test_policy_mesh_rebuild_entry(monkeypatch):
    def attempts():
        got = policy.policy_for("mesh.rebuild").max_attempts
        assert got == ref_policy.policy_for("mesh.rebuild").max_attempts
        return got

    assert attempts() == 2
    monkeypatch.setenv("MPIBT_MESH_REBUILD_RETRIES", "5")
    assert attempts() == 5
    monkeypatch.setenv("MPIBT_MAX_RETRIES", "1")   # the global cap wins
    assert attempts() == 1


# ---- ElasticWorld: membership, oracle, determinism -----------------------


def test_world_evict_restripes_and_reports():
    def run(world_cls, inj, plan_cls, dead):
        w = world_cls(4, 1)
        assert w.index() == 1 and w.n_live == 4
        assert w.evict(3, "test", height=5)
        assert not w.evict(3, "test")            # idempotent
        assert not w.evict(1, "test")            # never self
        assert w.live == [0, 1, 2] and w.index() == 1
        assert w.evict(0, "test", height=6)
        assert w.index() == 0                    # dense index re-striped
        return w.summary(), w.log.events(), w.membership(), \
            list(w.stripe_windows(1 << 30))

    got, want = _both(run)
    assert got == want
    assert [r["kind"] for r in got[1]] == ["mesh_shrunk", "mesh_shrunk"]
    assert telemetry.gauge("mesh_live_ranks").value == 2
    assert telemetry.default_registry().total(
        "mesh_evicted_ranks_total") == 2


def _write_shard(directory, rank, *, age_s=0.0, final=False,
                 exit_status=None, world=4, heartbeat_age_s=0.05):
    directory.mkdir(parents=True, exist_ok=True)
    (directory / f"rank_{rank:04d}.json").write_text(json.dumps({
        "version": 1, "rank": rank, "world_size": world, "pid": 1,
        "seq": 1, "final": final, "exit_status": exit_status,
        "written_at": time.time() - age_s, "started_at": time.time() - 60,
        "heartbeats": {"miner_heartbeat": {"value": 1,
                                           "age_s": heartbeat_age_s}},
        "registry": {}, "events_tail": [], "causal_tail": {},
        "pipeline": []}))


def test_oracle_evicts_dead_shard_and_failed_but_not_wedged(tmp_path):
    obs = tmp_path / "mesh"
    _write_shard(obs, 0)                                  # self, fresh
    _write_shard(obs, 1, age_s=30.0)                      # dead-shard
    _write_shard(obs, 2, final=True, exit_status=0)       # finished
    _write_shard(obs, 3, final=True, exit_status=2)       # failed

    def run(world_cls, inj, plan_cls, dead):
        verdict = sorted(dead(obs, [0, 1, 2, 3], 0, stall_s=1.0))
        w = world_cls(4, 0, obs_dir=obs, stall_s=1.0)
        w.step(height=1)
        return verdict, w.summary(), w.log.events()

    got, want = _both(run)
    assert got == want
    assert got[0] == [(1, "dead-shard"), (3, "failed")]
    assert got[1]["live"] == [0, 2]


def test_oracle_no_progress_is_restart_not_evict(tmp_path):
    """A live but wedged rank (fresh shard, stale heartbeat) reads
    ``restart``: evicting a rank that later recovers would re-overlap its
    stripes."""
    obs = tmp_path / "mesh"
    _write_shard(obs, 0)
    _write_shard(obs, 1, heartbeat_age_s=500.0)
    got, want = _both(lambda w, i, p, dead: dead(
        obs, [0, 1], 0, stall_s=10.0, heartbeat_stall_s=1.0))
    assert got == want == []


def test_oracle_missing_needs_grace(tmp_path):
    obs = tmp_path / "mesh"
    _write_shard(obs, 0)
    got, want = _both(lambda w, i, p, dead: (
        dead(obs, [0, 1], 0, stall_s=1.0),
        dead(obs, [0, 1], 0, stall_s=1.0, allow_missing=True)))
    assert got == want == ([], [(1, "missing")])


def test_rank_death_victim_is_seeded_and_agreed_across_ranks():
    spec = {"seed": 9, "faults": [
        {"site": "mesh.rank_death", "kind": "partial", "call": 1}]}

    def run(world_cls, inj, plan_cls, dead):
        deaths = {}
        for rank in range(4):
            inj.arm(plan_cls.from_dict(spec))
            exited: list[int] = []
            w = world_cls(4, rank, hard_exit=exited.append)
            w.step(1)      # call 0: no fault
            w.step(2)      # call 1: fires
            deaths[rank] = (exited, [e["rank"] for e in w.evicted],
                            w.log.events())
            inj.disarm()
        return deaths

    got, want = _both(run)
    assert got == want
    victims = {ev[0] if ev else rank
               for rank, (ex, ev, _) in got.items()}
    assert len(victims) == 1
    victim = victims.pop()
    assert victim != 0                       # never the anchor rank
    for rank, (exited, evicted, _) in got.items():
        if rank == victim:
            assert exited == [137] and evicted == []
        else:
            assert exited == [] and evicted == [victim]


def test_rank_death_draw_ignores_oracle_desynced_live_sets():
    spec = {"seed": 9, "faults": [
        {"site": "mesh.rank_death", "kind": "partial", "call": 0}]}

    def run(world_cls, inj, plan_cls, dead):
        drawn = []
        for oracle_evicted in (None, 1, 3):
            inj.arm(plan_cls.from_dict(spec))
            w = world_cls(4, 0, hard_exit=lambda rc: None)
            if oracle_evicted is not None:
                assert w.evict(oracle_evicted, "dead_shard", height=0)
            w.step(1)
            drawn.append(sorted(w._death_victims))
            inj.disarm()
        return drawn

    got, want = _both(run)
    assert got == want
    assert got[0] == got[1] == got[2] and len(got[0]) == 1


def test_rank_death_consecutive_draws_kill_distinct_ranks():
    spec = {"seed": 5, "faults": [
        {"site": "mesh.rank_death", "kind": "partial", "call": 0},
        {"site": "mesh.rank_death", "kind": "partial", "call": 1}]}

    def run(world_cls, inj, plan_cls, dead):
        inj.arm(plan_cls.from_dict(spec))
        w = world_cls(6, 0, hard_exit=lambda rc: None)
        w.step(1)
        w.step(2)
        return sorted(w._death_victims), w.summary()

    got, want = _both(run)
    assert got == want
    assert len(got[0]) == 2 and 0 not in got[0]


def test_rank_death_explicit_victim_message():
    spec = {"faults": [{"site": "mesh.rank_death", "kind": "corrupt",
                        "call": 0, "message": "rank=2"}]}

    def run(world_cls, inj, plan_cls, dead):
        inj.arm(plan_cls.from_dict(spec))
        w = world_cls(4, 0, hard_exit=lambda rc: None)
        w.step(1)
        return w.evicted, w.log.events()

    got, want = _both(run)
    assert got == want and [e["rank"] for e in got[0]] == [2]


# ---- checkpointed membership --------------------------------------------


def _mined(blocks: int) -> Miner:
    miner = Miner(MinerConfig(difficulty_bits=8, n_blocks=blocks,
                              backend="cpu"))
    miner.mine_chain()
    return miner


def test_membership_rides_checkpoint_sidecar(tmp_path):
    cfg = MinerConfig(difficulty_bits=8, n_blocks=2, backend="cpu")
    miner = _mined(2)
    w = ElasticWorld(4, 0)
    w.evict(2, "rank_death", height=1)
    path = tmp_path / "ck.bin"
    checkpoint.save_chain(miner.node, path, cfg, mesh=w.membership())

    node, report = checkpoint.recover_chain(path, 8)
    ref_node, ref_report = ref_checkpoint.recover_chain(path, 8)
    assert node.height == ref_node.height == 2
    assert report["mesh"] == ref_report["mesh"] == {
        "world_size": 4, "live": [0, 1, 3],
        "evicted": [{"rank": 2, "reason": "rank_death", "height": 1}]}
    for world_cls in (ElasticWorld, ref_elastic.ElasticWorld):
        restored = world_cls(4, 0)
        restored.restore(report["mesh"])
        assert restored.live == [0, 1, 3] and restored.evicted == w.evicted
        assert [r["kind"] for r in restored.log.events()] == \
            ["membership_restored"]
        # A dead rank must not resume into stripes the survivors
        # re-covered.
        with pytest.raises(Exception, match="evicted this rank"):
            world_cls(4, 2).restore(report["mesh"])


def test_membership_survives_torn_tail_recovery(tmp_path):
    cfg = MinerConfig(difficulty_bits=8, n_blocks=3, backend="cpu")
    miner = _mined(3)
    w = ElasticWorld(2, 0)
    w.evict(1, "dead-shard", height=2)
    for name, recover in (("p", checkpoint.recover_chain),
                          ("r", ref_checkpoint.recover_chain)):
        path = tmp_path / f"{name}.bin"
        checkpoint.save_chain(miner.node, path, cfg, mesh=w.membership())
        path.write_bytes(path.read_bytes()[:-120])       # torn tail
        node, report = recover(path, 8)
        assert report["recovered"] and node.height == 2
        assert report["mesh"]["live"] == [0]    # kept through the rewrite


# ---- the striped elastic miner ------------------------------------------


@pytest.mark.parametrize("port_cfg,ref_cfg", [
    ({"backend": "cpu"}, {"backend": "cpu"}),
    ({"backend": "cuda", "kernel": "torch", "device": "cpu"},
     {"backend": "tpu", "kernel": "jnp"}),
], ids=["cpp_sweep", "plain_torch_sweep"])
def test_elastic_miner_sweeps_only_its_stripes_and_mines_valid_chain(
        port_cfg, ref_cfg):
    """Records equal the reference's (nonce, hash and the stripe's
    hashes_tried accounting), before and after a mid-run re-stripe."""
    def run(pkg):
        if pkg == "port":
            w = ElasticWorld(3, 1)
            cfg = MinerConfig(difficulty_bits=10, n_blocks=3,
                              batch_pow2=12, **port_cfg)
            miner = ElasticMiner(cfg, w)
        else:
            w = ref_elastic.ElasticWorld(3, 1)
            cfg = RefConfig(difficulty_bits=10, n_blocks=3, batch_pow2=12,
                            **ref_cfg)
            miner = ref_elastic.ElasticMiner(cfg, w, log_fn=lambda d: None)
        recs = miner.mine_chain()
        for rec in recs:
            assert any(s <= rec.nonce < e
                       for s, e in w.stripe_windows(cfg.batch_size)), rec
        w.evict(0, "test", height=3)     # mid-run re-stripe
        assert w.index() == 0
        recs = recs + miner.mine_chain(2)
        return ([(r.height, r.nonce, r.hash, r.hashes_tried)
                 for r in recs], miner.node.save(), w.log.events())

    got, want = run("port"), run("ref")
    assert got == want
    assert core.Node(10).load(got[1]) and ref_core.Node(10, 0).load(got[1])
    assert [r["height"] for r in got[2] if r["kind"] == "mine"] == \
        [1, 2, 3, 4, 5]


def test_default_miner_single_window_unchanged():
    assert tuple(Miner(MinerConfig(difficulty_bits=8, backend="cpu"))
                 .search_windows()) == ((0, NONCE_SPACE),)


# ---- the in-process flavor ----------------------------------------------


def _mesh_cfg(**kw) -> MinerConfig:
    return MinerConfig(backend="cuda", kernel="torch", device="cpu", **kw)


def test_mesh_backend_shrinks_and_chain_stays_byte_identical():
    """An injected collective fault mid-run shrinks the logical miners
    4 -> 3, as the reference's jnp mesh shrinks its devices; the chain is
    byte-identical to both packages' C++ oracle anyway."""
    spec = {"faults": [{"site": "parallel.collective", "kind": "raise",
                        "call": 2, "times": 1}]}
    cfg = _mesh_cfg(difficulty_bits=10, n_blocks=4, n_miners=4,
                    batch_pow2=10)
    injection.arm(FaultPlan.from_dict(spec))
    backend = ElasticMeshBackend(cfg)
    miner = Miner(cfg, backend=backend)
    miner.mine_chain()
    injection.disarm()
    assert backend.n_live == 3 and backend.summary()["shrunk"]
    # The miners' count has its own gauge: mesh_live_ranks counts rank
    # processes.
    assert telemetry.gauge("mesh_live_devices").value == 3

    ref_cfg = RefConfig(difficulty_bits=10, n_blocks=4, backend="tpu",
                        kernel="jnp", n_miners=4, batch_pow2=10)
    ref_injection.arm(RefPlan.from_dict(spec))
    ref_backend = ref_elastic.ElasticMeshBackend(ref_cfg)
    ref_miner = RefMiner(ref_cfg, backend=ref_backend,
                         log_fn=lambda d: None)
    ref_miner.mine_chain()
    ref_injection.disarm()
    assert backend.summary() == ref_backend.summary()

    oracle = RefMiner(RefConfig(difficulty_bits=10, n_blocks=4,
                                backend="cpu"), log_fn=lambda d: None)
    oracle.mine_chain()
    assert miner.node.save() == ref_miner.node.save() == \
        oracle.node.save()


def test_mesh_backend_exhausted_shrink_reraises():
    backend = ElasticMeshBackend(_mesh_cfg(difficulty_bits=8, n_blocks=1,
                                           n_miners=2, batch_pow2=8))
    # Call 0 (the search at 2 miners) and call 2 (at 1) die; the rebuild
    # between them (call 1) succeeds. The shrink floors at one miner, then
    # the suspicion re-raises instead of looping.
    injection.arm(FaultPlan.from_dict({"faults": [
        {"site": "parallel.collective", "kind": "raise", "call": 0,
         "times": 1},
        {"site": "parallel.collective", "kind": "raise", "call": 2,
         "times": 1}]}))
    with pytest.raises(RankLossSuspected):
        backend.search(bytes(80), 8)
    assert backend.n_live == 1


def test_mesh_backend_wedged_rebuild_is_retry_exhausted():
    """A rebuild that keeps dying surfaces as RetryExhausted under the
    mesh.rebuild budget (CLI rc 2), not an endless shrink loop."""
    backend = ElasticMeshBackend(_mesh_cfg(difficulty_bits=8, n_blocks=1,
                                           n_miners=2, batch_pow2=8))
    injection.arm(FaultPlan.from_dict({"faults": [
        {"site": "parallel.collective", "kind": "raise", "call": 0,
         "times": -1}]}))
    with pytest.raises(RetryExhausted) as ei:
        backend.search(bytes(80), 8)
    assert isinstance(ei.value.last, RankLossSuspected)
    assert ei.value.site == "mesh.rebuild"


def test_mesh_backend_rejects_single_miner_and_cpu_configs():
    for cfg in (_mesh_cfg(n_miners=1), MinerConfig(backend="cpu",
                                                   n_miners=4)):
        with pytest.raises(ConfigError):
            ElasticMeshBackend(cfg)


# ---- the CLI -------------------------------------------------------------


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else {})


def test_cli_elastic_mine_summary_and_events_dump(tmp_path, capsys):
    argv = ["mine", "--difficulty", "8", "--blocks", "2", "--backend",
            "cpu", "--elastic", "--batch-pow2", "12", "--process-id", "1",
            "--num-processes", "3", "--events-dump"]
    rc, out = _run_cli(cli.main, argv + [str(tmp_path / "p.json")])
    assert "dead peers will not be detected" in capsys.readouterr().err
    ref_rc, ref_out = _run_cli(ref_cli.main, argv + [str(tmp_path / "r.json")])
    assert rc == ref_rc == 0 and out["height"] == 2
    for key in ("mesh", "tip_hash", "hashes_tried", "height"):
        assert out[key] == ref_out[key], key
    assert out["mesh"] == {"world_size": 3, "rank": 1, "live": [0, 1, 2],
                           "evicted": [], "shrunk": False}
    dump = (tmp_path / "p.json").read_bytes()
    assert dump == (tmp_path / "r.json").read_bytes()
    assert [r["kind"] for r in json.loads(dump)["nodes"]["1"]] == \
        ["mine", "mine"]


def test_cli_elastic_refuses_coordinator_and_fused():
    rc, out = _run_cli(cli.main, ["mine", "--elastic", "--coordinator",
                                  "127.0.0.1:1", "--difficulty", "8"])
    assert rc == 2 and "torch.distributed" in out["error"]
    rc, out = _run_cli(cli.main, ["mine", "--elastic", "--fused",
                                  "--difficulty", "8"])
    assert rc == 2 and "fused" in out["error"]
    for argv in (["--coordinator", "127.0.0.1:1"], ["--fused"]):
        assert _run_cli(ref_cli.main, ["mine", "--elastic", *argv,
                                       "--difficulty", "8"])[0] == 2


def test_cli_elastic_resume_restores_shrunken_world(tmp_path):
    """--resume restores the shrunken world from the sidecar: the resumed
    rank keeps its re-striped share; the reference's CLI reads the port's
    checkpoint the same way."""
    cfg = MinerConfig(difficulty_bits=8, n_blocks=2, backend="cpu")
    w = ElasticWorld(3, 0)
    w.evict(2, "dead-shard", height=2)
    outs = []
    for main in (cli.main, ref_cli.main):
        ck = tmp_path / f"ck_{len(outs)}.bin"
        checkpoint.save_chain(_mined(2).node, ck, cfg, mesh=w.membership())
        rc, out = _run_cli(main, [
            "mine", "--difficulty", "8", "--blocks", "4", "--backend",
            "cpu", "--elastic", "--process-id", "0", "--num-processes",
            "3", "--resume", str(ck), "--checkpoint", str(ck)])
        assert rc == 0 and out["height"] == 4
        assert out["mesh"]["live"] == [0, 1]
        assert [e["rank"] for e in out["mesh"]["evicted"]] == [2]
        # The final save keeps the membership for the next resume.
        assert checkpoint.recover_chain(ck, 8)[1]["mesh"]["live"] == [0, 1]
        outs.append(out)
    assert outs[0]["tip_hash"] == outs[1]["tip_hash"]
    assert outs[0]["mesh"] == outs[1]["mesh"]


def test_cli_in_process_elastic_tip_invariant_under_shrink(tmp_path):
    """``mine --elastic --miners 4``: an injected collective fault shrinks
    the logical miners mid-run, and the tip is still the C++ oracle's in
    both packages (the launch path the reference's v5e8 case drives)."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "parallel.collective", "kind": "raise", "call": 3,
         "times": 1}]}))
    rc, out = _run_cli(cli.main, [
        "mine", "--elastic", "--miners", "4", "--device", "cpu",
        "--difficulty", "10", "--blocks", "4", "--batch-pow2", "10",
        "--fault-plan", str(plan)])
    assert rc == 0, out
    device_mesh = out["mesh"]["device_mesh"]
    assert device_mesh["shrunk"] and device_mesh["n_live"] == 3
    assert device_mesh["n_miners"] == 4 and out["backend"] == "cuda"
    rc, oracle = _run_cli(cli.main, ["mine", "--difficulty", "10",
                                     "--blocks", "4", "--backend", "cpu"])
    ref_rc, ref_oracle = _run_cli(ref_cli.main, [
        "mine", "--difficulty", "10", "--blocks", "4", "--backend", "cpu"])
    assert rc == ref_rc == 0
    assert out["tip_hash"] == oracle["tip_hash"] == ref_oracle["tip_hash"]


# ---- a three-rank world through both CLIs --------------------------------


def _world(tmp_path, pkg: str) -> dict:
    """Three ``mine --elastic`` rank processes of ``pkg`` on the C++ sweep
    (the reference's under JAX_PLATFORMS=cpu) with the seeded
    mesh.rank_death plan; returns each rank's rc and dump bytes."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"version": 1, "seed": 9, "faults": [
        {"site": "mesh.rank_death", "kind": "partial", "call": 2}]}))
    module = ("mpi_blockchain_tpu_torch" if pkg == "port"
              else "mpi_blockchain_tpu")
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT),
           "JAX_PLATFORMS": "cpu"}
    env.pop("MPIBT_MESH_OBS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "mine", "--backend", "cpu",
         "--elastic", "--process-id", str(r), "--num-processes", "3",
         "--difficulty", "10", "--blocks", "6", "--batch-pow2", "10",
         "--fault-plan", str(plan), "--events-dump",
         str(tmp_path / f"{pkg}_{r}.json")],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(3)]
    try:
        got = [p.communicate(timeout=240) for p in procs]
    finally:
        reap(procs)
    rcs = [p.returncode for p in procs]
    dumps = {r: (tmp_path / f"{pkg}_{r}.json").read_bytes()
             for r in range(3) if (tmp_path / f"{pkg}_{r}.json").exists()}
    summaries = {r: json.loads(out.strip().splitlines()[-1])
                 for r, (out, _) in enumerate(got) if rcs[r] == 0}
    return {"rcs": rcs, "dumps": dumps, "summaries": summaries,
            "stderr": [err[-600:] for _, err in got]}


def test_rank_death_world_dumps_equal_the_references(tmp_path):
    port, ref = _world(tmp_path, "port"), _world(tmp_path, "ref")
    assert port["rcs"] == ref["rcs"], (port["stderr"], ref["stderr"])
    assert sorted(port["rcs"]) == [0, 0, 137]
    victim = port["rcs"].index(137)
    assert victim != 0 and victim not in port["dumps"]
    assert port["dumps"] == ref["dumps"] and len(port["dumps"]) == 2
    for r, summary in port["summaries"].items():
        assert summary["mesh"] == ref["summaries"][r]["mesh"]
        assert summary["mesh"]["evicted"] == [
            {"rank": victim, "reason": "rank_death", "height": 3}]
        assert summary["tip_hash"] == ref["summaries"][r]["tip_hash"]
        kinds = [e["kind"] for e in
                 json.loads(port["dumps"][r])["nodes"][str(r)]]
        assert kinds == ["mine", "mine", "mesh_shrunk", "mine", "mine",
                         "mine", "mine"]
