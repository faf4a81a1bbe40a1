"""The port's mesh observability against the reference's, on the CPU.

The aggregator's pure functions (``merge_shards``, ``rank_status``,
``mesh_health`` with ``now`` and ``shards`` fixed, ``mesh_incidents``,
``mesh_compiles``, ``mesh_service``, ``recommended_action``,
``render_mesh_prometheus``) give the reference's output, as JSON, exactly,
on shard sets made from numpy seeds: 1 to 8 ranks, counters with several
label sets, gauges, histograms, heartbeat ages across both budgets, final
shards with rc 0, rc 2 and "error", missing ranks, incidents, compiles and
service stats. A shard the port's ``ShardWriter`` writes has the
reference's keys and version, and a directory of port shards reads the
same through either package. Through the port's CLI: ``mine --mesh-obs``
(the final shard's ``hashes_tried_total`` is the summary's and the
reference's run's), an rc-2 rank reads ``failed``, ``MPIBT_MESH_OBS`` arms
only the subcommands with the flag, ``sim`` carries the reference's causal
tails, ``serve`` carries the door's stats; the ``MeshServer`` endpoints
answer as the reference's on one directory; ``registered_networks`` and
``rebind_installed`` (from ``init_distributed`` too) follow the reference.
"""
import contextlib
import io
import json
import os
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mpi_blockchain_tpu.chainwatch as ref_chainwatch
import mpi_blockchain_tpu.dispatchwatch as ref_dispatchwatch
import mpi_blockchain_tpu.meshwatch.aggregate as ref_aggregate
import mpi_blockchain_tpu.meshwatch.shard as ref_shard
from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.cli import main as ref_main
from mpi_blockchain_tpu.meshwatch import pipeline as ref_pipeline
from mpi_blockchain_tpu.meshwatch.server import MeshServer as RefMeshServer
from mpi_blockchain_tpu.telemetry import flight_recorder as ref_flight
from mpi_blockchain_tpu_torch import chainwatch, dispatchwatch, telemetry
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.meshwatch import aggregate, pipeline, shard
from mpi_blockchain_tpu_torch.meshwatch.server import MeshServer
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.parallel import distributed
from mpi_blockchain_tpu_torch.telemetry import flight_recorder

torch.set_num_threads(1)

NOW = 1_800_000_000.0
PORT = dict(telemetry=telemetry, pipeline=pipeline, aggregate=aggregate,
            shard=shard, chainwatch=chainwatch, flight=flight_recorder,
            dispatchwatch=dispatchwatch)
REF = dict(telemetry=ref_telemetry, pipeline=ref_pipeline,
           aggregate=ref_aggregate, shard=ref_shard,
           chainwatch=ref_chainwatch, flight=ref_flight,
           dispatchwatch=ref_dispatchwatch)


def _reset():
    for pkg in (PORT, REF):
        pkg["shard"].uninstall()
        pkg["chainwatch"].uninstall()
        pkg["flight"].uninstall()
        pkg["telemetry"].reset()
        pkg["telemetry"].clear_events()
        pkg["telemetry"].set_mesh_rank(0)
        pkg["pipeline"].reset_profiler()
        pkg["aggregate"]._stale_announced.clear()
        # A shard carries the process's compile census, which an earlier
        # test in the same process may have filled.
        pkg["dispatchwatch"].clear_compiles()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _json(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


# ---- seeded shard sets ------------------------------------------------------


def _pick(rng, options):
    return options[int(rng.integers(0, len(options)))]


def _registry(rng, rank: int) -> dict:
    reg = {"hashes_tried_total": [
        {"kind": "counter", "labels": {"backend": b},
         "value": int(rng.integers(0, 1 << 30))}
        for b in ("cpu", "cuda") if rng.uniform() < 0.7]}
    reg["blocks_mined_total"] = [{"kind": "counter", "labels": {},
                                  "value": int(rng.integers(0, 1000))}]
    reg["chain_height"] = [{
        "kind": "gauge", "labels": {},
        "value": _pick(rng, [3, 7.5, 1e6, 2.0]),
        "age_s": _pick(rng, [None, 0.25, 4.0])}]
    # A gauge that already carries its own rank label.
    reg["mesh_rank_local_devices"] = [{
        "kind": "gauge", "labels": {"rank": str(rank)}, "value": 1,
        "age_s": 0.5}]
    reg["block_latency_ms"] = [{
        "kind": "histogram", "labels": {"backend": "cpu"},
        "count": int(rng.integers(0, 50)),
        "sum": float(rng.uniform(0, 1e4)),
        "p50": _pick(rng, [None, 1.5, 12.0]),
        "p95": float(rng.uniform(0, 100)),
        "p99": _pick(rng, [None, 99.125])}]
    return reg


def shard_set(seed: int) -> list[dict]:
    """1 to 8 ranks (some missing), every carriage key the shard has."""
    rng = np.random.default_rng(seed)
    world = int(rng.integers(1, 9))
    present = sorted(int(r) for r in rng.choice(
        world, size=int(rng.integers(1, world + 1)), replace=False))
    shards = []
    for rank in present:
        final = bool(rng.uniform() < 0.5)
        shard_age = _pick(rng, [0.05, 3.0, 15.0, 300.0])
        beats = {name: {"value": int(rng.integers(0, 100)),
                        "age_s": _pick(rng, [None, 0.2, 12.0, 45.0])}
                 for name in ("miner_heartbeat", "bench_heartbeat")
                 if rng.uniform() < 0.6}
        incidents = [{"rule": _pick(rng, ["event_storm", "stale_rank"]),
                      "severity": "warn", "incident_seq": int(k),
                      "opened_at": NOW - float(k),
                      "heights": [int(k) + 1]}
                     for k in range(int(rng.integers(0, 3)))][::-1]
        compiles = ({} if rng.uniform() < 0.3 else {"sites": {
            "ops.sha256_cuda": {"compiles": int(rng.integers(0, 3))},
            "fused": {"compiles": int(rng.integers(0, 2))}}})
        service = ({} if rng.uniform() < 0.5 else {
            "mempool": {"depth": int(rng.integers(0, 512))},
            "shed_total": {"full": int(rng.integers(0, 9)),
                           "deadline": int(rng.integers(0, 4))},
            "accept_gate": {"open": bool(rng.uniform() < 0.5)}})
        shards.append({
            "version": 1, "rank": rank,
            "world_size": _pick(rng, [world, 1, world]),
            "pid": 1000 + rank, "seq": int(rng.integers(1, 50)),
            "final": final,
            "exit_status": _pick(rng, [0, 2, "error", None]) if final
            else None,
            "written_at": NOW - shard_age,
            "started_at": _pick(rng, [None, NOW - shard_age - 40.0,
                                      NOW - shard_age - 1.0]),
            "heartbeats": beats,
            "registry": _registry(rng, rank),
            "events_tail": [], "causal_tail": {}, "pipeline": [],
            "skew_spans": [{"site": "mesh.sweep", "round": r,
                            "t_enter": NOW + r + float(rng.uniform(0, .01)),
                            "t_exit": NOW + r + 0.02, "ok": True}
                           for r in range(int(rng.integers(0, 4)))],
            "memory": ({} if rng.uniform() < 0.5 else
                       {"cuda:0": {"bytes_in_use": 1024,
                                   "peak_bytes_in_use": 4096}}),
            "incidents": incidents, "compiles": compiles,
            "service": service})
    return shards


SEEDS = range(24)


@pytest.mark.parametrize("seed", SEEDS)
def test_aggregator_equals_the_references(seed):
    shards = shard_set(seed)
    for pkg in (aggregate, ref_aggregate):
        pkg._stale_announced.clear()
    view = aggregate.merge_shards(shards)
    assert _json(view) == _json(ref_aggregate.merge_shards(shards))
    for kw in ({}, {"stall_s": 1.0, "heartbeat_stall_s": 5.0}):
        assert _json(aggregate.rank_status(shards, now=NOW, **kw)) == \
            _json(ref_aggregate.rank_status(shards, now=NOW, **kw))
    got = aggregate.mesh_health("mesh", now=NOW, shards=shards)
    want = ref_aggregate.mesh_health("mesh", now=NOW, shards=shards)
    assert _json(got) == _json(want)
    for fn in ("mesh_incidents", "mesh_compiles", "mesh_service"):
        assert _json(getattr(aggregate, fn)(shards)) == \
            _json(getattr(ref_aggregate, fn)(shards))
    for health in (None, got[1]):
        assert aggregate.render_mesh_prometheus(view, health) == \
            ref_aggregate.render_mesh_prometheus(view, health)
    # The transition events the two emitted on the same set.
    assert [e for e in telemetry.recent_events()
            if e["event"].startswith("mesh_rank_")] == \
        [e for e in ref_telemetry.recent_events()
         if e["event"].startswith("mesh_rank_")]


def test_the_seeded_sets_cover_every_rank_status():
    statuses = set()
    for seed in SEEDS:
        ranks = aggregate.rank_status(shard_set(seed), now=NOW)["ranks"]
        statuses |= {(v["status"], v["stale_reason"])
                     for v in ranks.values()}
    assert statuses >= {("ok", None), ("finished", None), ("failed", None),
                        ("missing", None), ("stale", "dead-shard"),
                        ("stale", "no-progress")}


@pytest.mark.parametrize("status", ["ok", "finished", "failed", "missing",
                                    "stale", "unknown"])
@pytest.mark.parametrize("reason", [None, "no-progress", "dead-shard"])
def test_recommended_action_is_the_references(status, reason):
    assert aggregate.recommended_action(status, reason) == \
        ref_aggregate.recommended_action(status, reason)


def test_empty_directory_reads_as_the_reference(tmp_path):
    assert aggregate.mesh_health(tmp_path) == \
        ref_aggregate.mesh_health(tmp_path)


def test_read_shards_skips_malformed_as_the_reference(tmp_path):
    for s in shard_set(3):
        (tmp_path / f"rank_{s['rank']:04d}.json").write_text(_json(s))
    (tmp_path / "rank_0100.json").write_text("{torn")
    (tmp_path / "rank_0101.json").write_text("[1, 2]")
    (tmp_path / "rank_0102.json").write_text('{"rank": "x"}')
    (tmp_path / "rank_0103.json").write_text('{"world_size": 2}')
    got = aggregate.read_shards(tmp_path)
    assert got == ref_aggregate.read_shards(tmp_path)
    assert [s["rank"] for s in got] == [s["rank"] for s in shard_set(3)]


# ---- the shard writer -------------------------------------------------------


def test_a_port_shard_has_the_references_keys_and_version(tmp_path):
    for name in ("SHARD_VERSION", "SHARD_PREFIX", "SHARD_GLOB",
                 "DEFAULT_INTERVAL_S", "EVENTS_TAIL_N", "CAUSAL_TAIL_N",
                 "PIPELINE_TAIL_N"):
        assert getattr(shard, name) == getattr(ref_shard, name), name
    got = json.loads(shard.ShardWriter(tmp_path / "p", rank=3,
                                       world_size=4).write().read_text())
    want = json.loads(ref_shard.ShardWriter(tmp_path / "r", rank=3,
                                            world_size=4).write().read_text())
    assert set(got) == set(want)
    assert (got["version"], got["rank"], got["world_size"], got["final"]) \
        == (want["version"], 3, 4, False)
    assert got["memory"] == {} and got["compiles"] == {}


def test_flusher_close_and_abort_follow_the_reference(tmp_path):
    w = shard.ShardWriter(tmp_path, rank=1, interval_s=0.01)
    w.start()
    first = json.loads(w.path.read_text())["seq"]
    deadline = time.monotonic() + 10
    while json.loads(w.path.read_text())["seq"] == first:
        assert time.monotonic() < deadline, "the flusher never rewrote it"
        time.sleep(0.01)
    w.close(status=2)
    final = json.loads(w.path.read_text())
    assert final["final"] is True and final["exit_status"] == 2
    aborted = shard.ShardWriter(tmp_path / "a", rank=0, interval_s=0.01)
    aborted.start()
    aborted.abort()
    assert json.loads(aborted.path.read_text())["final"] is False


def test_each_flush_is_a_forced_watchdog_sweep_carrying_its_incidents(
        tmp_path, monkeypatch):
    """The shard flush tick is chainwatch's second cadence, as in the
    reference: a forced sweep, whose open incidents the shard carries."""
    calls = []
    real = chainwatch.evaluate

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(chainwatch, "evaluate", spy)
    chainwatch.install(None)
    chainwatch.emit_incident(rule="event_storm", severity="warn",
                             detail={"events": 4}, heights=(3,))
    got = json.loads(shard.ShardWriter(tmp_path).write().read_text())
    assert calls == [{"source": "flush", "force": True}]
    assert got["incidents"] == chainwatch.open_incidents()
    assert [i["rule"] for i in got["incidents"]] == ["event_storm"]


def test_install_failure_leaves_nothing_armed(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        shard.install(blocker / "mesh")
    assert shard.installed() is None
    shard.rebind_installed(3)        # a no-op with nothing armed
    shard.uninstall()


def test_rebind_installed_moves_the_shard(tmp_path):
    shard.install(tmp_path, rank=0, world_size=1, interval_s=60)
    shard.rebind_installed(3, 4)
    moved = json.loads(shard.shard_path(tmp_path, 3).read_text())
    assert (moved["rank"], moved["world_size"]) == (3, 4)
    assert telemetry.mesh_rank() == 3
    shard.uninstall(status=0)
    assert json.loads(shard.shard_path(tmp_path, 3).read_text())["final"]


def test_init_distributed_rebinds_the_installed_shard(tmp_path, monkeypatch):
    """The CLI arms the writer before the world exists; joining the world
    moves it to the rank the world was joined as."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    shard.install(tmp_path, rank=5, world_size=1, interval_s=60)
    monkeypatch.setattr(distributed, "_joined", False)
    try:
        distributed.init_distributed(f"127.0.0.1:{port}", 1, 0)
    finally:
        distributed.shutdown_distributed()
    assert not dist.is_initialized()
    got = json.loads(shard.shard_path(tmp_path, 0).read_text())
    assert (got["rank"], got["world_size"]) == (0, 1)


def test_registered_networks_follow_the_reference():
    class Net:
        def causal_logs(self):
            return []

    nets = [Net(), Net()]
    for fr in (flight_recorder, ref_flight):
        fr.install("unused.json")
        for net in nets + nets[:1]:
            fr.register_network(net)
        got = fr.registered_networks()
        assert got == nets
        got.clear()                  # a copy: the recorder keeps its own
        assert fr.registered_networks() == nets
        fr.uninstall()
        assert fr.registered_networks() == []


def test_causal_tails_come_from_the_registered_networks(tmp_path):
    class Log:
        def __init__(self, node_id, n):
            self.node_id, self.n = node_id, n

        def events(self):
            return [{"i": i} for i in range(self.n)]

    class Net:
        def causal_logs(self):
            return [Log(0, 70), Log("bus", 3)]

    class HalfBuilt:
        def causal_logs(self):
            raise RuntimeError("not built yet")

    for fr, sh in ((flight_recorder, shard), (ref_flight, ref_shard)):
        fr.install(str(tmp_path / "fr.json"))
        fr.register_network(HalfBuilt())
        fr.register_network(Net())
    got = shard.ShardWriter(tmp_path)._causal_tails()
    assert got == ref_shard.ShardWriter(tmp_path)._causal_tails()
    assert len(got["0"]) == shard.CAUSAL_TAIL_N and got["0"][-1] == {"i": 69}


# ---- the CLI ----------------------------------------------------------------


def _run(fn, argv) -> tuple[int, dict | None]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _final(directory, rank: int = 0) -> dict:
    return json.loads(shard.shard_path(directory, rank).read_text())


def _hashes(shard_payload) -> int:
    return sum(s["value"] for s in
               shard_payload["registry"]["hashes_tried_total"])


def test_mine_final_shard_matches_the_summary_and_the_reference(tmp_path):
    argv = ["mine", "--backend", "cpu", "--difficulty", "10", "--blocks",
            "4"]
    rc, summary = _run(main, argv + ["--mesh-obs", str(tmp_path / "p")])
    assert rc == 0
    ref_rc, ref_summary = _run(ref_main,
                               argv + ["--mesh-obs", str(tmp_path / "r")])
    assert ref_rc == 0 and ref_summary["tip_hash"] == summary["tip_hash"]
    got, want = _final(tmp_path / "p"), _final(tmp_path / "r")
    assert got["final"] is True and got["exit_status"] == 0
    assert _hashes(got) == summary["hashes_tried"] == _hashes(want)
    assert set(got) == set(want)
    assert set(got["heartbeats"]) == set(want["heartbeats"])
    assert len(got["pipeline"]) == len(want["pipeline"]) == 4
    # Armed by the shard alone: the rules ran, no incident, no bundle.
    assert got["incidents"] == [] and not chainwatch.installed()
    status = aggregate.rank_status([got])["ranks"]["0"]
    assert status["status"] == "finished"


def test_a_port_shard_directory_reads_the_same_through_both(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("MPIBT_MESH_WORLD", "2")
    for rank in (0, 1):
        monkeypatch.setenv("MPIBT_MESH_RANK", str(rank))
        assert _run(main, ["mine", "--backend", "cpu", "--difficulty", "9",
                           "--blocks", "3", "--mesh-obs",
                           str(tmp_path)])[0] == 0
    got = aggregate.read_shards(tmp_path)
    assert [s["rank"] for s in got] == [0, 1]
    assert got == ref_aggregate.read_shards(tmp_path)
    assert _json(aggregate.merge_shards(got)) == \
        _json(ref_aggregate.merge_shards(got))
    now = max(s["written_at"] for s in got) + 1.0
    assert _json(aggregate.mesh_health(tmp_path, now=now)) == \
        _json(ref_aggregate.mesh_health(tmp_path, now=now))
    assert aggregate.mesh_health(tmp_path, now=now)[0] == 200


def test_a_config_error_reads_failed(tmp_path):
    rc, _ = _run(main, ["mine", "--backend", "cpu", "--difficulty", "8",
                        "--blocks", "2", "--mesh-obs", str(tmp_path),
                        "--checkpoint-every", "5"])   # no --checkpoint
    assert rc == 2
    got = aggregate.read_shards(tmp_path)
    assert got[0]["final"] is True and got[0]["exit_status"] == 2
    code, health = aggregate.mesh_health(tmp_path, stall_s=1e9, shards=got)
    assert code == 503 and health["failed_ranks"] == [0]
    assert health["ranks"]["0"]["recommended_action"] == "evict"


def test_an_uncaught_exception_reads_failed_with_error(tmp_path,
                                                       monkeypatch):
    def boom(self, *args, **kwargs):
        raise ValueError("a bug")

    monkeypatch.setattr(Miner, "mine_chain", boom)
    with pytest.raises(ValueError):
        main(["mine", "--backend", "cpu", "--difficulty", "8", "--blocks",
              "2", "--mesh-obs", str(tmp_path)])
    assert _final(tmp_path)["exit_status"] == "error"


def test_the_env_arms_only_the_subcommands_with_the_flag(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("MPIBT_MESH_OBS", str(tmp_path / "mesh"))
    monkeypatch.setenv("MPIBT_MESH_RANK", "2")
    monkeypatch.setenv("MPIBT_MESH_WORLD", "3")
    assert _run(main, ["info"])[0] == 0
    assert not (tmp_path / "mesh").exists()
    rc, summary = _run(main, ["mine", "--backend", "cpu", "--difficulty",
                              "8", "--blocks", "2"])
    assert rc == 0
    got = _final(tmp_path / "mesh", rank=2)
    assert (got["rank"], got["world_size"], got["final"]) == (2, 3, True)
    health = aggregate.mesh_health(tmp_path / "mesh", stall_s=1e9)[1]
    assert health["missing_ranks"] == [0, 1]


def test_an_unwritable_directory_prints_and_carries_on(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    rc = main(["mine", "--backend", "cpu", "--difficulty", "8", "--blocks",
               "2", "--mesh-obs", str(blocker / "mesh")])
    assert rc == 0
    assert "mesh-obs failed" in capsys.readouterr().err


def test_sim_carries_the_references_causal_tails(tmp_path):
    argv = ["sim", "--backend", "cpu", "--blocks", "4", "--partition-steps",
            "10", "--drop-rate", "10", "--seed", "3"]
    rc, summary = _run(main, argv + [
        "--mesh-obs", str(tmp_path / "p"),
        "--flight-recorder", str(tmp_path / "p.json")])
    ref_rc, ref_summary = _run(ref_main, argv + [
        "--mesh-obs", str(tmp_path / "r"),
        "--flight-recorder", str(tmp_path / "r.json")])
    assert rc == ref_rc == 0 and summary["tips"] == ref_summary["tips"]
    got, want = _final(tmp_path / "p"), _final(tmp_path / "r")
    assert got["causal_tail"] and got["causal_tail"] == want["causal_tail"]


def test_serve_shards_carry_the_doors_stats(tmp_path, monkeypatch):
    seen = []
    real = Miner._block_mined

    def probe(self, rec):
        real(self, rec)
        if rec.height == 2:
            seen.append(json.loads(shard.installed().write().read_text()))

    monkeypatch.setattr(Miner, "_block_mined", probe)
    rc, summary = _run(main, ["serve", "--backend", "cpu", "--difficulty",
                              "10", "--blocks", "3", "--mesh-obs",
                              str(tmp_path)])
    assert rc == 0 and len(seen) == 1
    service = seen[0]["service"]
    assert service["accept_gate"] == {"open": True}
    assert set(service) == set(summary["service"])
    health = aggregate.mesh_health(tmp_path, shards=seen)[1]
    assert health["service"]["by_rank"]["0"] == service
    # The door closed before the final shard.
    assert _final(tmp_path)["service"] == {}


# ---- the mesh server ----------------------------------------------------------


def _get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _without_ages(obj):
    if isinstance(obj, dict):
        return {k: _without_ages(v) for k, v in obj.items()
                if k not in ("shard_age_s", "heartbeat_age_s")}
    return obj


@pytest.mark.parametrize("seed", [0, 5])
def test_mesh_server_answers_as_the_references(tmp_path, seed):
    now = time.time()
    for s in shard_set(seed):
        s["written_at"] += now - NOW
        (tmp_path / f"rank_{s['rank']:04d}.json").write_text(_json(s))
    servers = [MeshServer(tmp_path, port=0, stall_s=1e9),
               RefMeshServer(tmp_path, port=0, stall_s=1e9)]
    try:
        for srv in servers:
            srv.start()
        for path in ("/healthz", "/ranks", "/incidents", "/metrics",
                     "/nope"):
            (code, body), (ref_code, ref_body) = (
                _get(srv.url(path)) for srv in servers)
            assert code == ref_code, path
            if path == "/metrics":
                assert body == ref_body
                assert 'rank="' in body
            else:
                assert _without_ages(json.loads(body)) == \
                    _without_ages(json.loads(ref_body)), path
    finally:
        for srv in servers:
            srv.close()
    assert os.path.isdir(tmp_path)
