"""The port's winner-select for more than one miner against the reference's
mesh, on the CPU.

``parallel/mesh.py`` against the reference's striping rule and its
per-device slice offsets on the 8-device virtual mesh; ``mine --miners
N`` and ``FusedMiner`` with N logical miners against the reference's
N-device mesh (jnp kernel): the same tip and the same ``hashes_tried`` for
each block, exactly; a world of two processes over gloo, spawned through
the CLI, against the reference's 2-device mesh; a speculative dispatch
discarded on both ranks; and the round of exactly 2^32 nonces.
"""
import itertools
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi_blockchain_tpu.backend.tpu import TpuBackend as RefTpuBackend
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.fused import FusedMiner as RefFusedMiner
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu.parallel import mesh as ref_mesh
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.backend import cuda as cuda_mod
from mpi_blockchain_tpu_torch.backend.cuda import CudaBackend, \
    device_rounds, reference_hashes_tried
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.parallel import (NONCE_SPACE,
                                               sharded_local_base,
                                               stripe_windows,
                                               winner_select)
from mpi_blockchain_tpu_torch.parallel.distributed import world_info

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
M32 = 0xFFFFFFFF


def _quiet(d):
    return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))


def _last_json(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.strip().startswith("{")]
    return json.loads(lines[-1]) if lines else {}


# ---- the striping rule and the slice offsets ---------------------------------

@pytest.mark.parametrize("world", range(1, 9))
def test_stripe_windows_match_the_reference(world):
    for batch, space in ((4, 96), (3, 100), (7, 1 << 10)):
        union = []
        for index in range(world):
            got = list(stripe_windows(index, world, batch, space=space))
            assert got == list(ref_mesh.stripe_windows(index, world, batch,
                                                       space=space))
            union += [n for lo, hi in got for n in range(lo, hi)]
        assert sorted(union) == list(range(space))
    # The default space, lazily: the first windows of the last rank.
    assert list(itertools.islice(stripe_windows(world - 1, world, 1 << 20),
                                 3)) == \
        list(itertools.islice(ref_mesh.stripe_windows(world - 1, world,
                                                      1 << 20), 3))


def test_stripe_windows_errors_match_the_reference():
    for args in ((2, 2, 4), (-1, 2, 4), (0, 2, 0)):
        with pytest.raises(ConfigError):
            list(stripe_windows(*args))
        with pytest.raises(Exception):
            list(ref_mesh.stripe_windows(*args))


@pytest.mark.parametrize("base", [0, 12345, (1 << 32) - (8 << 12),
                                  0xFFFFFFF0])
def test_sharded_local_base_matches_the_reference(base):
    """Each device's slice offset on the reference's 8-device mesh
    (``jax.lax.axis_index`` inside ``shard_map``) against the port's for
    the same index, uint32 wrap included."""
    batch = 1 << 12
    mesh = jax.make_mesh((8,), ("miners",))
    per_device = ref_mesh.shard_map(
        lambda b: ref_mesh.sharded_local_base(b, batch)[None], mesh=mesh,
        in_specs=P(), out_specs=P("miners"))
    ref = np.asarray(jax.jit(per_device)(np.uint32(base))).tolist()
    assert [sharded_local_base(base, batch, i) for i in range(8)] == ref


def test_winner_select_in_one_process_returns_its_inputs():
    assert winner_select(0, M32) == (0, M32)
    assert winner_select(3, 1234) == (3, 1234)
    assert world_info() == {"process_index": 0, "process_count": 1,
                            "local_devices": 1, "global_devices": 1}


def test_winner_select_in_a_world_of_one_keeps_the_none_nonce():
    """Over a real gloo group: int64 on the wire, so 0xFFFFFFFF (no
    qualifier) stays the largest nonce."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        assert winner_select(0, M32) == (0, M32)
        assert winner_select(2, 77, dist.group.WORLD) == (2, 77)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ---- N logical miners in one process -------------------------------------------

@pytest.mark.parametrize("batch_pow2", [12, 8])
def test_mine_miners_8_matches_the_reference_mesh(batch_pow2, tmp_path,
                                                  capsys):
    """d12/n5 with 8 logical miners against the reference's 8-device mesh:
    the same tip and the same ``hashes_tried`` for every block (at b8 the
    winners lie past the first round of 2^11)."""
    ref = RefMiner(RefConfig(difficulty_bits=12, n_blocks=5, backend="tpu",
                             kernel="jnp", n_miners=8,
                             batch_pow2=batch_pow2), log_fn=_quiet)
    ref.mine_chain()
    port = Miner(MinerConfig(difficulty_bits=12, n_blocks=5, device="cpu",
                             n_miners=8, batch_pow2=batch_pow2))
    port.mine_chain()
    assert port.node.tip_hash == ref.node.tip_hash
    # The lowest-nonce rule does not depend on N or B: one miner's chain.
    single = Miner(MinerConfig(difficulty_bits=12, n_blocks=5,
                               backend="cpu"))
    single.mine_chain()
    assert port.node.tip_hash == single.node.tip_hash
    assert [r.hashes_tried for r in port.records] == \
        [r.hashes_tried for r in ref.records]
    assert [r.nonce for r in port.records] == [r.nonce for r in ref.records]
    out = tmp_path / "m8.bin"
    assert main(["mine", "--device", "cpu", "--difficulty", "12",
                 "--blocks", "5", "--miners", "8", "--batch-pow2",
                 str(batch_pow2), "--out", str(out)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["tip_hash"] == ref.node.tip_hash.hex()
    assert summary["hashes_tried"] == ref.total_hashes()
    assert summary["config"]["n_miners"] == 8
    assert out.read_bytes() == ref.node.save()


def test_fused_miners_8_matches_the_reference_fused_mesh():
    cfg = dict(difficulty_bits=12, n_blocks=5, n_miners=8, batch_pow2=12)
    ref = RefFusedMiner(RefConfig(backend="tpu", kernel="jnp", **cfg),
                        blocks_per_call=2, log_fn=_quiet)
    ref.mine_chain()
    port = FusedMiner(MinerConfig(device="cpu", **cfg), blocks_per_call=2)
    port.mine_chain()
    assert port.node.save() == ref.node.save()


def test_fused_sweep_cap_follows_the_round_of_n_miners():
    from mpi_blockchain_tpu_torch.models import fused

    assert fused.sweep_cap(20, n_miners=8) == NONCE_SPACE
    # 3 x 2^20 does not divide 2^32: the last whole round ends below it,
    # as the reference's n_rounds_cap = 2^32 // round_size.
    assert fused.sweep_cap(20, n_miners=3) == \
        (NONCE_SPACE // (3 << 20)) * (3 << 20)
    assert fused.sweep_cap(12, 2, n_miners=3) == 2 * (3 << 12)


# ---- the round of exactly 2^32 nonces --------------------------------------------

def _ref_tpu_backend_8x29(monkeypatch, winner):
    """The reference's TpuBackend with 8 miners x 2^29 (a round of 2^32)
    whose device program is replaced by the answer a sweep of the one
    round gives: the accounting is the reference's own."""
    be = RefTpuBackend(batch_pow2=29, n_miners=8, kernel="jnp")

    def program(ext, base, n_rounds):
        found = winner is not None
        return (np.uint32(1), np.int32(int(found)),
                np.uint32(winner if found else M32))
    monkeypatch.setattr(be, "_searcher", lambda d: program)
    return be


@pytest.mark.parametrize("winner", [0, 5, (1 << 31) + 7, M32, None])
def test_round_of_2_32_counts_as_the_reference(monkeypatch, winner):
    hdr = bytes(range(80))
    ref = _ref_tpu_backend_8x29(monkeypatch, winner).search(hdr, 24)
    assert device_rounds(0, NONCE_SPACE, 1 << 32) == 1
    assert reference_hashes_tried(0, NONCE_SPACE, 1 << 32, winner) == \
        ref.hashes_tried == NONCE_SPACE
    # The world-of-processes round loop at the same edge, as rank 0 of 8:
    # its slices and the group's answer are stubbed, the loop and its
    # accounting are the port's.
    be = CudaBackend(batch_pow2=29, device="cpu")
    be.n_miners, be.group, be.rank = 8, object(), 0
    asked = []

    def start(ext, base, count, d):
        asked.append((base, count))
        return lambda: (0, M32)
    monkeypatch.setattr(be, "_start", start)
    monkeypatch.setattr(cuda_mod, "winner_select", lambda c, m, g: (
        (1, winner) if winner is not None else (0, M32)))
    res = be.search(hdr, 24)
    assert asked == [(0, 1 << 29)] + ([] if winner is not None
                                      else [(NONCE_SPACE, 0)])
    assert (res.nonce, res.hashes_tried) == (winner, ref.hashes_tried)


def test_round_of_2_32_from_a_later_start_is_all_tail():
    """From start 1 no round of 2^32 fits below 2^32: the reference runs
    the whole range as its C++ tail, the port as one launch; both count
    up to the winner."""
    hdr = bytes(range(80))
    ref = RefTpuBackend(batch_pow2=29, n_miners=8, kernel="jnp").search(
        hdr, 6, start_nonce=1)
    port = CudaBackend(batch_pow2=29, n_miners=8, device="cpu").search(
        hdr, 6, start_nonce=1)
    assert device_rounds(1, NONCE_SPACE, 1 << 32) == 0
    assert (port.nonce, port.hash, port.hashes_tried) == \
        (ref.nonce, ref.hash, ref.hashes_tried)


# ---- a world of processes over gloo -------------------------------------------

def _spawn_world(argv: list[str], n: int, timeout: float = 180.0):
    """Runs ``mine`` as ranks 0..n-1 of one gloo world; returns each
    rank's (rc, stdout, stderr)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine", *argv,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(rank), "--verbose"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(REPO)) for rank in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    return outs


def _last_block(stderr: str) -> dict:
    blocks = [json.loads(ln) for ln in stderr.splitlines()
              if '"block_mined"' in ln]
    return blocks[-1] if blocks else {}


def test_two_processes_over_gloo_match_the_reference_mesh(tmp_path):
    """``mine --coordinator`` with two ranks on the CPU: both reach the
    reference's 2-device mesh tip, rank 0 alone writes the chain and the
    summary, whose ``hashes_tried`` is the mesh's."""
    ref = RefMiner(RefConfig(difficulty_bits=11, n_blocks=4, backend="tpu",
                             kernel="jnp", n_miners=2, batch_pow2=9),
                   log_fn=_quiet)
    ref.mine_chain()
    out = tmp_path / "world.bin"
    (rc0, out0, err0), (rc1, out1, err1) = _spawn_world(
        ["--device", "cpu", "--difficulty", "11", "--blocks", "4",
         "--batch-pow2", "9", "--out", str(out)], 2)
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    summary = _last_json(out0)
    assert summary["tip_hash"] == ref.node.tip_hash.hex(), out0
    assert summary["hashes_tried"] == ref.total_hashes()
    assert summary["config"]["n_miners"] == 2
    assert out1.strip() == ""                  # rank 1 stays silent
    assert out.read_bytes() == ref.node.save()
    tip1 = _last_block(err1)
    assert tip1["height"] == 4 and tip1["hash"] == ref.node.tip_hash.hex()
    assert [b["hashes_tried"] for b in map(
        json.loads, (ln for ln in err1.splitlines()
                     if '"block_mined"' in ln))] == \
        [r.hashes_tried for r in ref.records]


_DISCARD_RANK = textwrap.dedent("""
    import collections, json, sys
    import torch.distributed as dist
    from mpi_blockchain_tpu_torch.backend import backend_from_config
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.parallel.distributed import (
        exit_process, init_distributed, shutdown_distributed)

    rank, port = int(sys.argv[1]), sys.argv[2]
    init_distributed(f"127.0.0.1:{port}", 2, rank)

    class StaleOnce(Miner):
        # The first read of height 3's payload (the speculative issue at
        # block 2's winner) is stale, so block 3's boundary discards that
        # dispatch on every rank and re-issues it.
        reads = collections.Counter()

        def payload_for(self, height):
            self.reads[height] += 1
            if height == 3 and self.reads[height] == 1:
                return b"stale"
            return super().payload_for(height)

    discards = []
    real = Miner._discard_speculative

    def counted(pending, reason):
        discards.append(sum(not d.future.done() for d in pending))
        return real(pending, reason)
    Miner._discard_speculative = staticmethod(counted)
    cfg = MinerConfig(difficulty_bits=11, n_blocks=4, batch_pow2=9,
                      device="cpu", n_miners=2)
    miner = StaleOnce(cfg, backend=backend_from_config(
        cfg, group=dist.group.WORLD))
    miner.mine_chain()
    shutdown_distributed()
    print(json.dumps({"rank": rank, "tip": miner.node.tip_hash.hex(),
                      "tried": [r.hashes_tried for r in miner.records],
                      "discarded": sum(discards)}))
    exit_process(0)
""")



def test_speculative_dispatch_discarded_on_both_ranks():
    """A speculative dispatch that the block boundary discards has only
    started its slice: no rank enters that round's winner-select, so the
    ranks stay in step and reach the reference mesh's chain."""
    ref = RefMiner(RefConfig(difficulty_bits=11, n_blocks=4, backend="tpu",
                             kernel="jnp", n_miners=2, batch_pow2=9),
                   log_fn=_quiet)
    ref.mine_chain()
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _DISCARD_RANK,
                               str(rank), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(), cwd=str(REPO))
             for rank in range(2)]
    try:
        got = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in got]
    rows = [json.loads(out.strip().splitlines()[-1]) for out, _ in got]
    for rank, row in enumerate(rows):
        assert row["rank"] == rank
        assert row["tip"] == ref.node.tip_hash.hex()
        assert row["tried"] == [r.hashes_tried for r in ref.records]
        # The stale dispatch, discarded before anyone consumed it.
        assert row["discarded"] == 1


def test_world_configuration_errors(capsys):
    assert main(["mine", "--device", "cpu", "--coordinator",
                 "127.0.0.1:1"]) == 2
    err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "--num-processes" in err["error"]
    with pytest.raises(ConfigError, match="n_miners"):
        CudaBackend(device="cpu", n_miners=0)


def test_distributed_init_fault_is_retried_then_fails_cleanly(
        tmp_path, monkeypatch, capsys):
    """The ``distributed.init`` fault site fires before the world is
    joined, under the site's retry budget, as the reference's."""
    plan = tmp_path / "p.json"
    plan.write_text(json.dumps({"version": 1, "faults": [
        {"site": "distributed.init", "kind": "raise", "times": -1}]}))
    monkeypatch.setenv("MPIBT_MAX_RETRIES", "2")
    telemetry.reset()
    assert main(["mine", "--device", "cpu", "--coordinator",
                 f"127.0.0.1:{_free_port()}", "--num-processes", "2",
                 "--process-id", "0", "--fault-plan", str(plan)]) == 2
    err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert err["kind"] == "retry_exhausted"
    assert err["site"] == "distributed.init"
    assert telemetry.default_registry().total("retries_total") == 1


def test_world_refuses_to_resume_from_diverging_checkpoints(tmp_path):
    """Every rank must resume from the same chain, or the ranks run
    different rounds and the collectives hang: ranks whose checkpoints
    differ both fail with rc 1 before the first search, as the
    reference's ``_load_resume`` agreement does."""
    paths = []
    for rank, height in enumerate((2, 3)):
        path = tmp_path / f"ck{rank}.bin"
        assert main(["mine", "--backend", "cpu", "--difficulty", "8",
                     "--blocks", str(height), "--checkpoint",
                     str(path)]) == 0
        paths.append(path)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
         "--device", "cpu", "--difficulty", "8", "--blocks", "5",
         "--batch-pow2", "10", "--resume", str(paths[rank]),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=str(REPO))
        for rank in range(2)]
    try:
        got = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [1, 1], [e for _, e in got]
    assert "diverges" in _last_json(got[0][0])["error"]
