"""Per-block tracing on the card: the sweep's timing events, the pipelined
``Miner``'s device windows taken from them, and the overhead audit.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_trace_cuda.py
"""
import pytest
import torch

from mpi_blockchain_tpu_torch import core, telemetry
from mpi_blockchain_tpu_torch.blocktrace import overhead
from mpi_blockchain_tpu_torch.blocktrace.critical_path import \
    critical_path_report
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.meshwatch.pipeline import (pipeline_report,
                                                         profiler,
                                                         reset_profiler)
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import extend_midstate, sha256_cuda

PINNED_D20_N10 = \
    "000008584f3d49230531993ab565d6fd422b9199d8d3d0279a6b03e9c4b7f445"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_launched_sweep_times_itself_on_the_card():
    device = _card()
    ext = extend_midstate(*core.header_midstate(bytes(range(80))))
    with sha256_cuda.timed_launches():
        launched = sha256_cuda.sweep_launch(ext, 0, 1 << 22, 64,
                                            device=device)
    count, best = launched.result()
    assert (count, best) == (0, 0xFFFFFFFF)
    assert launched.timed
    t, seconds = launched.timing()
    assert t > 0 and 0 < seconds < 1.0
    assert launched.ready()
    # Outside timed_launches a sweep carries one plain event.
    plain = sha256_cuda.sweep_launch(ext, 0, 1 << 22, 64, device=device)
    assert plain.result() == (0, 0xFFFFFFFF)
    assert plain.ready() and not plain.timed
    with pytest.raises(ValueError, match="timed_launches"):
        plain.timing()
    # An empty sweep launches nothing and carries no timing.
    with sha256_cuda.timed_launches():
        empty = sha256_cuda.sweep_launch(ext, 0, 0, 64, device=device)
    assert empty.result() == (0, 0xFFFFFFFF) and not empty.timed


@pytest.mark.cuda
def test_timing_pairs_are_reused_and_read_their_own_sweep():
    """A dropped timed sweep's pair times the next one; each reads its
    own sweep (a longer sweep reads longer)."""
    device = _card()
    ext = extend_midstate(*core.header_midstate(bytes(range(80))))
    pool = sha256_cuda._timing_pairs
    with sha256_cuda.timed_launches():
        short = sha256_cuda.sweep_launch(ext, 0, 1 << 16, 64, device=device)
        short.result()
        pair = (short.start, short.event)
        del short
        assert pool.free[torch.device(
            "cuda", torch.cuda.current_device())][-1] == pair
        long = sha256_cuda.sweep_launch(ext, 0, 1 << 24, 64, device=device)
        assert (long.start, long.event) == pair
        again = sha256_cuda.sweep_launch(ext, 0, 1 << 16, 64, device=device)
    assert long.result() == again.result() == (0, 0xFFFFFFFF)
    assert long.timing()[1] > 10 * again.timing()[1] > 0


@pytest.mark.cuda
def test_pipelined_device_windows_are_the_sweeps():
    """A pipelined d20/n10 chain on the card: one device window a block,
    no two overlapping, every height's critical path complete."""
    _card()
    telemetry.reset()
    reset_profiler()
    miner = Miner(MinerConfig(difficulty_bits=20, n_blocks=10,
                              batch_pow2=20, device="cuda"), pipeline=True)
    miner.mine_chain()
    assert miner.node.tip_hash.hex() == PINNED_D20_N10
    records = profiler().records()
    windows = sorted((s["t0"], s["t1"]) for r in records
                     for s in r["segments"] if s["stage"] == "device")
    assert len(windows) == 10
    assert all(a[1] <= b[0] + 1e-6 for a, b in zip(windows, windows[1:]))
    report = critical_path_report(records)
    assert report["heights"] == list(range(1, 11))
    assert all(report["blocks"][str(h)]["complete"] for h in range(1, 11))
    rep = pipeline_report(records)
    assert 0.0 <= rep["bubble_fraction"] < 1.0


@pytest.mark.cuda
def test_overhead_on_the_card_is_inside_the_bound():
    _card()
    reads = [overhead.measure_trace_overhead(device="cuda")
             for _ in range(3)]
    assert reads[0]["backend"] == "cuda" and reads[0]["chunk_pow2"] == 24
    assert min(r["overhead_pct"] for r in reads) <= 3.0
