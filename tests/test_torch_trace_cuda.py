"""Per-block tracing on the card: the stamped sweep's window, the pipelined
``Miner``'s device windows taken from it, and the overhead audit.

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
    """Inside ``timed_launches`` the sweep is the stamped build: its
    read-back brings the stamps, and its window lies inside CUDA events
    recorded around its launch."""
    device = _card()
    ext = extend_midstate(*core.header_midstate(bytes(range(80))))
    before = torch.cuda.Event(enable_timing=True)
    after = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    before.record()
    with sha256_cuda.timed_launches():
        launched = sha256_cuda.sweep_launch(ext, 0, 1 << 22, 64,
                                            device=device)
    after.record()
    count, best = launched.result()
    assert (count, best) == (0, 0xFFFFFFFF)
    assert launched.timed and len(launched.out) == 8
    t, seconds = launched.timing()
    assert t > 0 and 0 < seconds < 1.0
    assert seconds * 1e3 <= before.elapsed_time(after)
    assert launched.ready()
    # Outside timed_launches a sweep is the plain build, four words.
    plain = sha256_cuda.sweep_launch(ext, 0, 1 << 22, 64, device=device)
    assert plain.result() == (0, 0xFFFFFFFF)
    assert plain.ready() and not plain.timed and len(plain.out) == 4
    with pytest.raises(ValueError, match="timed_launches"):
        plain.timing()
    # An empty sweep launches nothing and carries no window.
    with sha256_cuda.timed_launches():
        empty = sha256_cuda.sweep_launch(ext, 0, 0, 64, device=device)
    assert empty.result() == (0, 0xFFFFFFFF) and not empty.timed


@pytest.mark.cuda
def test_stamped_sweeps_read_their_own_window():
    """Each stamped sweep reads its own window (a longer sweep reads
    longer), and one read before its result, once it is done, does not
    wait for a sweep launched after it (past the first such read of the
    process, which makes the stream it reads on)."""
    device = _card()
    ext = extend_midstate(*core.header_midstate(bytes(range(80))))
    with sha256_cuda.timed_launches():
        first = sha256_cuda.sweep_launch(ext, 0, 1 << 16, 64, device=device)
        torch.cuda.synchronize()
        assert first.ready() and first.timing()[1] > 0
        short = sha256_cuda.sweep_launch(ext, 0, 1 << 16, 64, device=device)
        torch.cuda.synchronize()
        long = sha256_cuda.sweep_launch(ext, 0, 1 << 30, 64, device=device)
    assert short.ready() and not long.ready()
    short_s = short.timing()[1]
    assert not long.ready()
    assert long.result() == short.result() == (0, 0xFFFFFFFF)
    assert long.timing()[1] > 1000 * short_s > 0


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
