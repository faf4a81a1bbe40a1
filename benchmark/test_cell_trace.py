"""The trace's reduction: device intervals clipped to the window, their
union, and the idle gaps named by what the host was doing."""
from __future__ import annotations

import pytest

from benchmark import devtrace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(devtrace.WINDOW, "user_annotation", 100.0, 1000.0),
    _x("fused.dispatch", "user_annotation", 100.0, 50.0),
    _x("miner.append", "user_annotation", 700.0, 200.0),
    # Before the window: left out.
    _x("void (anonymous namespace)::sha256d_sweep_kernel<1, false, true, "
       "false>((anonymous namespace)::SweepArgs, unsigned int*)", "kernel",
       0.0, 50.0),
    _x("void (anonymous namespace)::sha256d_sweep_kernel<1, false, true, "
       "false>((anonymous namespace)::SweepArgs, unsigned int*)", "kernel",
       200.0, 300.0),
    # Overlaps the sweep: counted once in the union.
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 450.0, 100.0),
    _x("void (anonymous namespace)::block_step_kernel<false>(unsigned "
       "int const*)", "kernel", 600.0, 50.0),
    # Runs past the window's end: clipped.
    _x("void (anonymous namespace)::sha256d_sweep_kernel<1, false, true, "
       "false>((anonymous namespace)::SweepArgs, unsigned int*)", "kernel",
       1000.0, 500.0),
    _x("cudaLaunchKernel", "cuda_runtime", 300.0, 5.0),
]


def test_reduce():
    t = devtrace.reduce(EVENTS)
    assert t.window_s == pytest.approx(1000e-6)
    # Busy: [200, 550) + [600, 650) + [1000, 1100).
    assert t.busy_s == pytest.approx(500e-6)
    assert t.seconds("sha256d_sweep_kernel") == pytest.approx(400e-6)
    assert t.seconds("block_step_kernel", "Memcpy DtoD") \
        == pytest.approx(150e-6)
    assert t.count("block_step_kernel") == 1
    gaps = dict((n, 0.0) for n, _ in t.gaps)
    for n, g in t.gaps:
        gaps[n] += g
    # Named by the innermost annotation at each gap's midpoint.
    assert gaps == pytest.approx({"fused.dispatch": 100e-6, "none": 50e-6,
                                  "miner.append": 350e-6})
    b = t.breakdown()
    assert b["device_ops"][0][0] == "sha256d_sweep_kernel<1, false, true, " \
        "false>"
    assert [n for n, _ in b["device_ops"]] == [
        "sha256d_sweep_kernel<1, false, true, false>", "Memcpy DtoD",
        "block_step_kernel<false>"]


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.reduce(EVENTS[1:])
