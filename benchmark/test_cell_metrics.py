"""Each metric's reader on a run made by hand."""
from __future__ import annotations

import pytest

from benchmark import devtrace, harness, replay, spec


def _read(name, run):
    return spec.load_module(spec.metric_file(name)).read(run)


def _run(blocks, **kw):
    fields = dict(cell=spec.cell("fused-d24"), setup_s=7.5, window_s=2.0,
                  blocks=blocks, t_parent=0.0, spans={}, skew=[],
                  trace=None, trace_blocks=[])
    fields.update(kw)
    return harness.Run(**fields)


def _blocks(nonces, dt=0.01):
    return [harness.Block(h + 1, n, 0, (h + 1) * dt)
            for h, n in enumerate(nonces)]


def test_chain_rates_count_what_the_chain_needs():
    run = _run(_blocks([9, 19, 29]) + [harness.Block(4, 4, 1, 0.04)])
    need = 10 + 20 + 30 + (1 << 32) + 5
    assert _read("nonces_per_s", run) == need / 2.0
    assert _read("mesh_nonces_per_s", run) == need / 2.0
    assert _read("setup_s", run) == 7.5
    assert _read("nonces_per_s", _run([])) is None


def test_block_p95_is_the_nearest_rank_of_every_interval():
    times = [0.001 * (i + 1) for i in range(100)]   # gaps 1, 1, 2, 3, ...
    t, blocks = 0.0, []
    for i, g in enumerate(times):
        t += g
        blocks.append(harness.Block(i + 1, 0, 0, t))
    run = _run(blocks)
    assert _read("block_p95_ms", run) == pytest.approx(95.0)


def test_span_readers():
    run = _run(_blocks([1] * 4), spans={"backend.cuda.dispatch": (5, 0.002),
                                        "miner.append": (4, 0.0001)},
               skew=[0.001, 0.003])
    assert _read("dispatch_ms_per_block", run) == pytest.approx(0.5)
    assert _read("append_us_per_block", run) == pytest.approx(25.0)
    assert _read("select_ms_per_round", run) == pytest.approx(2.0)
    empty = _run(_blocks([1] * 4))
    for name in ("dispatch_ms_per_block", "append_us_per_block",
                 "select_ms_per_round", "sweep_roofline",
                 "step_us_per_block", "device_idle_pct"):
        assert _read(name, empty) is None, name


def test_device_readers():
    nonces = (1 << 24) - 1
    secs = 0.0025
    trace = devtrace.Trace(
        window_s=0.01, busy_s=0.008,
        ops=[("sha256d_sweep_kernel<1, false, true, false>", 0.0, secs),
             ("block_step_kernel<false>", secs, secs + 6e-6),
             ("Memcpy DtoD", secs + 6e-6, secs + 7e-6)], gaps=[])
    run = _run([], trace=trace, trace_blocks=_blocks([nonces]))
    clocks = replay.clocks_per_nonce(1879, 1081)
    want = 100 * (1 << 24) * clocks / (secs * 132 * 1980e6)
    assert _read("sweep_roofline", run) == pytest.approx(want)
    assert _read("step_us_per_block", run) == pytest.approx(7.0)
    assert _read("device_idle_pct", run) == pytest.approx(20.0)
