"""The readers of the program's host spans on a run made by hand, their
entries, and the trace's naming of an idle gap by a leaf span nested in an
outer one."""
from __future__ import annotations

import pytest

from benchmark import devtrace, harness, spec

SPEC = spec.load_spec()

#: metric -> (span it reads, scale to its unit, its cells, its layer).
HOST = {
    "observe_us_per_block": ("blocktrace.observe", 1e6,
                             ["fused-d24", "miner-d24"],
                             "trace observation (blocktrace)"),
    "observe_us_per_block.d20": ("blocktrace.observe", 1e6, ["fused-d20"],
                                 "trace observation (blocktrace)"),
    "validate_us_per_block": ("fused.validate", 1e6, ["fused-d24"],
                              "fused driver"),
    "validate_us_per_block.d20": ("fused.validate", 1e6, ["fused-d20"],
                                  "fused driver"),
    "issue_ms_per_block": ("miner.issue", 1e3, ["miner-d24"],
                           "per-block driver and backend"),
}


def _read(name, run):
    return spec.load_module(spec.metric_file(name)).read(run)


def _run(n_blocks, spans):
    return harness.Run(
        cell=spec.cell("fused-d24"), setup_s=7.5, window_s=2.0,
        blocks=[harness.Block(h + 1, 1, 0, 0.01 * (h + 1))
                for h in range(n_blocks)],
        t_parent=0.0, spans=spans, skew=[], trace=None, trace_blocks=[])


@pytest.mark.parametrize("name", sorted(HOST))
def test_a_host_span_reader_reads_its_span_over_the_window_s_blocks(name):
    span_name, scale = HOST[name][:2]
    run = _run(8, {span_name: (3, 0.004), "miner.block": (8, 1.0)})
    assert _read(name, run) == pytest.approx(0.004 / 8 * scale)


@pytest.mark.parametrize("name", sorted(HOST))
def test_a_host_span_reader_gives_none_without_its_span(name):
    span_name = HOST[name][0]
    others = {n: (2, 0.5) for n, *_ in HOST.values() if n != span_name}
    assert _read(name, _run(8, others)) is None
    assert _read(name, _run(8, {span_name: (0, 0.0)})) is None
    assert _read(name, _run(0, {span_name: (3, 0.004)})) is None


@pytest.mark.parametrize("name", sorted(HOST))
def test_a_host_span_metric_s_entry(name):
    m = {e["name"]: e for e in SPEC["per_layer"]}[name]
    _, _, cells, layer = HOST[name]
    rate = "nonces_per_s.d20" if name.endswith(".d20") else "nonces_per_s"
    assert m["unit"] == ("ms" if name.startswith("issue_") else "us")
    assert (m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("lower", "program_span", layer, rate, cells)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _sweep(ts, dur):
    return _x("void sha256d_sweep_kernel<1, false, false, true>("
              "SweepArgs, unsigned int*)", "kernel", ts, dur)


def test_a_gap_is_named_by_the_new_leaf_span_inside_its_outer_one():
    # One block of the per-block driver: the sweep, then the host's work
    # until the next launch, all inside ``miner.block``. The gaps' midpoints
    # fall in ``miner.window``, ``backend.cuda.midstate`` (inside
    # ``backend.cuda.dispatch`` inside ``miner.issue``) and
    # ``blocktrace.observe``; one falls in ``miner.block`` alone.
    events = [
        _x(devtrace.WINDOW, "user_annotation", 0.0, 1000.0),
        _x("miner.block", "user_annotation", 0.0, 900.0),
        _sweep(0.0, 100.0),
        _x("miner.sweep", "user_annotation", 10.0, 95.0),
        _x("miner.window", "user_annotation", 105.0, 40.0),
        # Idle 100 to 160: midpoint 130, in miner.window.
        _sweep(160.0, 100.0),
        # Idle 260 to 300: midpoint 280, in miner.block only.
        _sweep(300.0, 100.0),
        _x("miner.issue", "user_annotation", 400.0, 200.0),
        _x("backend.cuda.dispatch", "user_annotation", 410.0, 180.0),
        _x("backend.cuda.midstate", "user_annotation", 420.0, 100.0),
        _x("backend.cuda.launch", "user_annotation", 520.0, 60.0),
        # Idle 400 to 540: midpoint 470, in the midstate.
        _sweep(540.0, 100.0),
        _x("blocktrace.observe", "user_annotation", 640.0, 300.0),
        # Idle 640 to 1000: midpoint 820, in blocktrace.observe (which
        # outlasts miner.block).
    ]
    t = devtrace.reduce(events)
    named = {}
    for n, g in t.gaps:
        named[n] = named.get(n, 0.0) + g
    assert named == pytest.approx({"miner.window": 60e-6,
                                   "miner.block": 40e-6,
                                   "backend.cuda.midstate": 140e-6,
                                   "blocktrace.observe": 360e-6})
    assert t.breakdown()["idle_gaps"][0][0] == "blocktrace.observe"
