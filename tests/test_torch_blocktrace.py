"""The port's blocktrace against the reference's, on the CPU.

The block trace context (stack, template inheritance, rank, threads, the
kill switch) and ``emit_event``'s ``trace`` stamp give the same
observations in both packages. ``critical_path_report``,
``segments_by_block`` and ``render_text`` of the port and of the reference
give equal dicts and strings, exactly, on the same record sets: seeded
soups of overlapping segments made with numpy, fused batches, several
ranks, the reference's hand cases (pipelined overlap, gaps, partial
overlap, the stage priority, a rank missing mid-run) and its skewed-clock
case. The live per-block metrics fill the same histograms. The overhead
audit's payloads have the reference's keys, and its CLI refuses a
missing card cleanly.
"""
import json
import threading

import numpy as np
import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.blocktrace import context as ref_context
from mpi_blockchain_tpu.blocktrace import critical_path as ref_cp
from mpi_blockchain_tpu.blocktrace import overhead as ref_overhead
from mpi_blockchain_tpu.meshwatch import pipeline as ref_pipeline
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.blocktrace import __main__ as bt_main
from mpi_blockchain_tpu_torch.blocktrace import context, critical_path
from mpi_blockchain_tpu_torch.blocktrace import overhead
from mpi_blockchain_tpu_torch.meshwatch import pipeline

torch.set_num_threads(1)

STAGES = ("enqueue", "device", "collective", "validate", "append",
          "checkpoint", "mystery")
PORT = {"telemetry": telemetry, "context": context, "cp": critical_path,
        "pipeline": pipeline}
REF = {"telemetry": ref_telemetry, "context": ref_context, "cp": ref_cp,
       "pipeline": ref_pipeline}


def _reset():
    for pkg in (PORT, REF):
        pkg["telemetry"].reset()
        pkg["telemetry"].clear_events()
        pkg["telemetry"].set_mesh_rank(0)
        pkg["telemetry"].set_telemetry_disabled(False)
        pkg["pipeline"].reset_profiler()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def seg(stage, t0, t1, **kw):
    return {"stage": stage, "t0": t0, "t1": t1, **kw}


def rec(rank=0, meta=None, segments=(), dispatch=0):
    return {"dispatch": dispatch, "rank": rank, "meta": dict(meta or {}),
            "segments": [dict(s) for s in segments]}


# ---- record sets ----------------------------------------------------------


def soup(seed: int) -> list[dict]:
    """Overlapping segments of one or more heights, ranks and fused
    batches, with idle holes and unknown stages, from a numpy seed."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(int(rng.integers(3, 12))):
        rank = int(rng.integers(0, 3))
        kind = int(rng.integers(0, 4))
        meta = ({} if kind == 0
                else {"height": int(rng.integers(1, 6))} if kind == 1
                else {"height": int(rng.integers(0, 4)),
                      "k": int(rng.integers(1, 4))})
        t = float(rng.uniform(0.0, 100.0))
        segments = []
        for _ in range(int(rng.integers(1, 8))):
            t0 = t + float(rng.uniform(-0.004, 0.004))
            t1 = t0 + float(rng.uniform(0.0002, 0.012))
            extra = {}
            if kind == 0 or rng.uniform() < 0.2:
                extra["height"] = int(rng.integers(1, 6))
                if rng.uniform() < 0.3:
                    extra["template"] = int(rng.integers(1, 3))
            if kind == 3 and rng.uniform() < 0.5:
                extra = {}       # a segment with no identity at all
                meta = {}
            segments.append(seg(STAGES[int(rng.integers(0, len(STAGES)))],
                                t0, t1, **extra))
            t = t0 + float(rng.uniform(0.0, 0.014))
        records.append(rec(rank=rank, meta=meta, segments=segments,
                           dispatch=i))
    return records


def _skewed(rank1_base: float) -> list[dict]:
    """The reference's skewed-clock case: a real 1 ms gap on both ranks,
    rank 1's clock base anywhere."""
    def rank_segments(t0):
        return [seg("device", t0, t0 + 0.010),
                seg("append", t0 + 0.011, t0 + 0.012)]
    return [rec(rank=0, meta={"height": 1}, segments=rank_segments(100.0)),
            rec(rank=1, meta={"height": 1},
                segments=rank_segments(rank1_base))]


HAND_CASES = {
    "pipelined_overlap": [rec(meta={"height": 1}, segments=[
        seg("device", 0.0, 0.010), seg("validate", 0.002, 0.004),
        seg("append", 0.004, 0.006)])],
    "gap_between_stages": [rec(meta={"height": 1}, segments=[
        seg("enqueue", 0.0, 0.001), seg("device", 0.002, 0.008)])],
    "partial_overlap": [rec(meta={"height": 2}, segments=[
        seg("device", 0.0, 0.006), seg("validate", 0.004, 0.010)])],
    "priority": [rec(meta={"height": 1}, segments=[
        seg("collective", 0.0, 0.010), seg("device", 0.002, 0.004),
        seg("checkpoint", 0.008, 0.012)])],
    "rank_missing_mid_run": [
        rec(rank=0, meta={"height": 1}, segments=[
            seg("device", 0.0, 0.010), seg("append", 0.010, 0.011)]),
        rec(rank=1, meta={"height": 1}, segments=[
            seg("device", 0.0, 0.020), seg("append", 0.020, 0.021)]),
        rec(rank=0, meta={"height": 2}, segments=[
            seg("device", 0.030, 0.040)])],
    "fused_batch": [
        rec(meta={"height": 4, "k": 3}, segments=[
            seg("enqueue", 0.0, 0.001), seg("device", 0.001, 0.010),
            seg("validate", 0.010, 0.011, height=5),
            seg("append", 0.011, 0.012, height=5),
            seg("validate", 0.012, 0.013, height=6),
            seg("append", 0.013, 0.014, height=6),
            seg("validate", 0.014, 0.015, height=7),
            seg("append", 0.015, 0.016, height=7)]),
        rec(meta={"height": 7, "k": 1}, segments=[
            seg("device", 0.016, 0.020)]),
        rec(meta={"kind": "checkpoint"}, segments=[
            seg("checkpoint", 0.020, 0.021, height=8)])],
    "skewed_clocks_plain": _skewed(100.0),
    "skewed_clocks_10_days": _skewed(100.0 + 864000.0),
    "empty": [],
    "unattributed_only": [rec(segments=[seg("device", 0.0, 1.0)])],
}

RECORD_SETS = {**HAND_CASES,
               **{f"soup_{seed}": soup(seed) for seed in range(12)}}


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_critical_path_report_and_text_equal_the_references(name):
    records = RECORD_SETS[name]
    got = critical_path.critical_path_report(records)
    want = ref_cp.critical_path_report(records)
    assert got == want
    assert critical_path.render_text(got) == ref_cp.render_text(want)
    assert critical_path.segments_by_block(records) == \
        ref_cp.segments_by_block(records)
    for h in want["heights"][:2]:
        assert critical_path.critical_path_report(records, height=h) == \
            ref_cp.critical_path_report(records, height=h)
    # Conservation, per block and per rank: sum(stages) + gap == wall.
    for b in got["blocks"].values():
        for wf in [b, *b["ranks"].values()]:
            assert sum(wf["stages_ms"].values()) + wf["gap_ms"] == \
                pytest.approx(wf["wall_ms"], abs=1e-3)


def test_skewed_clock_bases_change_nothing_but_the_anchor():
    """Shifting one rank's whole time base neither invents nor hides a
    gap: the reports agree up to the per-rank anchor ``t0``."""
    def strip(report):
        clone = json.loads(json.dumps(report))
        for b in clone["blocks"].values():
            for wf in b["ranks"].values():
                wf.pop("t0")
        return clone

    plain = critical_path.critical_path_report(
        RECORD_SETS["skewed_clocks_plain"])
    skewed = critical_path.critical_path_report(
        RECORD_SETS["skewed_clocks_10_days"])
    assert strip(plain) == strip(skewed)
    for wf in plain["blocks"]["1"]["ranks"].values():
        assert wf["gap_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("seed", range(4))
def test_report_is_deterministic_across_record_order(seed):
    records = soup(seed)
    base = critical_path.critical_path_report(records)
    assert critical_path.critical_path_report(records[::-1]) == base
    assert critical_path.critical_path_report(
        sorted(records, key=lambda r: r["rank"])) == base


@pytest.mark.parametrize("name", ["fused_batch", "pipelined_overlap",
                                  "soup_3", "soup_7"])
def test_live_block_metrics_fill_the_references_histograms(name):
    records = RECORD_SETS[name]
    heights = critical_path.critical_path_report(records)["heights"]
    got = critical_path.observe_batch_metrics(heights, records)
    want = ref_cp.observe_batch_metrics(heights, records)
    assert got == want
    for h in heights:
        assert critical_path.observe_block_metrics(h, records=records) == \
            ref_cp.observe_block_metrics(h, records=records)
    snap = telemetry.default_registry().snapshot()
    ref_snap = ref_telemetry.default_registry().snapshot()
    for name_ in ("block_critical_path_ms", "block_trace_gap_pct"):
        assert snap.get(name_) == ref_snap.get(name_)


def test_observe_is_a_flag_check_with_the_telemetry_off():
    records = RECORD_SETS["pipelined_overlap"]
    telemetry.set_telemetry_disabled(True)
    assert critical_path.observe_block_metrics(1, records=records) is None
    assert critical_path.observe_batch_metrics([1], records) == {}
    assert "block_trace_gap_pct" not in \
        telemetry.default_registry().snapshot()


# ---- the context and its stamps --------------------------------------------


def _context_story(pkg) -> list:
    """The same sequence of frames, stamps and events in either package;
    returns what it observed."""
    ctx, tel, pipe = pkg["context"], pkg["telemetry"], pkg["pipeline"]
    seen = [ctx.current_trace(), ctx.trace_dict()]
    tel.set_mesh_rank(3)
    prof = pipe.profiler()
    with ctx.trace_block(7) as outer:
        seen.append(outer.to_dict())
        with ctx.trace_block(7, template=2) as inner:
            seen.append(inner.to_dict())
            with ctx.trace_block(7) as again:     # inherits template 2
                seen.append(again.to_dict())
            r = prof.dispatch(kind="sweep")       # height from the frame
            with r.segment("enqueue"):
                pass
            r.add_segment("device", 1.0, 2.0)
        with ctx.trace_block(8) as other:         # new height: template 0
            seen.append(other.to_dict())
        tel.emit_event({"event": "retry"})
        tel.emit_event({"event": "own", "trace": {"height": 1}})
        with ctx.trace_block(9, rank=5):
            seen.append(ctx.trace_dict())
    tel.emit_event({"event": "outside"})
    seen.append([{k: v for k, v in s.items() if k not in ("t0", "t1")}
                 for s in r.record["segments"]])
    seen.append(r.record["meta"])
    other_thread = []
    with ctx.trace_block(11):
        t = threading.Thread(target=lambda: other_thread.append(
            ctx.current_trace()))
        t.start()
        t.join()
    seen.append(other_thread)
    tel.set_telemetry_disabled(True)
    with ctx.trace_block(12) as off:
        seen.append([off, ctx.current_trace()])
        tel.emit_event({"event": "dropped"})
        seen.append(pipe.profiler().dispatch(kind="x").record)
    tel.set_telemetry_disabled(False)
    seen.append(tel.recent_events())
    return seen


def test_trace_context_and_stamps_match_the_reference():
    got = _context_story(PORT)
    want = _context_story(REF)
    assert got == want
    assert got[1] is None
    assert {"height": 7, "template": 2, "rank": 3} in got
    events = got[-1]
    assert [e["event"] for e in events] == ["retry", "own", "outside"]
    assert events[0]["trace"] == {"height": 7, "template": 0, "rank": 3}
    assert events[1]["trace"] == {"height": 1}
    assert "trace" not in events[2]


# ---- the overhead audit ----------------------------------------------------


def test_overhead_payloads_have_the_references_keys():
    got = overhead.measure_trace_overhead(seconds=0.02, reps=1,
                                          device="cpu")
    want = ref_overhead.measure_trace_overhead(seconds=0.02, reps=1)
    assert set(got) == set(want)
    assert got["backend"] == want["backend"] == "cpu"
    assert got["chunk_pow2"] == want["chunk_pow2"] == 13
    assert got["pairs"] >= 1 and got["reps"] == 1
    null = overhead.measure_trace_overhead(seconds=0.02, reps=1,
                                           device="cpu", null=True)
    assert set(null) == set(want)
    obs = overhead.measure_block_observe(samples=8, device="cpu")
    ref_obs = ref_overhead.measure_block_observe(samples=8)
    assert set(obs) == set(ref_obs) and obs["samples"] == 8
    # The audits leave the watchdog as they found it, and the run's own
    # telemetry untouched (audit-labeled series only).
    from mpi_blockchain_tpu_torch import chainwatch
    assert not chainwatch.installed()
    assert pipeline.profiler().records() == []


def test_overhead_cli_prints_the_payload_and_refuses_a_missing_card(
        capsys, monkeypatch):
    rc = bt_main.main(["overhead", "--device", "cpu", "--seconds", "0.02",
                       "--reps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["event"] == "trace_overhead"
    assert rc == (0 if line["overhead_pct"] <= 3.0 else 1)
    assert bt_main.main(["overhead", "--device", "cpu",
                         "--block-observe"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["event"] == "trace_block_observe"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bt_main.main(["overhead"]) == 2
    err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "no CUDA device" in err["error"]


@pytest.mark.parametrize("instrumented", [True, False],
                         ids=["instrumented", "off"])
def test_the_card_audit_round_prices_the_timing_events(monkeypatch,
                                                       instrumented):
    """On the card the audit's instrumented half launches the stamped
    sweep and reads its window, as the pipelined ``Miner`` does; the off
    half launches the plain sweep and reads no window."""
    from mpi_blockchain_tpu_torch.blocktrace import overhead
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    launched = []

    class Launched:
        def __init__(self):
            self.timed = sha256_cuda.timing_requested()
            self.reads = 0

        def result(self):
            return 0, 0xFFFFFFFF

        def timing(self):
            self.reads += 1
            return 0.0, 0.001

    def fake_launch(ext, base, count, dbits, *, device, early_exit=False):
        assert (count, dbits, early_exit) == (1 << 10, 64, False)
        launched.append(Launched())
        return launched[-1]

    monkeypatch.setattr(sha256_cuda, "sweep_launch", fake_launch)
    sweep = overhead._sweep_fn("cuda:0")
    prev = telemetry.set_telemetry_disabled(not instrumented)
    try:
        assert sweep(5, 1 << 10) == (0, 0xFFFFFFFF)
    finally:
        telemetry.set_telemetry_disabled(prev)
    assert [(s.timed, s.reads) for s in launched] == (
        [(True, 1)] if instrumented else [(False, 0)])
    assert not sha256_cuda.timing_requested()
