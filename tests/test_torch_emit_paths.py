"""The per-sweep emit points of the port's telemetry against the reference's,
on the CPU.

The emits a sweep round pays (``blocktrace.trace_block``, a pipeline
dispatch and its segments, a span, counters, a heartbeat, a skew span) take
short paths in the port: a segment's exit files its dict without
``add_segment``'s frame, a dispatch record and a span are built without
their ``__init__`` frames, counter and heartbeat hits skip the registry's
``_get``, a span files into its summary without ``record_span``'s frame,
and a skew span takes its round from an ``itertools.count``. Each path here
leaves what the reference's leaves on the same calls, and what the long
path leaves; ``tools/overhead_split``'s stamped round leaves what the
audit's round leaves.
"""
import threading

import pytest

from mpi_blockchain_tpu.blocktrace import context as ref_context
from mpi_blockchain_tpu.meshprof import spans as ref_skew
from mpi_blockchain_tpu.meshwatch import pipeline as ref_pipeline
from mpi_blockchain_tpu.telemetry import registry as ref_registry
from mpi_blockchain_tpu.telemetry import spans as ref_spans
from mpi_blockchain_tpu_torch import chainwatch, telemetry
from mpi_blockchain_tpu_torch.blocktrace import context
from mpi_blockchain_tpu_torch.blocktrace.overhead import _instrumented_round
from mpi_blockchain_tpu_torch.meshprof import spans as skew
from mpi_blockchain_tpu_torch.meshwatch import pipeline
from mpi_blockchain_tpu_torch.telemetry import registry, spans
from mpi_blockchain_tpu_torch.tools import overhead_split


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    ref_registry.reset()
    skew.clear_spans()
    ref_skew.clear_spans()
    yield
    registry.set_telemetry_disabled(False)
    ref_registry.set_telemetry_disabled(False)


def _shape(record: dict) -> dict:
    """A dispatch record with its times replaced by their types."""
    return {**record, "segments": [
        {k: (type(v).__name__ if k in ("t0", "t1") else v)
         for k, v in seg.items()} for seg in record["segments"]]}


def _dispatch(pkg_pipeline, pkg_context, template: int) -> dict:
    profiler = pkg_pipeline.PipelineProfiler()
    with pkg_context.trace_block(7, template=template):
        rec = profiler.dispatch(kind="sweep", backend="cuda")
        with rec.segment("enqueue"):
            pass
        with rec.segment("device"):
            pass
        with rec.segment("collective", chained=False):
            pass
    return rec.record


@pytest.mark.parametrize("template", [0, 3])
def test_dispatch_and_segments_leave_the_references_record(template):
    ours = _dispatch(pipeline, context, template)
    ref = _dispatch(ref_pipeline, ref_context, template)
    assert _shape(ours) == _shape(ref)
    enqueue, device, _ = ours["segments"]
    assert device["t0"] == enqueue["t1"]          # chained
    assert all(s["t0"] <= s["t1"] for s in ours["segments"])


def test_a_segments_exit_files_what_add_segment_files():
    profiler = pipeline.PipelineProfiler()
    with context.trace_block(4, template=2):
        rec = profiler.dispatch(kind="sweep")
        with rec.segment("validate"):
            pass
        t0, t1 = rec.record["segments"][0]["t0"], \
            rec.record["segments"][0]["t1"]
        rec.add_segment("validate", t0, t1)
    by_ctx, by_call = rec.record["segments"]
    assert by_ctx == by_call
    assert [type(by_ctx[k]) for k in ("stage", "t0", "t1")] == \
        [str, float, float]


def test_dispatch_ids_ranks_and_the_ring_bound():
    telemetry.set_mesh_rank(2)
    try:
        profiler = pipeline.PipelineProfiler(capacity=3)
        recs = [profiler.dispatch(kind="sweep", height=h) for h in range(5)]
    finally:
        telemetry.set_mesh_rank(0)
    assert [r.record["dispatch"] for r in recs] == [0, 1, 2, 3, 4]
    assert {r.record["rank"] for r in recs} == {2}
    assert [r["dispatch"] for r in profiler.records()] == [2, 3, 4]
    assert recs[0].now() >= recs[0].at(0.0)


def test_spans_file_as_the_reference_and_as_record_span():
    for pkg_spans in (spans, ref_spans):
        with pkg_spans.span("miner.block", height=1):
            for _ in range(3):
                with pkg_spans.span("miner.sweep", height=1):
                    pass
    ours, ref = telemetry.default_registry(), ref_registry.default_registry()
    assert [(s.name, s.parent, s.depth, s.attrs) for s in ours.spans()] == \
        [(s.name, s.parent, s.depth, s.attrs) for s in ref.spans()]
    hist = ours.histogram("span_seconds", span="miner.sweep")
    assert hist.count == 3
    assert hist.sum == pytest.approx(
        sum(s.duration_s for s in ours.spans("miner.sweep")))
    assert spans.active_span() is None


def test_counter_and_heartbeat_hits_return_the_registered_metric():
    c = telemetry.counter("rounds_total", help="h", backend="cuda")
    assert telemetry.counter("rounds_total", backend="cuda") is c
    assert telemetry.counter("rounds_total", help="h", backend="cuda") is c
    # An unhashable label value takes the canonical path, as in ``_get``.
    odd = telemetry.counter("odd_total", tags=["a"])
    assert telemetry.counter("odd_total", tags=["a"]) is odd
    # A heartbeat gauge made without its help gets it from ``heartbeat``.
    g = telemetry.gauge("x_heartbeat")
    assert g.help == ""
    assert telemetry.heartbeat("x_heartbeat") is g
    assert g.help.startswith("progress heartbeat")
    h = telemetry.heartbeat("y_heartbeat")
    assert telemetry.heartbeat("y_heartbeat") is h
    with pytest.raises(registry.MetricError):
        telemetry.heartbeat("no_suffix")
    registry.set_telemetry_disabled(True)
    assert telemetry.counter("rounds_total") is registry.NULL_METRIC
    assert telemetry.heartbeat("y_heartbeat") is registry.NULL_METRIC


def test_skew_spans_leave_the_references_ring():
    for pkg in (skew, ref_skew):
        with context.trace_block(5, template=1), \
                ref_context.trace_block(5, template=1):
            for site in ("mesh.sweep", "block.step", "mesh.sweep"):
                with pkg.skew_span(site=site):
                    pass
    strip = [{k: v for k, v in r.items() if k not in ("t_enter", "t_exit")}
             for r in skew.spans_tail()]
    ref = [{k: v for k, v in r.items() if k not in ("t_enter", "t_exit")}
           for r in ref_skew.spans_tail()]
    assert strip == ref
    assert [r["round"] for r in strip] == [0, 0, 1]


def test_skew_rounds_are_unique_across_threads():
    n_threads, per_thread = 8, 200

    def enter_many():
        for _ in range(per_thread):
            with skew.skew_span(site="mesh.sweep"):
                pass

    threads = [threading.Thread(target=enter_many)
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rounds = sorted(r["round"]
                    for r in skew.spans_tail(n_threads * per_thread))
    assert rounds == list(range(n_threads * per_thread))


def test_overhead_splits_stamped_round_leaves_the_audits_round():
    """The tool's round, written out with stamps, emits what the audit's
    ``_instrumented_round`` emits: the same dispatch record, counters,
    heartbeat, spans and skew spans."""
    was_armed = chainwatch.installed()
    chainwatch.install()
    try:
        left = {}
        for name, run in (("audit", _instrumented_round),
                          ("tool", overhead_split._stamped_round)):
            reg = telemetry.reset()
            skew.clear_spans()
            profiler = pipeline.PipelineProfiler()
            run(profiler, 3, 0, 1 << 10, lambda base, count: None)
            left[name] = {
                "records": [_shape(r) for r in profiler.records()],
                "metrics": sorted(
                    (m.name, m.labels, m.value if m.kind != "histogram"
                     else m.count) for m in reg.metrics()),
                "spans": [(s.name, s.attrs) for s in reg.spans()],
                "skew": [{k: v for k, v in r.items()
                          if k not in ("t_enter", "t_exit")}
                         for r in skew.spans_tail()]}
    finally:
        if not was_armed:
            chainwatch.uninstall()
    assert left["tool"] == left["audit"]
    assert len(overhead_split.PIECES) == 14
