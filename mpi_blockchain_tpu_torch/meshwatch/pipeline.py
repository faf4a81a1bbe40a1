"""Dispatch pipeline profiler: where does a mine dispatch's wall go?

The port's copy of the reference's ``meshwatch/pipeline.py``. The miner's
hot cycle is dispatch-shaped: build inputs (*enqueue*), wait on the device
(*device*), then host work (*validate*, *append*, *checkpoint*). This
module records every dispatch as absolute-timestamped segments in a
bounded ring and derives:

* **device busy**: the union of every dispatch's ``device`` window;
* **bubble fraction**: ``1 - device_busy / wall``, the share of the run's
  wall with no dispatch on the device, the device idling behind host
  work;
* **overlap**: host-segment time that coincides with a device window,
  host work hidden behind device compute, per dispatch and globally
  (``host_overlapped_fraction``).

What a ``device`` window is depends on the driver (each states it): the
pipelined ``Miner`` on the card takes it from the card's own CUDA events
around each sweep (``models/miner.py``); the fused miner's opens when its
call returns and closes when the call's nonces are on the host
(``models/fused.py``); with no device (the C++ sweep, the plain sweep on
the CPU) it is the search call.

Timestamps are ``time.time()``-anchored monotonic floats: monotonic
within a process (one anchor per profiler), wall-comparable across
processes on one host. Records are plain dicts, JSON-able as they are:

    {"dispatch": 3, "rank": 0, "meta": {...},
     "segments": [{"stage": "device", "t0": ..., "t1": ...}, ...]}
"""
from __future__ import annotations

import threading
import time

from .. import telemetry
from ..blocktrace.context import _tls as _trace_tls
from ..meshprof import memory as _memory
from ..telemetry import registry as _registry
from ..telemetry.registry import telemetry_disabled

#: Canonical stage names, in pipeline order. ``device`` is the in-flight
#: window; ``collective`` is a guarded rendezvous wait
#: (resilience/elastic.guarded_collective) — blocked-on-the-fabric time,
#: distinct from device compute; everything else is host work.
STAGES = ("enqueue", "device", "collective", "validate", "append",
          "checkpoint")
#: Stages that are NOT host work — device compute, and the collective
#: fabric wait (blocked-on-the-fabric is neither compute nor work) —
#: so the overlap report must not price them as host busy time (a
#: rendezvous spanning a device window would otherwise read as perfect
#: host/device pipelining). Every other stage, known or custom, counts
#: as host work.
NON_HOST_STAGES = ("device", "collective")

RING_SIZE = 4096
_new = object.__new__
#: The producer named in ``to_chrome_trace``'s metadata.
SOURCE = "mpi_blockchain_tpu_torch.meshwatch"


class DispatchRecord:
    """One dispatch's timed segments, opened by
    ``PipelineProfiler.dispatch``. Thread-compatible: the miner loop
    mutates a record from one thread at a time. ``_last_end`` is the
    latest segment end so far (a chained segment opens there)."""

    __slots__ = ("_profiler", "_anchor", "_last_end", "record")

    def add_segment(self, stage: str, t0: float, t1: float) -> None:
        t1 = float(t1)
        seg = {"stage": str(stage), "t0": float(t0), "t1": t1}
        # A segment recorded inside a blocktrace scope carries its exact
        # block identity — how a fused batch's per-block validate/append
        # segments stay individually attributable (blocktrace/
        # critical_path.py attribution rule 1).
        stack = getattr(_trace_tls, "stack", None)
        if stack:
            trace = stack[-1]
            seg["height"] = trace.height
            if trace.template:
                seg["template"] = trace.template
        self.record["segments"].append(seg)
        if self._last_end is None or t1 > self._last_end:
            self._last_end = t1

    def segment(self, stage: str, chained: bool = True):
        """``with rec.segment("append"): ...`` times one segment.

        Chained: the segment opens at this record's previous segment's
        end (when that end is in the past), not at entry time — the
        few-microsecond host orchestration between stages belongs to
        the dispatch, and charging it to the *following* stage keeps
        the per-block gap accounting (blocktrace) structurally zero
        inside a dispatch instead of polluted by instrumentation seams.
        ``chained=False`` opts out for segments that are NOT the next
        stage of a sequential pipeline (a collective wait concurrent
        with other work must start at its true entry time, not be
        backdated to the previous stage boundary).
        """
        # Built without ``_SegmentCtx.__init__``'s frame: two of these
        # open on every sweep.
        ctx = _new(_SegmentCtx)
        ctx._rec, ctx._stage, ctx._chained = self, stage, chained
        return ctx

    def now(self) -> float:
        return self._profiler.now()

    def at(self, perf_counter_t: float) -> float:
        """A ``time.perf_counter()`` reading on this record's clock."""
        return self._profiler.at(perf_counter_t)


class _SegmentCtx:
    """One segment's scope, made by ``DispatchRecord.segment``."""

    __slots__ = ("_rec", "_stage", "_chained", "_t0")

    def __enter__(self):
        rec = self._rec
        now = time.perf_counter() + rec._anchor
        last_end = rec._last_end
        self._t0 = (last_end if self._chained and last_end is not None
                    and last_end <= now else now)
        return self

    def __exit__(self, *exc):
        # ``DispatchRecord.add_segment`` written out: this runs twice a
        # sweep, and its times are floats already.
        rec = self._rec
        t1 = time.perf_counter() + rec._anchor
        seg = {"stage": str(self._stage), "t0": self._t0, "t1": t1}
        stack = getattr(_trace_tls, "stack", None)
        if stack:
            trace = stack[-1]
            seg["height"] = trace.height
            if trace.template:
                seg["template"] = trace.template
        rec.record["segments"].append(seg)
        if rec._last_end is None or t1 > rec._last_end:
            rec._last_end = t1
        return False


class _NullDispatchRecord:
    """The do-nothing record ``dispatch()`` hands out while telemetry is
    off (MPIBT_TELEMETRY_OFF): segments vanish, ``now()`` stays real —
    callers use it for their own arithmetic (the fused drain's latency
    math), not just for segments."""

    record = {"dispatch": -1, "rank": 0, "meta": {}, "segments": []}

    def add_segment(self, stage: str, t0: float, t1: float) -> None:
        pass

    def segment(self, stage: str, chained: bool = True):
        return _NULL_SEGMENT_CTX

    def now(self) -> float:
        return time.time()

    def at(self, perf_counter_t: float) -> float:
        return time.time() - time.perf_counter() + perf_counter_t


class _NullSegmentCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_RECORD = _NullDispatchRecord()
_NULL_SEGMENT_CTX = _NullSegmentCtx()


class PipelineProfiler:
    """Bounded ring of dispatch records + the timestamp anchor."""

    def __init__(self, capacity: int = RING_SIZE):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._records: list[DispatchRecord] = []
        self._next_id = 0
        # One anchor per profiler: time.time() sampled once against
        # perf_counter, so timestamps are monotonic (perf_counter) yet
        # wall-scaled (comparable across same-host ranks).
        self._anchor = time.time() - time.perf_counter()

    def now(self) -> float:
        return self._anchor + time.perf_counter()

    def at(self, perf_counter_t: float) -> float:
        """A ``time.perf_counter()`` reading on this profiler's clock."""
        return self._anchor + perf_counter_t

    def dispatch(self, **meta) -> DispatchRecord:
        """Open a new dispatch record (ring-bounded). Inside a
        ``blocktrace.trace_block`` scope the meta's ``height`` defaults
        from the trace context when the call site passed none."""
        if _registry._telemetry_off:
            return _NULL_RECORD
        # Device-memory watermark sample at the dispatch boundary, the
        # one per-sweep host touchpoint the overhead audit prices.
        # Throttled (a hot loop pays a clock read, here), and a no-op in
        # a process that has not initialized CUDA.
        if time.monotonic() - _memory._last_sample >= \
                _memory.SAMPLE_INTERVAL_S:
            _memory.sample_memory()
        # ``meta`` is this call's own keyword dict: no copy needed.
        if meta.get("height") is None:
            stack = getattr(_trace_tls, "stack", None)
            if stack:
                meta["height"] = stack[-1].height
        # Built without an ``__init__`` frame: one opens on every sweep.
        rec = _new(DispatchRecord)
        rec._profiler, rec._anchor, rec._last_end = self, self._anchor, None
        with self._lock:
            rec.record = {"dispatch": self._next_id,
                          "rank": telemetry._mesh_rank, "meta": meta,
                          "segments": []}
            self._next_id += 1
            records = self._records
            records.append(rec)
            if len(records) > self._capacity:
                del records[:len(records) - self._capacity]
            return rec

    def segment_on_last(self, stage: str, chained: bool = True):
        """Context manager timing a segment onto the newest record —
        the seam for work that happens outside the miner (the CLI's
        periodic checkpoint save). Opens a fresh record when none
        exists yet. ``chained`` as in ``DispatchRecord.segment``."""
        if telemetry_disabled():
            return _NULL_SEGMENT_CTX
        with self._lock:
            rec = self._records[-1] if self._records else None
        if rec is None:
            rec = self.dispatch(kind=stage)
        return rec.segment(stage, chained=chained)

    def records(self, tail: int | None = None) -> list[dict]:
        """Copies of the ringed records; ``tail`` bounds the copy to the
        newest n before copying, so a reader that keeps 64 does not
        copy 4096."""
        with self._lock:
            recs = (self._records if tail is None
                    else self._records[-tail:])
            return [dict(r.record, segments=list(r.record["segments"]))
                    for r in recs]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._next_id = 0


def strip_block_identity(record: dict, keep_k: int | None = None,
                         segments: bool = False) -> None:
    """Strips the block identity from a dispatch record that was
    abandoned — a fused recovery bail-out's in-flight batches, or the
    pipelined miner's discarded speculative dispatches. The heights an
    abandoned dispatch was stamped for WILL be mined by a live dispatch,
    and the critical-path join must never merge a dead dispatch's slices
    into the real block's waterfall: the work stays visible as
    ``unattributed``, never silently dropped, never double-counted
    (``blocktrace.critical_path``'s attribution rules).

    ``keep_k``: the fused partial-batch case — the first ``keep_k``
    blocks of the batch WERE appended, so the meta keeps its height with
    ``k`` clamped to the appended prefix instead of losing identity
    entirely. ``segments=True`` additionally strips per-segment
    ``height``/``template`` stamps (the miner's speculative dispatches
    record their segments inside ``trace_block`` scopes; the fused
    bail-out keeps its exact drain-side stamps — that work is real).

    Everything is rebound to fresh dicts, never mutated in place: a
    reader on another thread may be serializing the old dicts (rebinding
    is atomic under the interpreter lock; an in-place ``del`` would break
    its iteration).
    Key-guarded so the telemetry-off shared null record is never
    written."""
    meta = record.get("meta") or {}
    if "height" in meta:
        meta = dict(meta)
        if keep_k:
            meta["k"] = keep_k
        else:
            del meta["height"]
        record["meta"] = meta
    if segments:
        segs = record.get("segments") or []
        if any("height" in s or "template" in s for s in segs):
            record["segments"] = [
                {k: v for k, v in s.items()
                 if k not in ("height", "template")} for s in segs]


# ---- the process-default profiler ----------------------------------------

_default = PipelineProfiler()


def profiler() -> PipelineProfiler:
    return _default


def reset_profiler() -> PipelineProfiler:
    """Fresh default profiler (test/CLI isolation)."""
    global _default
    _default = PipelineProfiler()
    return _default


# ---- interval math --------------------------------------------------------


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted, non-overlapping intervals."""
    merged: list[list[float]] = []
    for t0, t1 in sorted(i for i in intervals if i[1] > i[0]):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def _length(union: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in union)


def _intersect(a: list[tuple[float, float]],
               b: list[tuple[float, float]]) -> float:
    """Total overlap length of two interval unions (two-pointer sweep)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clip(union: list[tuple[float, float]],
          window: tuple[float, float]) -> float:
    return _intersect(union, [window])


# ---- the report -----------------------------------------------------------


def pipeline_report(records: list[dict] | None = None,
                    max_dispatches: int = 64) -> dict:
    """Overlap/bubble analysis of a record set (default: the process
    profiler's). Records spanning several ranks are analyzed PER RANK
    (each rank has its own device to keep busy) and summarized.

    Per rank: ``wall_s`` (first segment start → last end), per-stage
    totals, ``device_busy_s`` (union of device windows),
    ``bubble_fraction`` = 1 − device_busy/wall, ``overlap_s`` =
    |host ∩ device|, ``host_overlapped_fraction`` = overlap/host_busy.
    ``dispatches`` lists the newest ``max_dispatches`` with per-dispatch
    segment seconds and this dispatch's device-window overlap fraction.
    """
    if records is None:
        records = profiler().records()
    by_rank: dict[int, list[dict]] = {}
    for r in records:
        by_rank.setdefault(int(r.get("rank", 0)), []).append(r)

    ranks: dict[str, dict] = {}
    for rank in sorted(by_rank):
        recs = by_rank[rank]
        segs = [s for r in recs for s in r["segments"]]
        if not segs:
            continue
        t_lo = min(s["t0"] for s in segs)
        t_hi = max(s["t1"] for s in segs)
        wall = max(t_hi - t_lo, 1e-12)
        stage_totals = {st: 0.0 for st in STAGES}
        for s in segs:
            stage_totals.setdefault(s["stage"], 0.0)
            stage_totals[s["stage"]] += s["t1"] - s["t0"]
        device_u = _union([(s["t0"], s["t1"]) for s in segs
                           if s["stage"] == "device"])
        # Host busy = host WORK only: collective segments are fabric
        # waits (see NON_HOST_STAGES) — they must neither inflate
        # host_busy nor count as host/device overlap.
        host_u = _union([(s["t0"], s["t1"]) for s in segs
                         if s["stage"] not in NON_HOST_STAGES])
        device_busy = _length(device_u)
        host_busy = _length(host_u)
        overlap = _intersect(device_u, host_u)
        dispatches = []
        for r in recs[-max_dispatches:]:
            d_segs = {s["stage"]: round(s["t1"] - s["t0"], 6)
                      for s in r["segments"]}
            windows = [(s["t0"], s["t1"]) for s in r["segments"]
                       if s["stage"] == "device"]
            d_dev = _length(_union(windows))
            d_overlap = sum(_clip(host_u, w) for w in _union(windows))
            dispatches.append({
                "dispatch": r["dispatch"],
                "meta": r.get("meta", {}),
                "segments_s": d_segs,
                "device_s": round(d_dev, 6),
                "overlap_s": round(d_overlap, 6),
                "overlap_fraction": (round(d_overlap / d_dev, 4)
                                     if d_dev else 0.0),
            })
        ranks[str(rank)] = {
            "dispatch_count": len(recs),
            "wall_s": round(wall, 6),
            "stage_totals_s": {k: round(v, 6)
                               for k, v in stage_totals.items() if v},
            "device_busy_s": round(device_busy, 6),
            "host_busy_s": round(host_busy, 6),
            "bubble_fraction": round(1.0 - device_busy / wall, 4),
            "overlap_s": round(overlap, 6),
            "host_overlapped_fraction": (round(overlap / host_busy, 4)
                                         if host_busy else 0.0),
            "dispatches": dispatches,
        }
    if not ranks:
        return {"ranks": {}, "dispatch_count": 0, "bubble_fraction": None,
                "host_overlapped_fraction": None}
    n = len(ranks)
    return {
        "ranks": ranks,
        "dispatch_count": sum(v["dispatch_count"] for v in ranks.values()),
        # Mesh summary: mean over ranks (each rank's device is its own
        # resource; averaging answers "how idle is a typical chip").
        "bubble_fraction": round(
            sum(v["bubble_fraction"] for v in ranks.values()) / n, 4),
        "host_overlapped_fraction": round(
            sum(v["host_overlapped_fraction"] for v in ranks.values()) / n,
            4),
    }


# ---- Perfetto export ------------------------------------------------------


def to_chrome_trace(records: list[dict] | None = None) -> dict:
    """Wall-clock Chrome trace-event JSON: one process row per rank, one
    thread row per pipeline stage.

    Host stages render as complete slices (``ph: X``) — they are
    sequential on the host thread, so they nest trivially. Device
    windows render as ASYNC slices (``ph: b``/``e``, id = dispatch):
    pipelined dispatches overlap partially on the device track, and the
    trace format only allows sync slices that nest — X events here
    would make the viewer clamp/drop exactly the overlap this export
    exists to show.
    """
    if records is None:
        records = profiler().records()
    segs = [(int(r.get("rank", 0)), r["dispatch"], s)
            for r in records for s in r["segments"]]
    events: list[dict] = []
    if not segs:
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"clock": "wall",
                             "source": SOURCE}}
    epoch = min(s["t0"] for _, _, s in segs)
    ranks = sorted({rank for rank, _, _ in segs})
    for rank in ranks:
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "tid": 0, "args": {"name": f"rank {rank}"}})
        for tid, stage in enumerate(STAGES):
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": tid, "args": {"name": stage}})
    tids = {stage: i for i, stage in enumerate(STAGES)}
    for rank, dispatch, s in segs:
        stage = s["stage"]
        ts = round((s["t0"] - epoch) * 1e6, 3)
        dur = round(max(s["t1"] - s["t0"], 1e-7) * 1e6, 3)
        tid = tids.get(stage, len(STAGES))
        if stage == "device":
            # Async events pair by (cat, id) GLOBALLY — not per pid — so
            # the id must be rank-unique or rank 0's begin would pair
            # with rank 1's end (dispatch ids restart at 0 per rank).
            common = {"cat": "pipeline", "name": "device", "pid": rank,
                      "tid": tid, "id": f"r{rank}d{dispatch}",
                      "args": {"dispatch": dispatch}}
            events.append({**common, "ph": "b", "ts": ts})
            events.append({**common, "ph": "e", "ts": round(ts + dur, 3)})
        else:
            events.append({
                "ph": "X", "cat": "pipeline", "name": stage,
                "pid": rank, "tid": tid, "ts": ts, "dur": dur,
                "args": {"dispatch": dispatch},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"clock": "wall", "epoch_unix_s": epoch,
                         "source": SOURCE}}
