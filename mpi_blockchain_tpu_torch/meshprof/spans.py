"""Rendezvous skew spans: per-site monotonic enter/exit stamps.

The port's copy of the reference's ``meshprof/spans.py``. Every rank
wraps its collective-boundary waits in ``skew_span(site=...)`` (``site``
is keyword-only: a span without one cannot be joined across ranks). Each
span records:

* ``site``: the collective site label (``mesh.sweep`` for the
  winner-select round of ``backend/cuda.py``);
* ``round``: a per-site increasing local index, assigned at enter. Every
  rank passes the same sites in the same order, so (site, round) is the
  cross-rank join key;
* ``t_enter`` / ``t_exit``: wall-anchored monotonic floats (one anchor
  per process, the ``meshwatch.pipeline`` convention);
* ``height`` / ``template``: from the in-scope ``blocktrace.trace_block``
  frame, so skew joins to blocks;
* ``ok``: False when the wait raised.

Spans land in a bounded process-global ring (``spans_tail``; incident
bundles carry it). Standard library only; records nothing under
``MPIBT_TELEMETRY_OFF``.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..blocktrace.context import _tls as _trace_tls
from ..telemetry import registry as _registry

#: Ring capacity — same order as the pipeline profiler's record ring.
SKEW_RING_SIZE = 4096
#: Newest spans an incident bundle carries.
SKEW_TAIL_N = 256

# One anchor per process: time.time() sampled once against perf_counter,
# so stamps are monotonic (perf_counter) yet wall-scaled (the convention
# of PipelineProfiler._anchor: the two timelines lie on one axis).
_ANCHOR = time.time() - time.perf_counter()


def wall_now() -> float:
    """Wall-anchored monotonic now — the span timestamp base."""
    return _ANCHOR + time.perf_counter()


_lock = threading.Lock()
_ring: deque = deque(maxlen=SKEW_RING_SIZE)
_rounds: dict[str, int] = {}


class skew_span:
    """``with skew_span(site="mesh.sweep"): <rendezvous wait>``, the one
    skew-span idiom (``site=`` is keyword-only). Records nothing under
    ``MPIBT_TELEMETRY_OFF``."""

    __slots__ = ("site", "_round", "_t0", "_armed")

    def __init__(self, *, site: str):
        self.site = str(site)
        self._armed = not _registry._telemetry_off
        self._round = 0
        self._t0 = 0.0

    def __enter__(self):
        if not self._armed:
            return self
        # Round index assigned at ENTER: two ranks inside the same
        # rendezvous agree on the round even if their exits interleave.
        with _lock:
            n = _rounds.get(self.site, 0)
            _rounds[self.site] = n + 1
        self._round = n
        self._t0 = _ANCHOR + time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._armed:
            return False
        rec = {"site": self.site, "round": self._round,
               "t_enter": self._t0, "t_exit": _ANCHOR + time.perf_counter(),
               "ok": exc_type is None}
        stack = getattr(_trace_tls, "stack", None)
        if stack:
            trace = stack[-1]
            rec["height"] = trace.height
            if trace.template:
                rec["template"] = trace.template
        with _lock:
            _ring.append(rec)
        return False


def spans_tail(n: int = SKEW_TAIL_N) -> list[dict]:
    """Copies of the newest ``n`` spans (copies: a bundle writer
    serializes them while the ring moves on)."""
    with _lock:
        recs = list(_ring)[-n:] if n is not None else list(_ring)
    return [dict(r) for r in recs]


def clear_spans() -> None:
    """Empty the ring and reset every site's round counter (test/CLI
    isolation — a fresh measurement must join rounds from zero)."""
    with _lock:
        _ring.clear()
        _rounds.clear()
