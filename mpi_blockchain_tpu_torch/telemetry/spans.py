"""Lightweight span tracing: monotonic-clock spans with parent nesting.

The port's copy of the reference's ``telemetry/spans.py``. A span is a
named wall-clock interval around host-side work:

    with span("miner.sweep", height=h):
        res = future.result()

Spans nest through a thread-local stack (each thread traces its own tree),
carry their parent's name and depth, and on exit are filed with the
default registry: appended to the bounded span log and mirrored into the
``span_seconds`` summary labeled by span name.

Profiler bridge: while PyTorch's profiler is recording, every span also
enters ``torch.profiler.record_function``, so the host spans nest inside
the profiler's timeline beside the card's kernels (the reference enters a
``jax.profiler.TraceAnnotation`` while its perfetto capture is on). When
no profiler records, the bridge costs one check and imports nothing.

With the kill switch on (``set_telemetry_disabled`` or
``MPIBT_TELEMETRY_OFF``) a span yields and records nothing.

Names are the reference's dotted ``layer.operation`` names:
``miner.block``, ``miner.sweep``, ``miner.append``, ``fused.dispatch``,
``backend.cpu.search``, and ``backend.cuda.dispatch`` /
``backend.cuda.host_tail``, the counterparts of ``backend.tpu.dispatch``
/ ``backend.tpu.host_tail``. Seven more are the port's own, around host
work that would otherwise fall between spans while the card waits:
``fused.inputs`` (a k-block call's payloads and digests) and
``fused.validate`` (its blocks' validation and append), ``miner.issue``
(a sweep's record, candidate and launch) and ``miner.window`` (the
consume's record of its device window), ``backend.cuda.midstate`` and
``backend.cuda.launch`` (the two halves of ``backend.cuda.dispatch``),
and, in both miners, ``blocktrace.observe`` around the critical-path
observation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time

from . import registry as _registry
from .registry import Registry

_tls = threading.local()
_new = object.__new__


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    parent: str | None = None
    depth: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    duration_s: float | None = None

    def to_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent,
                "depth": self.depth, "attrs": dict(self.attrs),
                "duration_s": self.duration_s}


#: The span yielded while telemetry is off: attribute-compatible, shared,
#: never filed.
_NULL_SPAN = Span(name="telemetry-off")


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def active_span() -> Span | None:
    """The innermost open span on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


#: What ``_profiler_range`` gives while no profiler records: one shared
#: null context, which a span neither enters nor leaves.
_NO_RANGE = contextlib.nullcontext()


#: ``torch.autograd.profiler`` once torch is imported (its
#: ``_is_profiler_enabled`` says whether a profiler records).
_autograd_profiler = None


def _profiler_range(name: str):
    """``torch.profiler.record_function(name)`` while PyTorch's profiler is
    recording, else a null context. Only a process that imported torch
    can be profiling, so nothing is imported here."""
    global _autograd_profiler
    if _autograd_profiler is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return _NO_RANGE
        _autograd_profiler = torch.autograd.profiler
    if not getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return _NO_RANGE
    return sys.modules["torch"].profiler.record_function(name)


class span:
    """Context manager timing one named host-side operation: ``with
    span(name, **attrs) as s:``. A class, not a generator: it runs
    several times a block."""

    __slots__ = ("_name", "_registry", "_attrs", "_span", "_t0", "_range",
                 "_stack")

    def __init__(self, name: str, registry: Registry | None = None,
                 **attrs):
        self._name, self._registry, self._attrs = name, registry, attrs
        self._span = None

    def __enter__(self) -> Span:
        if _registry._telemetry_off:
            # No clock reads, no stack push, nothing filed.
            return _NULL_SPAN
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._stack = stack
        # ``Span(name, parent, depth, attrs)`` without the dataclass's
        # ``__init__`` frame.
        s = self._span = _new(Span)
        s.name, s.parent, s.depth, s.attrs, s.duration_s = (
            self._name, stack[-1].name if stack else None, len(stack),
            self._attrs, None)
        stack.append(s)
        # ``_profiler_range``'s answer while no profiler records, without
        # its call.
        ap = _autograd_profiler
        r = self._range = (
            _NO_RANGE if ap is not None
            and not getattr(ap, "_is_profiler_enabled", False)
            else _profiler_range(self._name))
        self._t0 = time.perf_counter()
        if r is not _NO_RANGE:
            r.__enter__()
        return s

    def __exit__(self, *exc) -> bool:
        s = self._span
        if s is None:
            return False
        try:
            if self._range is not _NO_RANGE:
                self._range.__exit__(*exc)
        finally:
            s.duration_s = time.perf_counter() - self._t0
            self._stack.pop()
            self._span = None
            reg = (self._registry if self._registry is not None
                   else _registry._default)
            # ``Registry.record_span`` without its frame once the span's
            # summary exists: the log, then the summary.
            hist = reg._span_hists.get(s.name)
            if hist is None:
                reg.record_span(s)
            else:
                reg._spans.append(s)
                hist.observe(s.duration_s)
        return False
