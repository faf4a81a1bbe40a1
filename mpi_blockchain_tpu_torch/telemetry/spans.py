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
/ ``backend.tpu.host_tail``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time

from .registry import Registry, default_registry, telemetry_disabled

_tls = threading.local()


@dataclasses.dataclass
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


def _profiler_range(name: str):
    """``torch.profiler.record_function(name)`` while PyTorch's profiler is
    recording, else a null context. Only a process that imported torch
    can be profiling, so nothing is imported here."""
    torch = sys.modules.get("torch")
    if torch is None or not getattr(torch.autograd.profiler,
                                    "_is_profiler_enabled", False):
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, registry: Registry | None = None, **attrs):
    """Context manager timing one named host-side operation."""
    if telemetry_disabled():
        # No clock reads, no stack push, nothing filed.
        yield _NULL_SPAN
        return
    stack = _stack()
    parent = stack[-1].name if stack else None
    s = Span(name=name, parent=parent, depth=len(stack), attrs=attrs)
    stack.append(s)
    t0 = time.perf_counter()
    try:
        with _profiler_range(name):
            yield s
    finally:
        s.duration_s = time.perf_counter() - t0
        stack.pop()
        (registry if registry is not None
         else default_registry()).record_span(s)
