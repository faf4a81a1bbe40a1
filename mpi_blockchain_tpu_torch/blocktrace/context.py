"""The block trace context: a (height, template, rank) identity stamped
through every layer a block goes through.

``trace_block(height, template=...)`` pushes one frame on a thread-local
stack (each thread traces its own block, as the span stack does). The
innermost frame is what the telemetry layer consults:

* ``meshwatch.pipeline.DispatchRecord.add_segment`` stamps the frame's
  ``height``/``template`` onto every segment recorded in scope;
* ``telemetry.events.emit_event`` attaches a ``trace`` dict to every
  event emitted in scope (unless the record already carries one);
* ``PipelineProfiler.dispatch`` takes its meta's ``height`` from the
  frame when the call site passed none.

``template`` is the per-height template counter: the extra-nonce
rollover index of the per-block miner. ``rank`` defaults to the
process's mesh rank (``telemetry.set_mesh_rank``).

Standard library only, in memory only.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

from .. import telemetry
from ..telemetry import registry as _registry

_tls = threading.local()


class BlockTrace(NamedTuple):
    """One block's trace identity (immutable; a named tuple, which costs
    the block's frame less than a frozen dataclass does)."""
    height: int
    template: int = 0
    rank: int = 0

    def to_dict(self) -> dict:
        return {"height": self.height, "template": self.template,
                "rank": self.rank}


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_trace() -> BlockTrace | None:
    """The innermost open block trace on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def trace_dict() -> dict | None:
    """The innermost trace as a JSON-able dict, or None when no block is
    in scope: the stamp ``emit_event`` attaches."""
    t = current_trace()
    return None if t is None else t.to_dict()


class trace_block:
    """``with trace_block(height, template=..., rank=...) as frame:``
    declares everything inside as work on block ``height``.

    ``template`` defaults to the enclosing frame's template when
    re-entering the same height (the miner pushes an outer frame for the
    height, then one per extra-nonce template inside), else 0; ``rank``
    defaults to the process's mesh rank.

    With ``MPIBT_TELEMETRY_OFF`` the frame is None and nothing is pushed:
    the context is itself instrumentation, and the overhead audit's off
    leg must not pay for it. A class, not a generator: it runs several
    times a block."""

    __slots__ = ("height", "template", "rank", "_frame")

    def __init__(self, height: int, template: int | None = None,
                 rank: int | None = None):
        self.height, self.template, self.rank = height, template, rank
        self._frame = None

    def __enter__(self) -> BlockTrace | None:
        if _registry._telemetry_off:
            return None
        stack = _stack()
        template = self.template
        if template is None:
            parent = stack[-1] if stack else None
            template = (parent.template
                        if parent is not None and parent.height == self.height
                        else 0)
        frame = self._frame = BlockTrace(
            int(self.height), int(template),
            int(self.rank if self.rank is not None
                else telemetry._mesh_rank))
        stack.append(frame)
        return frame

    def __exit__(self, *exc) -> bool:
        if self._frame is not None:
            _stack().pop()
            self._frame = None
        return False
