"""Structured logging: the port's copy of the reference's
``utils/logging.py``.

The reference's std::cout prints become JSON-lines records: one dict per
mined block {height, nonce, hash, wall_ms, hashes_tried}, emitted through
Python logging so callers can redirect or silence them. Both helpers
delegate to the telemetry event stream (``telemetry.events``), as the
reference's do.
"""
from __future__ import annotations

import logging
from typing import Callable


def get_logger() -> logging.Logger:
    """The logger the JSON-lines records go to (INFO, on stderr, not
    propagated): ``telemetry.events.get_logger``'s."""
    from ..telemetry.events import get_logger as events_logger

    return events_logger()


def block_logger() -> Callable[[dict], None]:
    """Returns a callable that logs one structured record as a JSON line:
    the telemetry event stream's ``emit_event``, which logs at INFO, the
    level ``get_logger()`` enables, and rings the record."""
    from ..telemetry.events import emit_event

    return emit_event
