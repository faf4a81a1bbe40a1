"""JSON-lines event stream.

One structured dict per notable occurrence (fault injected, retry,
backend degraded, checkpoint saved or truncated, ...), written as a JSON
line at INFO to the ``mpi_blockchain_tpu_torch.events`` logger, which
prints to stderr. Events are also kept in a bounded in-process ring so
tests and the smoke gates can inspect what a run emitted without scraping
log output; ``MPIBT_EVENT_BUFFER`` sets the ring's size (default 2048).

The port's copy of the reference's ``telemetry/events.py``. The reference
stamps each record with the block it belongs to (blocktrace); blocktrace
is not ported, so records carry no ``trace`` field here.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import threading
import warnings

_DEFAULT_RING_SIZE = 2048
_LOGGER_NAME = "mpi_blockchain_tpu_torch.events"


def env_number(name: str, default, cast=int, minimum=1):
    """Parses a numeric environment knob: warns and falls back to the
    default on a malformed or out-of-range value, so a knob is never the
    thing that crashes a run. ``not v >= minimum`` also rejects NaN."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        v = cast(raw)
    except ValueError:
        v = None
    if v is None or not v >= minimum:
        warnings.warn(f"{name}={raw!r} is not a number >= {minimum}; "
                      f"using default {default}", RuntimeWarning,
                      stacklevel=2)
        return default
    return v


EVENT_RING_SIZE = env_number("MPIBT_EVENT_BUFFER", _DEFAULT_RING_SIZE)

_ring: collections.deque = collections.deque(maxlen=EVENT_RING_SIZE)
_lock = threading.Lock()


def get_logger() -> logging.Logger:
    """The events logger: JSON lines at INFO on stderr, not propagated (so
    a ``--verbose`` root handler does not print them twice)."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def emit_event(record: dict) -> None:
    """Emits one structured event as a JSON line (INFO) and rings it."""
    record = dict(record)
    with _lock:
        _ring.append(dict(record))
    get_logger().info(json.dumps(record, sort_keys=True, default=str))


def recent_events(n: int | None = None,
                  event: str | None = None) -> list[dict]:
    """The last n ringed events (all by default), newest last; ``event``
    filters on the record's "event" field."""
    with _lock:
        out = list(_ring)
    if event is not None:
        out = [r for r in out if r.get("event") == event]
    if n is not None:
        out = out[-n:]
    return out


def clear_events() -> None:
    """Empties the ring."""
    with _lock:
        _ring.clear()
