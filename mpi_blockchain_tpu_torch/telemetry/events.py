"""JSON-lines event stream.

One structured dict per notable occurrence (fault injected, retry,
backend degraded, checkpoint saved or truncated, ...), written as a JSON
line at INFO to the ``mpi_blockchain_tpu_torch.events`` logger, which
prints to stderr. Events are also kept in a bounded in-process ring so
tests and the smoke gates can inspect what a run emitted without scraping
log output; ``MPIBT_EVENT_BUFFER`` sets the ring's size (default 2048).
Each ringed record is paired with a process-lifetime sequence number, the
cursor of perfwatch's ``/events?since=SEQ``.

The port's copy of the reference's ``telemetry/events.py``. Inside a
``blocktrace.trace_block`` scope each record is stamped with the block it
belongs to (a ``trace`` field), and with ``MPIBT_TELEMETRY_OFF`` nothing
is emitted, as in the reference.
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

# (seq, record) pairs. The seq never resets, not even in clear_events, so
# a poller's cursor stays valid; the records themselves carry no seq.
_ring: collections.deque = collections.deque(maxlen=EVENT_RING_SIZE)
_lock = threading.Lock()
_seq = 0


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
    """Emits one structured event as a JSON line (INFO) and rings it.

    Inside a ``blocktrace.trace_block`` scope the record is stamped with a
    ``trace`` dict (height/template/rank) unless it already carries one,
    so retry, degradation and checkpoint events join the block that paid
    for them. With ``MPIBT_TELEMETRY_OFF`` the event is dropped (the
    overhead audit's off leg)."""
    from ..blocktrace.context import trace_dict
    from .registry import telemetry_disabled

    global _seq
    if telemetry_disabled():
        return
    record = dict(record)
    if "trace" not in record:
        trace = trace_dict()
        if trace is not None:
            record["trace"] = trace
    with _lock:
        _seq += 1
        _ring.append((_seq, dict(record)))
    get_logger().info(json.dumps(record, sort_keys=True, default=str))


def recent_events(n: int | None = None,
                  event: str | None = None) -> list[dict]:
    """The last n ringed events (all by default), newest last; ``event``
    filters on the record's "event" field."""
    return [r for _, r in recent_with_seq(n=n, event=event)]


def recent_with_seq(n: int | None = None, since: int | None = None,
                    event: str | None = None) -> list[tuple[int, dict]]:
    """Like ``recent_events``, each record paired with its seq; ``since``
    keeps only records with ``seq > since``. ``n`` bounds the reply: the
    newest n without a cursor, the oldest n with one, because a paging
    poller advances its cursor past what it received (newest-first would
    skip the middle of a burst for good). Records older than the ring's
    bound are gone either way."""
    with _lock:
        out = list(_ring)
    if since is not None:
        out = [(s, r) for s, r in out if s > since]
    if event is not None:
        out = [(s, r) for s, r in out if r.get("event") == event]
    if n is not None:
        out = out[:n] if since is not None else out[-n:]
    return out


def latest_seq() -> int:
    """The seq of the newest emitted event (0 before any)."""
    with _lock:
        return _seq


def clear_events() -> None:
    """Empties the ring; the seq keeps counting."""
    with _lock:
        _ring.clear()
