"""chainwatch incident capture: the non-fatal evidence path.

The port's copy of the reference's ``chainwatch/incident.py``. When a rule
fires, ``emit_incident`` does three things, none of which may hurt the run
that is still mining:

1. **Signal**: a structured ``incident`` event on the ring plus the
   ``incidents_total{rule,severity}`` counter.
2. **Record**: the open-episode table ``open_incidents()``, which the
   front door's degradation stamp reads (an open ``stale_rank`` incident
   marks responses degraded).
3. **Bundle**: when an incident directory is armed (``--incident-dir``),
   a bounded JSON evidence bundle built on ``flight_recorder.snapshot()``
   (the body the crash dump writes) plus the incident's extras: the
   pipeline records of the implicated heights, the skew-span and memory
   tails, the compile census, the door's stats and the last known mesh
   membership.

Bundles are rate-limited (at most one per rule per
``MPIBT_CHAINWATCH_BUNDLE_INTERVAL`` seconds) and capped
(``MPIBT_CHAINWATCH_BUNDLE_CAP`` per process). Every write is atomic (tmp +
replace) and every failure goes to stderr: incident capture must never
become the incident.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import threading
import time

from ..telemetry.events import env_number

#: Every key an incident bundle carries, the schema the smoke and the
#: tests pin. The first block is the shared ``flight_recorder.snapshot``
#: body; the second is the incident overlay.
BUNDLE_KEYS = (
    # shared snapshot body (telemetry/flight_recorder.snapshot)
    "artifact", "reason", "traceback", "wall_time", "pid", "argv",
    "context", "events", "causal", "metrics", "spans",
    # incident overlay
    "rule", "severity", "detail", "heights", "incident_seq",
    "opened_at", "blocktrace", "skew_spans", "memory", "mesh",
    "compiles", "service",
)

#: Bounded tails carried by a bundle (events/causal/spans come from
#: snapshot()'s own last_n; these bound the incident extras).
RECORDS_TAIL_N = 64

_lock = threading.Lock()
_state: dict = {
    "dir": None,               # pathlib.Path | None — bundles armed?
    "seq": 0,                  # incidents this process, lifetime
    "bundles": 0,              # bundles written (cap accounting)
    "last_bundle": {},         # rule -> monotonic time of last bundle
    "open": [],                # open episodes, oldest first
    "mesh": None,              # last known membership (notify_mesh)
}


def configure(directory=None) -> None:
    """(Re)arm the bundle directory; None disarms bundles (events and
    counters still fire). Called by ``chainwatch.install``."""
    with _lock:
        _state["dir"] = (pathlib.Path(directory)
                         if directory is not None else None)


def reset() -> None:
    """Full state reset (test isolation / uninstall)."""
    with _lock:
        _state.update(dir=None, seq=0, bundles=0, last_bundle={},
                      open=[], mesh=None)


def bundle_dir():
    with _lock:
        return _state["dir"]


def notify_mesh(membership: dict) -> None:
    """Records the last known mesh membership (``notify_eviction`` feeds
    this) so bundles can carry it."""
    with _lock:
        _state["mesh"] = dict(membership)


def open_incidents() -> list[dict]:
    """Copies of the currently open incident episodes (the front door's
    degradation stamp reads these)."""
    with _lock:
        return [dict(i) for i in _state["open"]]


def close_incident(rule: str) -> None:
    """Drop ``rule``'s episode from the open table (its hysteresis
    cleared). The counter and any written bundle remain — closing is a
    live-view operation, not a retraction."""
    with _lock:
        _state["open"] = [i for i in _state["open"] if i["rule"] != rule]


def incident_count() -> int:
    """Incidents fired by this process so far (lifetime, not open)."""
    with _lock:
        return _state["seq"]


def emit_incident(*, rule: str, severity: str, detail: dict | None = None,
                  heights: tuple | list = (), source: str = "") -> dict:
    """Fire one incident: event + counter + open-table entry + (armed,
    rate-limited, capped) evidence bundle. Returns the incident record.
    ``rule=`` and ``severity=`` are keyword-only."""
    from ..telemetry import counter
    from ..telemetry.events import emit_event

    detail = dict(detail or {})
    heights = sorted({int(h) for h in heights})
    with _lock:
        _state["seq"] += 1
        seq = _state["seq"]
    record = {"rule": rule, "severity": severity, "detail": detail,
              "heights": heights, "incident_seq": seq,
              "opened_at": time.time(), "source": source}
    counter("incidents_total",
            help="chainwatch incidents fired, by rule and severity",
            rule=rule, severity=severity).inc()
    emit_event({"event": "incident", **record})
    with _lock:
        # One open entry per rule: the rule's hysteresis guarantees one
        # firing per episode, so a duplicate means a fresh episode —
        # replace, keeping the table bounded by the rule catalogue.
        _state["open"] = ([i for i in _state["open"]
                           if i["rule"] != rule] + [dict(record)])
    path = _write_bundle(record)
    if path is not None:
        record["bundle"] = str(path)
    return record


def _write_bundle(record: dict):
    """The rate-limited, capped, atomic bundle write; None when
    disarmed, throttled, capped, or failed (failure prints, never
    raises — the run keeps mining)."""
    min_interval = env_number("MPIBT_CHAINWATCH_BUNDLE_INTERVAL", 30.0,
                              cast=float, minimum=0)
    cap = env_number("MPIBT_CHAINWATCH_BUNDLE_CAP", 8, cast=int,
                     minimum=1)
    now = time.monotonic()
    with _lock:
        directory = _state["dir"]
        if directory is None:
            return None
        if _state["bundles"] >= cap:
            return None
        last = _state["last_bundle"].get(record["rule"])
        if last is not None and now - last < min_interval:
            return None
        _state["last_bundle"][record["rule"]] = now
        _state["bundles"] += 1
        seq = record["incident_seq"]
    try:
        payload = build_bundle(record)
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / f"incident_{seq:04d}_{record['rule']}.json"
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload, sort_keys=True, default=str))
        tmp.replace(path)
        return path
    except Exception as e:
        print(f"chainwatch bundle write failed: {e}", file=sys.stderr)
        return None


def build_bundle(record: dict) -> dict:
    """The bundle payload: ``flight_recorder.snapshot()`` (the shared
    evidence body) overlaid with the incident record and its extras.
    Pure builder — no I/O — so tests can pin the schema directly."""
    from ..dispatchwatch import compile_snapshot
    from ..meshprof.memory import memory_snapshot
    from ..meshprof.spans import SKEW_TAIL_N, spans_tail
    from ..meshwatch.pipeline import profiler
    from ..service import service_stats
    from ..telemetry import flight_recorder, mesh_rank

    heights = set(record.get("heights", ()))
    records = profiler().records(tail=RECORDS_TAIL_N)
    if heights:
        # Implicated-height filter: keep dispatches whose meta or any
        # segment is stamped with one of the heights; fall back to the
        # whole tail when nothing matches (evidence beats emptiness).
        hit = [r for r in records
               if r.get("meta", {}).get("height") in heights
               or any(s.get("height") in heights
                      for s in r.get("segments", ()))]
        records = hit or records
    mesh = _state["mesh"]
    payload = flight_recorder.snapshot(
        f"incident:{record['rule']}", tb=None)
    payload.update({
        "artifact": "incident",
        "rule": record["rule"],
        "severity": record["severity"],
        "detail": record["detail"],
        "heights": sorted(heights),
        "incident_seq": record["incident_seq"],
        "opened_at": record["opened_at"],
        "blocktrace": records,
        "skew_spans": spans_tail(SKEW_TAIL_N),
        "memory": memory_snapshot(),
        "mesh": dict(mesh) if mesh else {"rank": mesh_rank(),
                                         "world_size": int(os.environ.get(
                                             "MPIBT_MESH_WORLD", 1))},
        "compiles": compile_snapshot(),
        # The front door's stats at fire time ({} with no door): a
        # mempool_saturation bundle carries the pool it indicts.
        "service": service_stats(),
    })
    return payload
