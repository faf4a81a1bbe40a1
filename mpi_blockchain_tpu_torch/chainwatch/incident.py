"""The open-incident table of the reference's ``chainwatch/incident.py``.

The reference's rules open an episode here when they fire and close it
when their hysteresis clears; ``/healthz``, the mesh shards and the front
door's degradation stamp (``ServiceState.degraded_info``: an open
``stale_rank`` incident marks responses degraded) read it. The rules,
``emit_incident`` and the evidence bundles wait for a later slice of the
port, so in the port the table stays empty unless something puts an
episode into it; its readers keep the reference's shape.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()
_state: dict = {
    "seq": 0,                  # incidents this process, lifetime
    "open": [],                # open episodes, oldest first
}


def reset() -> None:
    """Full state reset (test isolation)."""
    with _lock:
        _state.update(seq=0, open=[])


def open_incidents() -> list[dict]:
    """Copies of the currently open incident episodes."""
    with _lock:
        return [dict(i) for i in _state["open"]]


def close_incident(rule: str) -> None:
    """Drops ``rule``'s episode from the open table."""
    with _lock:
        _state["open"] = [i for i in _state["open"] if i["rule"] != rule]


def incident_count() -> int:
    """Incidents fired by this process so far (lifetime, not open)."""
    with _lock:
        return _state["seq"]
