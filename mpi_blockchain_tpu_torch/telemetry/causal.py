"""Causal (Lamport-clock) event logs of the simulation.

The port's copy of the reference's ``telemetry/causal.py``, byte for byte
in what it writes: a dump of the same run is the same file in both
packages.

The metrics registry sees *how much* happened; these logs see *in what
order* it happened across nodes. Every simulation-bus interaction (mine,
send, deliver, drop, partition-defer, sync, adopt) is stamped with a
Lamport logical clock (Lamport 1978: local events tick the clock, message
receipt merges the sender's stamp with ``max + 1``), so the per-node logs
can later be merged into one causally consistent total order with no
wall-clock assumptions.

* **Deterministic.** Records carry no wall-clock time, only the Lamport
  stamp, a per-node sequence number and the simulation step. Two runs
  with the same seed produce byte-identical logs.
* **Bounded.** Each node's log is a ring of ``events.EVENT_RING_SIZE``
  records (env ``MPIBT_EVENT_BUFFER``).
* **Quiet.** Records go into the per-node ring only, not through the
  JSON-lines logger. The flight recorder and ``sim --events-dump`` are
  the export paths.
* **Standard library only, thread-safe.** Every clock and ring mutation
  takes a lock.
"""
from __future__ import annotations

import collections
import json
import pathlib
import threading

from .events import EVENT_RING_SIZE

DUMP_VERSION = 1


class LamportClock:
    """A Lamport logical clock: ``tick()`` for local events, ``merge()``
    on message receipt. Strictly monotonic per clock by construction."""

    def __init__(self) -> None:
        self._t = 0
        self._lock = threading.Lock()

    @property
    def time(self) -> int:
        with self._lock:
            return self._t

    def tick(self) -> int:
        """Advance for a local event; returns the new time."""
        with self._lock:
            self._t += 1
            return self._t

    def merge(self, remote: int) -> int:
        """Advance past a received stamp: ``max(local, remote) + 1``."""
        with self._lock:
            self._t = max(self._t, int(remote)) + 1
            return self._t


class CausalLog:
    """One node's bounded causal event log + its Lamport clock.

    ``record(kind, ...)`` stamps every event with ``node``, ``lamport``
    and a per-node ``seq`` (the merge tie-breaker), plus the simulation
    ``step`` and any kind-specific fields the caller adds. Passing
    ``merge=<sender stamp>`` models message receipt (clock merge);
    omitting it models a local event (clock tick).
    """

    def __init__(self, node_id, capacity: int | None = None):
        self.node_id = node_id
        self.clock = LamportClock()
        self._events: collections.deque = collections.deque(
            maxlen=capacity if capacity is not None else EVENT_RING_SIZE)
        self._seq = 0
        self._lock = threading.Lock()

    def record(self, kind: str, *, merge: int | None = None,
               step: int = 0, **fields) -> dict:
        """Stamp + ring one causal event; returns the record (callers
        thread its ``lamport`` into outbound messages)."""
        lamport = (self.clock.merge(merge) if merge is not None
                   else self.clock.tick())
        with self._lock:
            rec = {"node": self.node_id, "lamport": lamport,
                   "seq": self._seq, "step": step, "kind": kind, **fields}
            self._seq += 1
            self._events.append(rec)
        return rec

    def events(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._events]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0


def dump_causal_logs(logs, path, meta: dict | None = None) -> pathlib.Path:
    """Write per-node causal logs as ONE JSON artifact.

    Format (the input of the reference's forensics reader):

        {"version": 1, "meta": {...},
         "nodes": {"<node_id>": [event, ...], ...}}
    """
    path = pathlib.Path(path)
    payload = {
        "version": DUMP_VERSION,
        "meta": dict(meta or {}),
        "nodes": {str(log.node_id): log.events() for log in logs},
    }
    path.write_text(json.dumps(payload, sort_keys=True, default=str))
    return path


def load_causal_dump(path) -> dict:
    """Read a ``dump_causal_logs`` artifact, validating its shape."""
    payload = json.loads(pathlib.Path(path).read_text())
    if not isinstance(payload, dict) or "nodes" not in payload:
        raise ValueError(f"{path}: not a causal event dump "
                         f"(missing 'nodes' key)")
    if not isinstance(payload["nodes"], dict):
        raise ValueError(f"{path}: 'nodes' must map node id -> event list")
    return payload
