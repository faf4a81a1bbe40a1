"""Merged causal order as Chrome trace-event JSON (Perfetto-viewable).

The port's copy of the reference's ``forensics/trace_export.py``; the one
difference is the ``metadata.source`` string, which names this package.
The timeline axis is logical time: ``ts = lamport * TICK_US``. The causal
logs carry no wall clock, and for consensus forensics the interesting
axis is happened-before, not microseconds. Each node renders as its own
process row (the bus pseudo-node included), every event as a short
complete slice, and every announcement as a flow arrow from its send to
each deliver (load the file at ui.perfetto.dev, or chrome://tracing).
"""
from __future__ import annotations

from .merge import _node_key

TICK_US = 10          # microseconds of timeline per Lamport tick
SLICE_US = 8          # slice width; < TICK_US so consecutive ticks split


def _pid(node) -> int:
    """Stable numeric pid per node: numeric ids map to id+1, pseudo-nodes
    ("bus") to 0 so the bus row sorts first."""
    try:
        return int(str(node)) + 1
    except ValueError:
        return 0


def to_chrome_trace(merged: list[dict]) -> dict:
    """Trace-event JSON (object form) for one merged causal order."""
    events: list[dict] = []
    nodes = sorted({e.get("node") for e in merged}, key=_node_key)
    for node in nodes:
        events.append({"ph": "M", "name": "process_name",
                       "pid": _pid(node), "tid": 0,
                       "args": {"name": f"node {node}"}})
    sends: dict[str, dict] = {}
    for e in merged:
        if e.get("kind") == "send" and e.get("hash") not in sends:
            sends[e["hash"]] = e
    for e in merged:
        args = {k: v for k, v in e.items()
                if k not in ("kind", "node", "lamport")}
        ts = e.get("lamport", 0) * TICK_US
        pid = _pid(e.get("node"))
        events.append({"ph": "X", "cat": "sim", "name": e.get("kind", "?"),
                       "ts": ts, "dur": SLICE_US, "pid": pid, "tid": 0,
                       "args": args})
        # Flow arrows: send -> every deliver of the same announcement.
        if e.get("kind") == "send":
            events.append({"ph": "s", "cat": "announce", "id": e["hash"],
                           "name": "announce", "ts": ts, "pid": pid,
                           "tid": 0})
        elif e.get("kind") == "deliver" and e.get("hash") in sends:
            events.append({"ph": "f", "bp": "e", "cat": "announce",
                           "id": e["hash"], "name": "announce",
                           "ts": ts, "pid": pid, "tid": 0})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"clock": "lamport",
                         "tick_us": TICK_US,
                         "source": "mpi_blockchain_tpu_torch.forensics"}}
