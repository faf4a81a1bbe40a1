"""Merge per-node causal logs into one causally consistent total order.

The port's copy of the reference's ``forensics/merge.py``. Lamport clocks
give a partial order: if event *a* happened before *b* (same node, or a
send and its receipt), then ``lamport(a) < lamport(b)``, since a receipt
merges with ``max + 1``. Sorting by ``(lamport, node, seq)`` therefore
yields a total order that extends the causal partial order: concurrent
events are tie-broken deterministically by node id, then by the per-node
sequence number. The same dump always merges to the same list; there is
no wall clock anywhere in the key.
"""
from __future__ import annotations


def _node_key(node) -> tuple:
    """Deterministic cross-type ordering: numeric node ids first (by
    value), then named pseudo-nodes ("bus") lexicographically."""
    s = str(node)
    try:
        return (0, int(s), "")
    except ValueError:
        return (1, 0, s)


def causal_sort_key(event: dict) -> tuple:
    return (event.get("lamport", 0), _node_key(event.get("node")),
            event.get("seq", 0))


def merge_events(dump: dict) -> list[dict]:
    """All events from every node's log, in one causal total order."""
    merged: list[dict] = []
    for events in dump.get("nodes", {}).values():
        merged.extend(events)
    merged.sort(key=causal_sort_key)
    return merged


def node_order(dump: dict) -> list[str]:
    """The dump's node ids in merge order (numeric first, then names)."""
    return sorted(dump.get("nodes", {}), key=_node_key)
