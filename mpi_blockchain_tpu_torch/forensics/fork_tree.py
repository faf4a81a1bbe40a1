"""Fork-tree reconstruction, reorg audit, convergence statistics.

The port's copy of the reference's ``forensics/fork_tree.py``. All inputs
are merged causal events (``merge.merge_events``); all outputs are plain
JSON-able dicts whose content is a pure function of the dump.

Event vocabulary consumed here (emitted by ``simulation.py`` and the
scenario engine):

* ``mine``   {hash, prev, height}            -- defines a block
* ``send``   {hash, deliver_step}            -- announcement enqueued
* ``deliver`` {hash, sender, result}         -- announcement received
* ``drop`` / ``defer`` {hash, sender, receiver} -- bus loss events
* ``adopt``  {old_tip, new_tip, adopted, rolled_back,
  rolled_back_hashes} -- suffix adoption (rolled_back > 0 is a reorg)
"""
from __future__ import annotations

from .merge import _node_key


def build_fork_tree(merged: list[dict]) -> dict:
    """The block DAG + per-node tip history distilled from the events.

    ``mine`` events define blocks (hash -> prev edges); replaying each
    node's mine/deliver/adopt events yields its final tip. The canonical
    chain is walked back from the agreed tip (converged run) or from the
    highest final tip (tie-broken lexicographically); every known block
    off that chain is orphaned: reorged away or never adopted.
    """
    blocks: dict[str, dict] = {}
    children: dict[str, list[str]] = {}
    tips: dict[str, str] = {}
    heights: dict[str, int] = {}
    for e in merged:
        kind = e.get("kind")
        node = str(e.get("node"))
        if kind == "mine":
            h = e["hash"]
            blocks[h] = {"prev": e.get("prev"), "height": e.get("height"),
                         "miner": e.get("node"), "lamport": e.get("lamport"),
                         "step": e.get("step")}
            children.setdefault(e.get("prev"), []).append(h)
            tips[node] = h
            heights[node] = e.get("height", 0)
        elif kind == "deliver" and e.get("result") == "appended":
            tips[node] = e["hash"]
            heights[node] = e.get("height", 0)
        elif kind == "adopt":
            tips[node] = e["new_tip"]
            heights[node] = e.get("height", 0)
    for sibs in children.values():
        sibs.sort(key=lambda h: (blocks[h]["height"], h))

    final_tips = sorted(set(tips.values()))
    converged = len(final_tips) == 1
    canonical_tip = None
    if tips:
        # Converged: the shared tip. Not converged: highest final tip
        # (deterministic: height desc, then hash) so the audit still has
        # a reference chain to diff the losers against.
        tip_height = {t: max(heights.get(n, 0)
                             for n in tips if tips[n] == t)
                      for t in final_tips}
        canonical_tip = sorted(final_tips,
                               key=lambda t: (-tip_height[t], t))[0]
    canonical: list[str] = []
    seen: set[str] = set()
    h = canonical_tip
    while h in blocks and h not in seen:   # seen-guard: corrupt dumps
        canonical.append(h)
        seen.add(h)
        h = blocks[h]["prev"]
    canonical.reverse()
    orphaned = sorted(set(blocks) - set(canonical))
    fork_points = {prev: sibs for prev, sibs in sorted(children.items())
                   if len(sibs) > 1}
    return {
        "blocks": {h: blocks[h] for h in sorted(blocks)},
        "fork_points": fork_points,
        "tips": {n: tips[n] for n in sorted(tips, key=_node_key)},
        "canonical_tip": canonical_tip,
        "canonical_chain": canonical,
        "orphaned": orphaned,
        "converged": converged,
    }


def _winning_suffix(tree: dict, new_tip: str, adopted: int) -> list[str]:
    """The (up to ``adopted``-long) chain suffix ending at new_tip, as far
    back as the mine events recorded it: the blocks the loser had to
    take on when it healed."""
    out: list[str] = []
    blocks = tree["blocks"]
    h = new_tip
    while h in blocks and len(out) < adopted:
        out.append(h)
        h = blocks[h]["prev"]
    out.reverse()
    return out


def reorg_audit(merged: list[dict], tree: dict) -> list[dict]:
    """One audit entry per reorg: who healed, from which suffix, and
    whether bus losses (drops / partition deferrals) of the winning
    blocks' announcements to that node explain why it forked at all."""
    losses: dict[tuple, list[dict]] = {}
    for e in merged:
        if e.get("kind") in ("drop", "defer"):
            key = (str(e.get("receiver")), e.get("hash"))
            losses.setdefault(key, []).append(
                {"kind": e["kind"], "step": e.get("step"),
                 "sender": e.get("sender")})
    audits: list[dict] = []
    for e in merged:
        if e.get("kind") != "adopt" or not e.get("rolled_back"):
            continue
        node = str(e.get("node"))
        suffix = _winning_suffix(tree, e["new_tip"], e.get("adopted", 0))
        dropped, deferred = [], []
        for h in suffix:
            for loss in losses.get((node, h), []):
                if loss["step"] <= e.get("step", 0):
                    target = (dropped if loss["kind"] == "drop"
                              else deferred)
                    if h not in target:
                        target.append(h)
        audits.append({
            "node": e.get("node"),
            "step": e.get("step"),
            "lamport": e.get("lamport"),
            "old_tip": e.get("old_tip"),
            "new_tip": e.get("new_tip"),
            "rolled_back": e.get("rolled_back"),
            "rolled_back_hashes": e.get("rolled_back_hashes", []),
            "adopted": e.get("adopted"),
            "winning_suffix": suffix,
            "announcements_dropped": dropped,
            "announcements_partition_deferred": deferred,
            "loss_explains_fork": bool(dropped or deferred),
        })
    return audits


def convergence_stats(merged: list[dict], tree: dict) -> dict:
    """Propagation + convergence picture: how long announcements took to
    land (in sim steps), and where the run ended up."""
    first_send: dict[str, dict] = {}
    latencies: list[int] = []
    deliveries = 0
    slowest: dict | None = None
    for e in merged:
        if e.get("kind") == "send":
            first_send.setdefault(e["hash"], e)
        elif e.get("kind") == "deliver":
            deliveries += 1
            send = first_send.get(e.get("hash"))
            if send is not None:
                lat = max(0, e.get("step", 0) - send.get("step", 0))
                latencies.append(lat)
                if slowest is None or lat > slowest["latency_steps"]:
                    slowest = {"hash": e.get("hash"),
                               "latency_steps": lat,
                               "receiver": e.get("node")}
    latencies.sort()
    n = len(latencies)
    stats = {
        "announcements": len(first_send),
        "deliveries": deliveries,
        "delivery_latency_steps": {
            "count": n,
            "mean": round(sum(latencies) / n, 3) if n else None,
            "p50": latencies[n // 2] if n else None,
            "max": latencies[-1] if n else None,
        },
        "slowest_delivery": slowest,
        "final_step": max((e.get("step", 0) for e in merged), default=0),
        "final_lamport": max((e.get("lamport", 0) for e in merged),
                             default=0),
        "converged": tree["converged"],
        "canonical_height": (tree["blocks"][tree["canonical_tip"]]["height"]
                             if tree.get("canonical_tip") in tree["blocks"]
                             else None),
        "reorgs": sum(1 for e in merged
                      if e.get("kind") == "adopt" and e.get("rolled_back")),
        "blocks_orphaned": len(tree["orphaned"]),
    }
    return stats
