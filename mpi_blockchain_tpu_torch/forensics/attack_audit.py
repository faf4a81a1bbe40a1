"""Attack audit: what each adversary strategy did and what it achieved.

The port's copy of the reference's ``forensics/attack_audit.py``. It
consumes the ``attack_*`` causal vocabulary of the scenario engine's
strategies alongside the standard mine/send/deliver/adopt events, and
cross-references it with the fork tree, so every attack's outcome is
checkable, not just its attempt:

* **selfish mining**: every ``attack_withhold`` / ``attack_release`` /
  ``attack_abandon``, the reorg depth each release caused (adopt events
  whose winning tip descends from the released private tip), and the
  revenue ledger: the attacker's blocks on the canonical chain against
  everyone else's.
* **eclipse**: the attack window, the victim's isolated fork (blocks it
  mined during the window that ended up orphaned), and post-heal
  convergence (the victim's first adopt after the window, with its
  rollback depth).
* **stale-tip flood**: every ``attack_flood`` and the matching
  ``sync_rejected`` rejections, counted by rejection path (sync budget,
  linkage, retarget bits), plus the invariant that matters: no adopt from
  the flooder ever installed a tip that was never mined (chains
  untouched).

The audit is a pure function of the dump.
"""
from __future__ import annotations


def _descends_from(blocks: dict, tip: str, ancestor: str,
                   ancestor_height: int) -> bool:
    """True when ``ancestor`` is on the chain ending at ``tip`` (walked
    via mine-event prev links, bounded by the ancestor's height)."""
    h = tip
    while h in blocks:
        if h == ancestor:
            return True
        if blocks[h].get("height", 0) <= ancestor_height:
            return False
        h = blocks[h].get("prev")
    return h == ancestor


def _reason_path(reason: str) -> str:
    """Buckets a sync_rejected reason string into its rejection path."""
    if "budget" in reason:
        return "budget"
    if "linkage" in reason:
        return "linkage"
    if "bits" in reason:
        return "bits"
    return "other"


def _selfish_audit(merged: list[dict], tree: dict) -> list[dict]:
    attackers = sorted({e["node"] for e in merged
                        if e.get("kind") == "attack_withhold"},
                       key=str)
    out = []
    blocks = tree["blocks"]
    canonical = set(tree["canonical_chain"])
    for node in attackers:
        withheld = [e for e in merged
                    if e.get("kind") == "attack_withhold"
                    and e["node"] == node]
        releases = [e for e in merged
                    if e.get("kind") == "attack_release"
                    and e["node"] == node]
        abandons = [e for e in merged
                    if e.get("kind") == "attack_abandon"
                    and e["node"] == node]
        release_audits = []
        for rel in releases:
            tip = rel.get("tip")
            tip_height = rel.get("height", 0)
            # The reorgs this release caused: adopts whose winning tip
            # is the released private tip or a DESCENDANT mined on it
            # before everyone healed (slow receivers adopt the grown
            # chain, not the release-time tip), after the release.
            depths = [e.get("rolled_back", 0) for e in merged
                      if e.get("kind") == "adopt"
                      and e.get("lamport", 0) > rel.get("lamport", 0)
                      and e.get("rolled_back")
                      and _descends_from(blocks, e.get("new_tip"), tip,
                                         tip_height)]
            release_audits.append({
                "step": rel.get("step"),
                "count": rel.get("count"),
                "tip": tip,
                "reorgs_caused": len(depths),
                "max_reorg_depth": max(depths, default=0),
            })
        mined = {h for h, b in blocks.items() if b.get("miner") == node}
        revenue = len(mined & canonical)
        out.append({
            "node": node,
            "withheld_total": len(withheld),
            "releases": release_audits,
            "released_total": sum(r.get("count", 0) for r in releases),
            "abandoned_total": sum(a.get("count", 0) for a in abandons),
            "revenue_blocks": revenue,
            "revenue_share": (round(revenue / len(canonical), 4)
                              if canonical else 0.0),
        })
    return out


def _eclipse_audit(merged: list[dict], tree: dict) -> list[dict]:
    out = []
    blocks = tree["blocks"]
    canonical = set(tree["canonical_chain"])
    for start in [e for e in merged
                  if e.get("kind") == "attack_eclipse_start"]:
        victim = start.get("victim")
        until = start.get("until_step", 0)
        end = next((e for e in merged
                    if e.get("kind") == "attack_eclipse_end"
                    and e.get("victim") == victim
                    and e.get("step", 0) >= start.get("step", 0)), None)
        window = (start.get("step", 0),
                  end.get("step") if end else until or None)
        # The victim's isolated fork: blocks it mined inside the window
        # that never made the canonical chain.
        isolated = sorted(
            h for h, b in blocks.items()
            if b.get("miner") == victim and h not in canonical
            and window[0] <= b.get("step", 0)
            and (window[1] is None or b.get("step", 0) < window[1]))
        # Post-heal convergence: the victim's first adopt after the
        # window closed, and whether its final tip is canonical.
        heal = next((e for e in merged
                     if e.get("kind") == "adopt"
                     and str(e.get("node")) == str(victim)
                     and window[1] is not None
                     and e.get("step", 0) >= window[1]), None)
        out.append({
            "attacker": start.get("attacker"),
            "victim": victim,
            "window": list(window),
            "victim_height_at_start": start.get("victim_height"),
            "victim_height_at_end": (end or {}).get("victim_height"),
            "isolated_fork": isolated,
            "isolated_fork_len": len(isolated),
            "post_heal_adopt": (None if heal is None else {
                "step": heal.get("step"),
                "rolled_back": heal.get("rolled_back"),
                "adopted": heal.get("adopted"),
                "new_tip": heal.get("new_tip"),
            }),
            # On-canonical-chain, not tip-equality: at scale the dump
            # records consensus events only (no per-append delivers), so
            # a victim's recorded tip can be a stale ancestor of the
            # canonical tip while its real chain is canonical.
            "victim_tip_canonical": (
                tree["tips"].get(str(victim)) in canonical),
        })
    return out


def _flood_audit(merged: list[dict], tree: dict) -> list[dict]:
    attackers = sorted({e["node"] for e in merged
                        if e.get("kind") == "attack_flood"}, key=str)
    out = []
    known_blocks = set(tree["blocks"])
    for node in attackers:
        floods = [e for e in merged if e.get("kind") == "attack_flood"
                  and e["node"] == node]
        # Rejections attributed to this flooder (the victim names the
        # peer it rejected).
        rejections = [e for e in merged
                      if e.get("kind") == "sync_rejected"
                      and str(e.get("peer")) == str(node)]
        by_path: dict[str, int] = {}
        for r in rejections:
            path = _reason_path(r.get("reason", ""))
            by_path[path] = by_path.get(path, 0) + 1
        # The invariant: no adopt FROM the flooder ever installed a tip
        # that was never mined. A flooder may also run an honest chain
        # (its mined blocks have mine events and may be legitimately
        # adopted); a FORGED suffix's tip has no mine event anywhere, so
        # adopting one is exactly "a forged suffix got through".
        breaches = [e for e in merged if e.get("kind") == "adopt"
                    and str(e.get("peer", "")) == str(node)
                    and e.get("new_tip") not in known_blocks]
        victims = {str(r.get("node")) for r in rejections}
        out.append({
            "node": node,
            "attacks": len(floods),
            "rejections": len(rejections),
            "rejections_by_path": dict(sorted(by_path.items())),
            "victims": sorted(victims),
            "chains_untouched": not breaches,
        })
    return out


def attack_audit(merged: list[dict], tree: dict) -> dict:
    """The attack section of ``analyze_dump`` (empty dict when the dump
    carries no ``attack_*`` events: plain fault runs stay unchanged)."""
    if not any(str(e.get("kind", "")).startswith("attack_")
               for e in merged):
        return {}
    return {
        "selfish": _selfish_audit(merged, tree),
        "eclipse": _eclipse_audit(merged, tree),
        "flood": _flood_audit(merged, tree),
    }
