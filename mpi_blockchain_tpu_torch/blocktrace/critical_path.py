"""Per-block critical-path analysis over dispatch pipeline records.

The port's copy of the reference's ``blocktrace/critical_path.py``.
Input: the pipeline profiler's record dicts (records carry their rank, so
a join of several processes' records needs no extra bookkeeping). Output:
one waterfall per mined height.

**Attribution.** A segment belongs to a height when (most specific
wins):

1. it carries its own ``height`` stamp — recorded inside a
   ``trace_block`` scope (the fused drain loop's per-block
   validate/append segments, the CLI's checkpoint seam);
2. its record's meta carries ``height`` + ``k`` (a fused batch): block
   ``height+j+1`` gets the slice from its estimated start within the
   segment (the call mines its blocks in order on the device, so start_j =
   ``t0 + j*(t1-t0)/k``) to the segment's END — a batched block cannot
   complete before the whole batch materializes, so the tail of the
   window is genuinely part of ITS wall too. Sibling slices overlap by
   design: conservation is per block, never summed across blocks.
   Slices are flagged ``estimated`` (except ``k == 1``, where the whole
   window belongs to the single block exactly);
3. its record's meta carries ``height`` alone (a per-block sweep
   dispatch): the whole segment joins that height.

Segments with none of the three are counted ``unattributed`` — never
silently dropped into a block.

**Exclusive timeline (the no-double-count rule).** Per (height, rank)
the block's wall is the span from its earliest segment start to its
latest end. Every instant of that wall is attributed to exactly ONE
stage — the highest-priority stage active at that instant
(``device > collective > validate > append > checkpoint > enqueue``:
when host work overlaps an in-flight device window the block is waiting
on the device, so the device owns the instant and the hidden host work
costs nothing — exactly the pipelining credit the overlap report
grants) — or to ``gap`` when no segment is active. By construction
``sum(stages) + gap == wall`` with no double-count, which is the
conservation property the tests pin.

**Critical path.** The maximal runs of that exclusive timeline, in
time order: at every instant the run's stage is what the block was
actually waiting on, so the run list IS the longest dependency chain —
pipelined overlap collapses onto the blocking stage instead of being
counted twice.

**Mesh rollup.** Ranks keep separate waterfalls (clock comparability
across hosts is not assumed, and elastic ranks mine rank-local chains);
the block's headline numbers come from its *straggler* — the rank with
the largest wall — because the slowest rank is where the block's
critical chain lives. ``gap_pct`` headline = the straggler's.

Deterministic: a pure function of the record set (record order
irrelevant — segments are sorted), so byte-identical inputs produce
byte-identical reports.
"""
from __future__ import annotations

import weakref

from .. import chainwatch
from ..telemetry.registry import default_registry, telemetry_disabled

#: Exclusive-attribution priority, most critical first. Unknown stages
#: rank after every known one (alphabetically, for determinism).
STAGE_PRIORITY = ("device", "collective", "validate", "append",
                  "checkpoint", "enqueue")

#: A block's critical path is "complete" when its gap share stays under
#: this (chip_smoke's phase 11 holds every height to < 5).
COMPLETE_GAP_PCT = 5.0


def _priority(stage: str) -> tuple:
    try:
        return (STAGE_PRIORITY.index(stage),)
    except ValueError:
        return (len(STAGE_PRIORITY), stage)


def segments_by_block(records: list[dict]) -> tuple[dict, int]:
    """Groups every attributable segment slice as
    ``{height: {rank: [slice, ...]}}``; returns ``(blocks,
    n_unattributed)``. Slices are ``{"stage", "t0", "t1", "rank",
    "dispatch", "estimated"}``."""
    blocks: dict[int, dict[int, list[dict]]] = {}
    unattributed = 0

    def _add(height: int, rank: int, seg: dict, t0: float, t1: float,
             estimated: bool, dispatch) -> None:
        if t1 <= t0:
            return
        blocks.setdefault(int(height), {}).setdefault(rank, []).append(
            {"stage": str(seg["stage"]), "t0": float(t0), "t1": float(t1),
             "rank": rank, "dispatch": dispatch,
             "estimated": bool(estimated)})

    for r in records:
        rank = int(r.get("rank", 0))
        meta = r.get("meta") or {}
        dispatch = r.get("dispatch")
        try:
            base_h = int(meta["height"])
        except (KeyError, TypeError, ValueError):
            base_h = None
        try:
            k = int(meta.get("k") or 0)
        except (TypeError, ValueError):
            k = 0
        for seg in r.get("segments") or []:
            t0, t1 = float(seg["t0"]), float(seg["t1"])
            if seg.get("height") is not None:
                _add(int(seg["height"]), rank, seg, t0, t1, False, dispatch)
            elif base_h is not None and k > 1:
                step = (t1 - t0) / k
                for j in range(k):
                    _add(base_h + j + 1, rank, seg, t0 + j * step,
                         t1, True, dispatch)
            elif base_h is not None and k == 1:
                # A 1-block batch needs no sequential split: the whole
                # window belongs to the single block, exactly.
                _add(base_h + 1, rank, seg, t0, t1, False, dispatch)
            elif base_h is not None:
                _add(base_h, rank, seg, t0, t1, False, dispatch)
            else:
                unattributed += 1
    return blocks, unattributed


def _waterfall(slices: list[dict]) -> dict:
    """One (height, rank)'s exclusive timeline: per-stage exclusive ms,
    gap, critical-path runs. ``sum(stages_ms) + gap_ms == wall_ms``."""
    slices = sorted(slices, key=lambda s: (s["t0"], s["t1"], s["stage"]))
    t_lo = min(s["t0"] for s in slices)
    t_hi = max(s["t1"] for s in slices)
    stages_ms: dict[str, float] = {}
    gap_ms = 0.0
    runs: list[dict] = []
    estimated = False
    if all(a["t1"] <= b["t0"] for a, b in zip(slices, slices[1:])):
        # Fast path — the live per-block shape: chained segments never
        # overlap, so each slice owns its own interval outright and the
        # exclusive timeline is just slices + gaps. Same output as the
        # sweep below (the conservation tests run both shapes).
        prev_end = t_lo
        for s in slices:
            if s["t0"] > prev_end:
                gap_ms += (s["t0"] - prev_end) * 1e3
                runs.append({"stage": "gap", "rank": None,
                             "t0": prev_end, "t1": s["t0"]})
            stage = s["stage"]
            stages_ms[stage] = (stages_ms.get(stage, 0.0)
                                + (s["t1"] - s["t0"]) * 1e3)
            estimated = estimated or s["estimated"]
            if (runs and runs[-1]["stage"] == stage
                    and runs[-1]["rank"] == s["rank"]):
                runs[-1]["t1"] = s["t1"]
            else:
                runs.append({"stage": stage, "rank": s["rank"],
                             "t0": s["t0"], "t1": s["t1"]})
            prev_end = s["t1"]
    else:
        points = sorted({p for s in slices for p in (s["t0"], s["t1"])})
        for a, b in zip(points, points[1:]):
            active = [s for s in slices if s["t0"] < b and s["t1"] > a]
            if not active:
                owner, rank = "gap", None
                gap_ms += (b - a) * 1e3
            else:
                best = min(active, key=lambda s: _priority(s["stage"]))
                owner = best["stage"]
                owners = [s for s in active if s["stage"] == owner]
                rank = min(s["rank"] for s in owners)
                estimated = estimated or any(s["estimated"]
                                             for s in owners)
                stages_ms[owner] = (stages_ms.get(owner, 0.0)
                                    + (b - a) * 1e3)
            if (runs and runs[-1]["stage"] == owner
                    and runs[-1]["rank"] == rank):
                runs[-1]["t1"] = b
            else:
                runs.append({"stage": owner, "rank": rank,
                             "t0": a, "t1": b})
    wall_ms = (t_hi - t_lo) * 1e3
    critical = [
        {"stage": r["stage"], "rank": r["rank"],
         "start_ms": round((r["t0"] - t_lo) * 1e3, 4),
         "ms": round((r["t1"] - r["t0"]) * 1e3, 4)}
        for r in runs if r["stage"] != "gap"]
    return {
        "t0": t_lo,
        "wall_ms": round(wall_ms, 4),
        "stages_ms": {k: round(v, 4) for k, v in sorted(stages_ms.items())},
        "gap_ms": round(gap_ms, 4),
        "gap_pct": round(100.0 * gap_ms / wall_ms, 2) if wall_ms else 0.0,
        "estimated": estimated,
        "critical_path": critical,
        "split": {
            "device_ms": round(stages_ms.get("device", 0.0), 4),
            "collective_ms": round(stages_ms.get("collective", 0.0), 4),
            "host_ms": round(sum(v for k, v in stages_ms.items()
                                 if k not in ("device", "collective")), 4),
            "gap_ms": round(gap_ms, 4),
        },
    }


def _observe_waterfall(slices: list[dict]) -> dict:
    """Lean exclusive accounting for the live observe path: per-stage
    exclusive ms + gap only. The full ``_waterfall`` also builds the
    critical-path runs, split and rounded report fields nobody reads on
    the mining hot path; this trimmed twin is what the overhead audit
    prices per block. Overlapping slices (a fused batch) fall back to the
    full sweep; its output is a superset of this shape."""
    slices = sorted(slices, key=lambda s: (s["t0"], s["t1"], s["stage"]))
    if all(a["t1"] <= b["t0"] for a, b in zip(slices, slices[1:])):
        t_lo = slices[0]["t0"]
        stages_ms: dict[str, float] = {}
        gap = 0.0
        prev = t_lo
        for s in slices:
            if s["t0"] > prev:
                gap += s["t0"] - prev
            stage = s["stage"]
            stages_ms[stage] = (stages_ms.get(stage, 0.0)
                                + (s["t1"] - s["t0"]) * 1e3)
            prev = s["t1"]
        wall = prev - t_lo
        return {
            "wall_ms": round(wall * 1e3, 4),
            "stages_ms": stages_ms,
            "gap_ms": gap * 1e3,
            "gap_pct": (round(100.0 * gap / wall, 2) if wall else 0.0),
        }
    return _waterfall(slices)


def critical_path_report(records: list[dict],
                         height: int | None = None) -> dict:
    """The per-block critical-path report of a record set; ``height``
    restricts to one block. See the module docstring for semantics."""
    blocks, unattributed = segments_by_block(records)
    if height is not None:
        blocks = ({int(height): blocks[int(height)]}
                  if int(height) in blocks else {})
    out_blocks: dict[str, dict] = {}
    for h in sorted(blocks):
        per_rank = {str(rank): _waterfall(slices)
                    for rank, slices in sorted(blocks[h].items())}
        straggler = max(sorted(per_rank),
                        key=lambda r: per_rank[r]["wall_ms"])
        head = per_rank[straggler]
        out_blocks[str(h)] = {
            "height": h,
            "ranks": per_rank,
            "critical_rank": int(straggler),
            "wall_ms": head["wall_ms"],
            "stages_ms": head["stages_ms"],
            "gap_ms": head["gap_ms"],
            "gap_pct": head["gap_pct"],
            "split": head["split"],
            "estimated": head["estimated"],
            "critical_path": head["critical_path"],
            "complete": bool(head["critical_path"]
                             and head["gap_pct"] <= COMPLETE_GAP_PCT),
        }
    return {
        "version": 1,
        "heights": sorted(blocks),
        "blocks": out_blocks,
        "record_count": len(records),
        "unattributed_segments": unattributed,
    }


def render_text(report: dict) -> str:
    """Human waterfall rendering of a critical-path report."""
    lines: list[str] = []
    for h in report["heights"]:
        b = report["blocks"][str(h)]
        lines.append(
            f"block {h}: wall {b['wall_ms']:.3f} ms, gap "
            f"{b['gap_pct']:.2f}%, critical rank {b['critical_rank']}"
            f"{' (estimated fused split)' if b['estimated'] else ''}"
            f"{'' if b['complete'] else '  [INCOMPLETE]'}")
        split = b["split"]
        lines.append(
            f"  split: device {split['device_ms']:.3f} ms | collective "
            f"{split['collective_ms']:.3f} ms | host "
            f"{split['host_ms']:.3f} ms | gap {split['gap_ms']:.3f} ms")
        chain = " -> ".join(f"{s['stage']} {s['ms']:.3f}ms"
                            for s in b["critical_path"])
        lines.append(f"  critical path: {chain or '(empty)'}")
    if not report["heights"]:
        lines.append("no attributable blocks in the record set")
    if report["unattributed_segments"]:
        lines.append(f"({report['unattributed_segments']} segment(s) "
                     f"carried no block identity)")
    return "\n".join(lines)


# ---- live per-block metrics ------------------------------------------------

# Histogram handles for the hot observe path, keyed weakly by registry
# instance: nothing may cache a metric object across a
# ``telemetry.reset()``, and a dead registry dropping out of the weak dict
# keeps that contract (an id()-keyed cache could alias a recycled id onto
# a stale metric).
_HIST_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _hist(name: str, help: str, **labels):
    reg = default_registry()
    per_reg = _HIST_CACHE.get(reg)
    if per_reg is None:
        per_reg = _HIST_CACHE[reg] = {}
    key = (name, tuple(sorted(labels.items())))
    h = per_reg.get(key)
    if h is None:
        h = per_reg[key] = reg.histogram(name, help=help, **labels)
    return h


def _may_attribute(record: dict, wanted: set[int]) -> bool:
    """Cheap superset test of ``segments_by_block``'s attribution rules:
    could any segment of ``record`` join a ``wanted`` height? The live
    observe path runs per mined block, possibly against a ring tail; this
    prefilter keeps the per-block cost bounded by the block's own
    records, not the ring."""
    meta = record.get("meta") or {}
    try:
        h = int(meta["height"])
    except (KeyError, TypeError, ValueError):
        h = None
    if h is not None:
        try:
            k = int(meta.get("k") or 0)
        except (TypeError, ValueError):
            k = 0
        if k > 0:
            if any(h < w <= h + k for w in wanted):
                return True
        elif h in wanted:
            return True
    return any(s.get("height") in wanted
               for s in record.get("segments") or [])


def observe_block_metrics(height: int, records: list[dict] | None = None,
                          tail: int = 64, **labels) -> dict | None:
    """Observes ``block_critical_path_ms{stage}`` and
    ``block_trace_gap_pct`` for one just-mined block. The miner passes
    the block's own live record dicts (no copy: it created them, and this
    runs on the same thread right after the append); ``records`` None
    falls back to the process profiler's newest ``tail``. ``labels`` join
    the observed series (the overhead audit's ``backend="trace-audit"``).
    In memory only; returns the single-rank waterfall or None when no
    segment of ``height`` is attributable."""
    if telemetry_disabled():
        return None
    if records is None:
        from ..meshwatch.pipeline import profiler
        records = profiler().records(tail=tail)
    out = observe_batch_metrics([height], records, **labels)
    # The per-block metrics call is chainwatch's evaluation cadence.
    # Throttled inside to one full rule sweep per
    # MPIBT_CHAINWATCH_INTERVAL; disarmed/off processes pay a flag check.
    # Priced by the overhead audit (blocktrace/overhead.py), which calls
    # this same seam.
    chainwatch.evaluate(height=int(height), source="block")
    return out.get(int(height))


def observe_batch_metrics(heights: list[int], records: list[dict],
                          **labels) -> dict:
    """The batch form (one grouping pass for a whole fused batch):
    observes the metrics for every listed height present in ``records``
    and returns ``{height: waterfall}`` for those found. Ranks keep
    separate waterfalls (cross-host clocks are not comparable — the
    same rule as ``critical_path_report``); the observed numbers come
    from the straggler rank, as the report's headline does. In the live
    path the records are this process's own, so there is one rank."""
    if telemetry_disabled():
        return {}
    wanted = {int(h) for h in heights}
    blocks, _ = segments_by_block(
        [r for r in records if _may_attribute(r, wanted)])
    out: dict[int, dict] = {}
    for height in heights:
        ranks = blocks.get(int(height))
        if not ranks:
            continue
        wf = max((_observe_waterfall(slices)
                  for _, slices in sorted(ranks.items())),
                 key=lambda w: w["wall_ms"])
        for stage, ms in wf["stages_ms"].items():
            _hist("block_critical_path_ms",
                  help="per-block exclusive critical-path time per "
                       "stage",
                  stage=stage, **labels).observe(ms)
        _hist("block_trace_gap_pct",
              help="per-block wall share attributed to no stage",
              **labels).observe(wf["gap_pct"])
        out[int(height)] = wf
    return out
