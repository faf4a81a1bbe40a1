"""Perfetto export of a critical-path report (the port's copy of the
reference's ``blocktrace/export.py``): the pipeline's wall-clock
rank/stage rows (reused verbatim from ``meshwatch.pipeline``) plus one
dedicated **critical path** process row whose slices are each block's
critical-path runs, chained by flow events — the highlighted arrow trail
is the block's longest dependency chain on ui.perfetto.dev.

Flow events pair by (cat, id); one flow per block (id = the height) with
a start (``ph: s``) on the first run, steps (``ph: t``) on each middle
run, and a finish (``ph: f``, ``bp: e``) on the last — each bound to its
run's slice by landing inside it.

When per-rank ``skew_spans`` (meshprof) are passed, a **collective
rendezvous** process row is added: one thread per rank, one slice per
span, named by its collective site — laid on the same wall axis as the
pipeline rows, the staircase of enters at one (site, round) IS the skew
the analyzer prices.

When ``incidents`` (chainwatch incident records, as carried by shards /
``/incidents``) are passed, an **incidents** annotation row is added:
one instant marker per incident at its ``opened_at`` wall time, named
``incident:<rule>`` — scrub to the marker and the surrounding pipeline /
collective /critical-path slices ARE the evidence window the incident
bundle snapshotted.

When per-rank ``compiles`` (dispatchwatch compile events, as carried by
the shard ``compiles`` key) are passed, a **compiles** process row is
added (the reference's "xla compiles" row; here the events are ``nvcc``
builds, library loads and k-block programs): one slice per observed
compile, named ``compile:<site>`` — a compile slice overlapping a mining
dispatch on the same wall axis is a build stealing time from the sweep.
"""
from __future__ import annotations

from ..meshwatch.pipeline import to_chrome_trace

#: The critical-path row's pid — far above any real rank.
CRITICAL_PID = 999999
#: The collective-rendezvous row's pid — just under the critical path.
COLLECTIVE_PID = 999998
#: The chainwatch incident-annotation row's pid — under the collectives.
INCIDENT_PID = 999997
#: The dispatchwatch compile row's pid — under the incidents.
COMPILE_PID = 999996
#: The compile row's name (the reference names it "xla compiles").
COMPILE_ROW = "compiles"


def _collective_lane(events: list, skew_spans: dict, epoch: float) -> None:
    """Append the collective-rendezvous process row: tid = rank, one
    ``ph: X`` slice per span (name = site; args carry the join key)."""
    events.append({"ph": "M", "name": "process_name",
                   "pid": COLLECTIVE_PID, "tid": 0,
                   "args": {"name": "collective rendezvous"}})
    for rank in sorted(skew_spans, key=int):
        events.append({"ph": "M", "name": "thread_name",
                       "pid": COLLECTIVE_PID, "tid": int(rank),
                       "args": {"name": f"rank {rank}"}})
        for rec in skew_spans[rank]:
            try:
                ts = (float(rec["t_enter"]) - epoch) * 1e6
                dur = (float(rec["t_exit"]) - float(rec["t_enter"])) * 1e6
                site = str(rec["site"])
            except (KeyError, TypeError, ValueError):
                continue
            args = {"site": site, "round": rec.get("round"),
                    "ok": rec.get("ok", True)}
            if rec.get("height") is not None:
                args["height"] = rec["height"]
            events.append({
                "ph": "X", "cat": "collective", "name": site,
                "pid": COLLECTIVE_PID, "tid": int(rank),
                "ts": round(ts, 3), "dur": round(max(dur, 1e-1), 3),
                "args": args,
            })


def _incident_lane(events: list, incidents: list, epoch: float) -> None:
    """Append the chainwatch annotation row: one process-scoped instant
    marker per incident at its ``opened_at``, args carrying the record's
    identity (rule, severity, seq, implicated heights, firing rank)."""
    events.append({"ph": "M", "name": "process_name",
                   "pid": INCIDENT_PID, "tid": 0,
                   "args": {"name": "chainwatch incidents"}})
    for inc in incidents:
        try:
            ts = (float(inc["opened_at"]) - epoch) * 1e6
            rule = str(inc["rule"])
        except (KeyError, TypeError, ValueError):
            continue
        args = {"rule": rule,
                "severity": inc.get("severity", ""),
                "incident_seq": inc.get("incident_seq"),
                "heights": list(inc.get("heights") or ())}
        if inc.get("rank") is not None:
            args["rank"] = inc["rank"]
        events.append({
            "ph": "i", "s": "p", "cat": "incident",
            "name": f"incident:{rule}",
            "pid": INCIDENT_PID, "tid": 0, "ts": round(ts, 3),
            "args": args,
        })


def _compile_lane(events: list, compiles: dict, epoch: float) -> None:
    """Append the compile process row: tid = rank, one ``ph: X``
    slice per observed backend compile. A compile event's ``t`` stamp
    is its END (the listener reports a completed duration), so the
    slice opens ``ms`` earlier."""
    events.append({"ph": "M", "name": "process_name",
                   "pid": COMPILE_PID, "tid": 0,
                   "args": {"name": COMPILE_ROW}})
    for rank in sorted(compiles, key=int):
        events.append({"ph": "M", "name": "thread_name",
                       "pid": COMPILE_PID, "tid": int(rank),
                       "args": {"name": f"rank {rank}"}})
        for rec in compiles[rank]:
            try:
                ms = float(rec["ms"])
                ts = (float(rec["t"]) - epoch) * 1e6 - ms * 1e3
                site = str(rec["site"])
            except (KeyError, TypeError, ValueError):
                continue
            events.append({
                "ph": "X", "cat": "compile", "name": f"compile:{site}",
                "pid": COMPILE_PID, "tid": int(rank),
                "ts": round(ts, 3), "dur": round(max(ms * 1e3, 1e-1), 3),
                "args": {"site": site, "ms": ms,
                         "stage": rec.get("stage", "backend_compile")},
            })


def to_critical_path_trace(report: dict, records: list[dict],
                           skew_spans: dict | None = None,
                           incidents: list | None = None,
                           compiles: dict | None = None) -> dict:
    """Chrome trace-event JSON: base pipeline rows + the critical-path
    row (+ the collective lane when per-rank ``skew_spans`` — a mapping
    rank -> span list, as carried by meshwatch shards — are passed,
    + the incident annotation lane when chainwatch ``incidents`` —
    rank-stamped records as served by ``/incidents`` — are passed,
    + the compile lane when per-rank ``compiles`` — a mapping
    rank -> compile-event list, as carried by the shard ``compiles``
    key — are passed). Deterministic for a deterministic
    (report, records) pair."""
    trace = to_chrome_trace(records)
    events = trace["traceEvents"]
    epoch = trace.get("metadata", {}).get("epoch_unix_s")
    if skew_spans:
        enters = [float(r["t_enter"]) for spans in skew_spans.values()
                  for r in spans if r.get("t_enter") is not None]
        if enters:
            # Spans share the pipeline's wall-anchored axis; with no
            # pipeline segments at all, the earliest enter is the epoch.
            lane_epoch = epoch if epoch is not None else min(enters)
            _collective_lane(events, skew_spans, lane_epoch)
            trace.setdefault("metadata", {}).setdefault(
                "epoch_unix_s", lane_epoch)
    if incidents:
        opened = [float(i["opened_at"]) for i in incidents
                  if i.get("opened_at") is not None]
        if opened:
            lane_epoch = trace.get("metadata", {}).get("epoch_unix_s")
            lane_epoch = lane_epoch if lane_epoch is not None \
                else min(opened)
            _incident_lane(events, incidents, lane_epoch)
            trace.setdefault("metadata", {}).setdefault(
                "epoch_unix_s", lane_epoch)
    if compiles:
        ends = [float(r["t"]) for recs in compiles.values()
                for r in recs if r.get("t") is not None]
        if ends:
            lane_epoch = trace.get("metadata", {}).get("epoch_unix_s")
            lane_epoch = lane_epoch if lane_epoch is not None \
                else min(ends)
            _compile_lane(events, compiles, lane_epoch)
            trace.setdefault("metadata", {}).setdefault(
                "epoch_unix_s", lane_epoch)
    if epoch is None:       # no segments at all: nothing to highlight
        return trace
    events.append({"ph": "M", "name": "process_name", "pid": CRITICAL_PID,
                   "tid": 0, "args": {"name": "critical path"}})
    for h in report["heights"]:
        block = report["blocks"][str(h)]
        ranks = block["ranks"]
        straggler = str(block["critical_rank"])
        base_us = (ranks[straggler]["t0"] - epoch) * 1e6
        events.append({"ph": "M", "name": "thread_name",
                       "pid": CRITICAL_PID, "tid": int(h),
                       "args": {"name": f"block {h}"}})
        runs = block["critical_path"]
        for i, run in enumerate(runs):
            ts = round(base_us + run["start_ms"] * 1e3, 3)
            dur = round(max(run["ms"], 1e-4) * 1e3, 3)
            events.append({
                "ph": "X", "cat": "critical_path",
                "name": f"critical:{run['stage']}",
                "pid": CRITICAL_PID, "tid": int(h), "ts": ts, "dur": dur,
                "args": {"height": int(h), "rank": run["rank"],
                         "ms": run["ms"]},
            })
            if len(runs) < 2:    # nothing to chain: no dangling flow
                continue
            flow = {"cat": "critical_path", "name": f"block {h}",
                    "id": int(h), "pid": CRITICAL_PID, "tid": int(h)}
            mid_ts = round(ts + dur / 2, 3)
            if i == 0:
                events.append({**flow, "ph": "s", "ts": mid_ts})
            elif i == len(runs) - 1:
                events.append({**flow, "ph": "f", "bp": "e", "ts": mid_ts})
            else:
                events.append({**flow, "ph": "t", "ts": mid_ts})
    return trace
