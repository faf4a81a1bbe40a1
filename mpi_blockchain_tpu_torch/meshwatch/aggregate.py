"""Mesh aggregator: merge per-rank shards into ONE mesh-wide view.

The port's copy of the reference's ``meshwatch/aggregate.py``: pure
functions of a shard set (and ``now``), equal to the reference's on the
same input. Merge semantics:

* **counters are summed** across ranks per (name, labels) — a counter is
  a rate source and the mesh-wide rate is the sum (``hashes_tried_total``
  over 8 ranks is the mesh's hash rate numerator);
* **gauges and histograms stay per-rank** under a ``rank`` label —
  averaging a height gauge or pooling latency reservoirs would destroy
  exactly the per-rank attribution this subsystem exists for;
* **heartbeats are compared**, not merged: each rank's freshest
  heartbeat age (at shard-write time) plus the shard's own age is that
  rank's staleness.

Dead/straggler detection: a cleanly-exited rank wrote a ``final`` shard
with exit status 0 ("finished"); a final shard with a nonzero/"error"
exit status is **failed** — the rank died deliberately and said so, and
must never read as cleanly done. A rank is **stale** in either of two
ways, because the shard flusher is an independent daemon thread and a
wedged miner does NOT stop it:

* ``dead-shard`` — the newest shard is non-final and older than the
  stall budget (``MPIBT_MESH_STALL`` seconds, default 10): the whole
  process is gone (SIGKILL, OOM);
* ``no-progress`` — the shard is FRESH but the rank's freshest
  heartbeat age (as carried in the shard, plus the shard's own age)
  exceeds the progress budget (``MPIBT_HEALTHZ_STALL``, default 30 —
  the same budget the per-process ``/healthz`` watchdog uses), or the
  rank has run that long without ever producing a heartbeat: the
  process is alive but the work is wedged — the straggler case.

An expected rank (by ``world_size``) with no shard at all is
**missing**. Any stale, failed, or missing rank flips ``mesh_health``
to 503, names the ranks, emits one
``mesh_rank_stale``/``mesh_rank_failed`` event per transition, and
sets the ``mesh_live_ranks`` gauge — the signal the "dead chip shrinks
the mesh" degradation path acts on.
"""
from __future__ import annotations

import json
import pathlib
import time

from ..telemetry import emit_event, gauge
from ..telemetry.events import env_number
from .shard import SHARD_GLOB

#: Stall budget for shard age (seconds). Shards flush every
#: MPIBT_MESH_OBS_INTERVAL (default 1 s), so 10x that is a dead rank,
#: not a slow writer.
DEFAULT_MESH_STALL_S = env_number("MPIBT_MESH_STALL", 10.0, cast=float,
                                  minimum=1e-2)


def read_shards(directory) -> list[dict]:
    """Every parseable shard in ``directory``, sorted by rank. Malformed
    or torn files are skipped — including a non-integer ``rank`` —
    (writes are atomic, but a reader must survive a half-provisioned
    directory; one bad file must never take down every scrape)."""
    shards: list[dict] = []
    directory = pathlib.Path(directory)
    for path in sorted(directory.glob(SHARD_GLOB)):
        try:
            payload = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(payload, dict):
            continue
        try:
            payload["rank"] = int(payload["rank"])
        except (KeyError, TypeError, ValueError):
            continue
        shards.append(payload)
    shards.sort(key=lambda s: s["rank"])
    return shards


def _expected_world(shards: list[dict]) -> int:
    """The expected rank set's size: the largest declared world, but
    never smaller than the highest rank actually seen — a shard from
    rank N proves at least N+1 ranks exist regardless of what was
    declared. The ONE copy; rank_status and merge_shards must agree or
    /healthz's missing_ranks and /metrics' mesh_rank_up drift apart."""
    if not shards:
        return 0
    return max([int(s.get("world_size", 1)) for s in shards]
               + [int(s["rank"]) + 1 for s in shards])


def _metric_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def merge_shards(shards: list[dict]) -> dict:
    """The mesh-wide view of a shard set (pure function, no side
    effects): counters summed, gauges/histograms per-rank, heartbeats
    per-rank."""
    counters: dict[str, dict] = {}
    gauges: dict[str, dict] = {}
    histograms: dict[str, dict] = {}
    heartbeats: dict[str, dict] = {}
    for shard in shards:
        rank = str(int(shard["rank"]))
        heartbeats[rank] = dict(shard.get("heartbeats", {}))
        for name, samples in (shard.get("registry") or {}).items():
            for sample in samples:
                kind = sample.get("kind")
                labels = dict(sample.get("labels", {}))
                key = _metric_key(name, labels)
                if kind == "counter":
                    slot = counters.setdefault(
                        key, {"name": name, "labels": labels,
                              "total": 0, "by_rank": {}})
                    slot["total"] += sample.get("value", 0)
                    slot["by_rank"][rank] = sample.get("value", 0)
                elif kind == "gauge":
                    slot = gauges.setdefault(
                        key, {"name": name, "labels": labels,
                              "by_rank": {}})
                    slot["by_rank"][rank] = {
                        "value": sample.get("value"),
                        "age_s": sample.get("age_s")}
                elif kind == "histogram":
                    slot = histograms.setdefault(
                        key, {"name": name, "labels": labels,
                              "by_rank": {}})
                    slot["by_rank"][rank] = {
                        k: v for k, v in sample.items()
                        if k not in ("kind", "labels")}
    return {
        "version": 1,
        "ranks": [int(s["rank"]) for s in shards],
        "world_size": _expected_world(shards),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "heartbeats": heartbeats,
    }


# ---- rank liveness --------------------------------------------------------


def recommended_action(status: str, stale_reason: str | None = None) -> str:
    """The machine-readable recovery verdict for one rank's
    classification — the ONE mapping every ``/healthz`` reader (and
    the reference's elastic supervisor, not ported yet) shares, so
    "what should happen to this rank" is decided once, not per caller:

    * ``none``    — ``ok``/``finished``: leave it alone.
    * ``restart`` — ``stale`` with ``no-progress``: the process is
      ALIVE (its shard flusher still writes) but the work is wedged —
      restarting it is the remedy; evicting a live rank that later
      recovers would re-overlap the stripes it still sweeps.
    * ``evict``   — ``stale`` with ``dead-shard`` (the process is gone:
      SIGKILL, OOM), ``failed`` (it exited deliberately and badly — it
      left the mesh), or ``missing`` (expected, never wrote a shard;
      the supervisor applies its own startup grace before acting).
    """
    if status in ("ok", "finished"):
        return "none"
    if status == "stale":
        return "restart" if stale_reason == "no-progress" else "evict"
    if status in ("failed", "missing"):
        return "evict"
    return "none"


def rank_status(shards: list[dict], stall_s: float | None = None,
                now: float | None = None,
                heartbeat_stall_s: float | None = None) -> dict:
    """Per-rank liveness: ``ok`` (fresh shard AND fresh progress),
    ``finished`` (final shard, exit status 0), ``failed`` (final shard
    with a nonzero exit status — the rank exited deliberately but
    badly), ``stale`` (``stale_reason`` = ``dead-shard`` for a stopped
    writer, ``no-progress`` for a live writer whose heartbeats stopped
    — the flusher thread survives a wedged miner, so shard age alone
    cannot catch stragglers), plus ``missing`` entries for
    expected-but-absent ranks."""
    from ..perfwatch.server import DEFAULT_STALL_S

    stall_s = float(stall_s if stall_s is not None else DEFAULT_MESH_STALL_S)
    heartbeat_stall_s = float(heartbeat_stall_s
                              if heartbeat_stall_s is not None
                              else DEFAULT_STALL_S)
    now = time.time() if now is None else now
    world = _expected_world(shards)
    ranks: dict[str, dict] = {}
    for shard in shards:
        rank = str(int(shard["rank"]))
        shard_age = max(now - float(shard.get("written_at", 0.0)), 0.0)
        beat_ages = [b.get("age_s") for b in
                     (shard.get("heartbeats") or {}).values()
                     if b.get("age_s") is not None]
        freshest = (min(beat_ages) + shard_age) if beat_ages else None
        final = bool(shard.get("final"))
        exit_status = shard.get("exit_status")
        failed = final and exit_status not in (0, None)
        stale_reason = None
        if not final:
            if shard_age > stall_s:
                stale_reason = "dead-shard"
            elif freshest is not None and freshest > heartbeat_stall_s:
                stale_reason = "no-progress"
            elif freshest is None and shard.get("started_at") is not None \
                    and now - float(shard["started_at"]) > heartbeat_stall_s:
                # Running that long without EVER heartbeating: wedged
                # before its first unit of work (a hung device init).
                stale_reason = "no-progress"
        state = ("failed" if failed
                 else "finished" if final
                 else "stale" if stale_reason else "ok")
        ranks[rank] = {
            "status": state,
            "stale_reason": stale_reason,
            "recommended_action": recommended_action(state, stale_reason),
            "final": final,
            "exit_status": exit_status,
            "shard_age_s": round(shard_age, 3),
            "heartbeat_age_s": (None if freshest is None
                                else round(freshest, 3)),
            "pid": shard.get("pid"),
            "seq": shard.get("seq"),
        }
    present = {int(r) for r in ranks}
    for rank in range(world):
        if rank not in present:
            ranks[str(rank)] = {"status": "missing",
                                "stale_reason": None,
                                "recommended_action":
                                    recommended_action("missing"),
                                "final": False,
                                "exit_status": None,
                                "shard_age_s": None,
                                "heartbeat_age_s": None,
                                "pid": None, "seq": None}
    return {"world_size": world, "stall_s": stall_s,
            "heartbeat_stall_s": heartbeat_stall_s, "ranks": ranks}


# mesh_rank_stale fires once per transition into staleness, not on every
# scrape; keyed by (directory, rank) so two watched meshes don't cross.
_stale_announced: set[tuple[str, str]] = set()


def mesh_health(directory, stall_s: float | None = None,
                now: float | None = None,
                shards: list[dict] | None = None,
                heartbeat_stall_s: float | None = None
                ) -> tuple[int, dict]:
    """(http status, payload) for the mesh-aware ``/healthz``.

    200 while every expected rank is ``ok`` or ``finished``; 503 the
    moment any rank is stale, failed, or missing — with the offending
    ranks named so the degradation path knows exactly which chip to
    drop.
    """
    if shards is None:
        shards = read_shards(directory)
    if not shards:
        return 503, {"status": "no-shards", "healthy": False,
                     "directory": str(directory), "ranks": {},
                     "stale_ranks": [], "failed_ranks": [],
                     "missing_ranks": [],
                     "live_ranks": 0, "world_size": 0,
                     "skew": {}, "memory": {}, "incidents": [],
                     "compiles": {}, "service": {}}
    status = rank_status(shards, stall_s=stall_s, now=now,
                         heartbeat_stall_s=heartbeat_stall_s)
    ranks = status["ranks"]
    stale = sorted((int(r) for r, v in ranks.items()
                    if v["status"] == "stale"))
    failed = sorted((int(r) for r, v in ranks.items()
                     if v["status"] == "failed"))
    missing = sorted((int(r) for r, v in ranks.items()
                      if v["status"] == "missing"))
    live = sorted((int(r) for r, v in ranks.items()
                   if v["status"] == "ok"))
    gauge("mesh_live_ranks",
          help="ranks with a fresh, non-final shard").set(len(live))
    dir_key = str(directory)
    for rank in stale:
        if (dir_key, f"stale:{rank}") not in _stale_announced:
            _stale_announced.add((dir_key, f"stale:{rank}"))
            emit_event({"event": "mesh_rank_stale", "rank": rank,
                        "reason": ranks[str(rank)]["stale_reason"],
                        "shard_age_s": ranks[str(rank)]["shard_age_s"],
                        "heartbeat_age_s":
                            ranks[str(rank)]["heartbeat_age_s"],
                        "stall_s": status["stall_s"]})
    for rank in failed:
        if (dir_key, f"failed:{rank}") not in _stale_announced:
            _stale_announced.add((dir_key, f"failed:{rank}"))
            emit_event({"event": "mesh_rank_failed", "rank": rank,
                        "exit_status":
                            ranks[str(rank)]["exit_status"]})
    for rank in list(live) + [int(r) for r, v in ranks.items()
                              if v["status"] == "finished"]:
        _stale_announced.discard((dir_key, f"stale:{rank}"))  # recovered
        _stale_announced.discard((dir_key, f"failed:{rank}"))
    healthy = not stale and not failed and not missing
    # The meshprof joins: live-rank rendezvous skew (straggler named per
    # site) and per-rank device-memory watermarks. Additive keys — every
    # pre-existing field keeps its shape (the /healthz schema pin).
    from ..meshprof.analyzer import analyze_skew, skew_summary

    memory = {str(s.get("rank")): s["memory"] for s in shards
              if isinstance(s.get("memory"), dict) and s.get("memory")}
    payload = {
        "status": "ok" if healthy else "degraded",
        "healthy": healthy,
        "world_size": status["world_size"],
        "stall_s": status["stall_s"],
        "heartbeat_stall_s": status["heartbeat_stall_s"],
        "live_ranks": len(live),
        "stale_ranks": stale,
        "failed_ranks": failed,
        "missing_ranks": missing,
        "ranks": ranks,
        "skew": skew_summary(analyze_skew(shards)),
        "memory": memory,
        # Open chainwatch incidents across the mesh, rank-stamped.
        # Additive like skew/memory: [] when no rank carries any, and
        # every pre-existing key keeps its shape (the schema pin in
        # tests/test_meshwatch.py).
        "incidents": mesh_incidents(shards),
        # Per-rank compile census (dispatchwatch carriage): divergent
        # compile counts across ranks are the desync smell single-chip
        # CI can't reproduce — flagged here before the hang.
        "compiles": mesh_compiles(shards),
        # Per-rank blockserve door stats (service carriage): mempool
        # saturation and closed accept gates, {} on serviceless meshes.
        "service": mesh_service(shards),
    }
    return (200 if healthy else 503), payload


def mesh_incidents(shards: list[dict]) -> list[dict]:
    """Every open incident carried by a shard set, each stamped with
    the reporting rank, ordered (rank, incident_seq). Pure function —
    the ``/incidents`` endpoint and ``perfwatch incidents`` share it."""
    out: list[dict] = []
    for shard in shards:
        for inc in shard.get("incidents") or ():
            if isinstance(inc, dict):
                out.append({**inc, "rank": int(shard["rank"])})
    out.sort(key=lambda i: (i["rank"], i.get("incident_seq", 0)))
    return out


def mesh_compiles(shards: list[dict]) -> dict:
    """Mesh-wide compile-census view off the shard ``compiles``
    carriage: per-rank backend-compile totals (with the per-site
    breakdown), the min/max across reporting ranks and a ``divergent``
    flag when they disagree — the every-rank-must-compile-the-same-
    programs invariant a multi-chip bring-up is accepted against.
    ``{}`` when no rank carries a census (cold-backend mesh). Pure
    function — ``/healthz`` and ``perfwatch compiles`` share it."""
    by_rank: dict[str, dict] = {}
    for shard in shards:
        sites = (shard.get("compiles") or {}).get("sites") or {}
        if not sites:
            continue
        by_rank[str(int(shard["rank"]))] = {
            "total": sum(int(st.get("compiles", 0))
                         for st in sites.values()),
            "sites": {site: int(st.get("compiles", 0))
                      for site, st in sorted(sites.items())},
        }
    if not by_rank:
        return {}
    totals = [v["total"] for v in by_rank.values()]
    return {"by_rank": dict(sorted(by_rank.items(),
                                   key=lambda kv: int(kv[0]))),
            "max": max(totals), "min": min(totals),
            "divergent": max(totals) != min(totals)}


def mesh_service(shards: list[dict]) -> dict:
    """Mesh-wide blockserve view off the shard ``service`` carriage:
    per-rank door stats plus the mesh totals the saturation triage
    reads first — summed mempool depth, summed sheds by reason, and
    which ranks' accept gates are closed. ``{}`` when no rank carries a
    door (the serviceless shape the schema pin fixes). Pure function —
    ``/healthz`` shares it with tests."""
    by_rank: dict[str, dict] = {}
    for shard in shards:
        svc = shard.get("service") or {}
        if not svc:
            continue
        by_rank[str(int(shard["rank"]))] = svc
    if not by_rank:
        return {}
    shed: dict[str, int] = {}
    for svc in by_rank.values():
        for reason, n in (svc.get("shed_total") or {}).items():
            shed[reason] = shed.get(reason, 0) + int(n)
    return {"by_rank": dict(sorted(by_rank.items(),
                                   key=lambda kv: int(kv[0]))),
            "depth": sum(int((v.get("mempool") or {}).get("depth", 0))
                         for v in by_rank.values()),
            "shed_total": dict(sorted(shed.items())),
            "gates_closed": sorted(
                int(r) for r, v in by_rank.items()
                if not (v.get("accept_gate") or {}).get("open", True))}


# ---- Prometheus rendering -------------------------------------------------


def _prom_labels(labels: dict, rank: str | None = None) -> str:
    from ..telemetry.registry import _escape_label_value

    labels = dict(labels)
    # A metric registered through the rank_* helpers already carries its
    # own rank label — that one is authoritative (it was stamped at
    # registration time); appending the shard's rank too would emit a
    # duplicate label name, which Prometheus rejects outright.
    if rank is not None and "rank" not in labels:
        labels["rank"] = rank
    items = sorted(labels.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in items)
    return "{" + body + "}"


def _prom_value(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return f"{v:.9g}" if isinstance(v, float) else str(v)


def render_mesh_prometheus(view: dict, health: dict | None = None) -> str:
    """Prometheus text for a merged view: counters summed (no rank
    label), gauges/histogram summaries per-rank under ``rank``, plus the
    mesh liveness series when a health payload is supplied."""
    lines: list[str] = []
    seen: set[str] = set()
    for key in sorted(view.get("counters", {})):
        c = view["counters"][key]
        if c["name"] not in seen:
            seen.add(c["name"])
            lines.append(f"# TYPE {c['name']} counter")
        lines.append(f"{c['name']}{_prom_labels(c['labels'])} "
                     f"{_prom_value(c['total'])}")
    for key in sorted(view.get("gauges", {})):
        g = view["gauges"][key]
        if g["name"] not in seen:
            seen.add(g["name"])
            lines.append(f"# TYPE {g['name']} gauge")
        for rank in sorted(g["by_rank"], key=int):
            sample = g["by_rank"][rank]
            if sample.get("age_s") is None:   # never set on that rank
                continue
            lines.append(f"{g['name']}{_prom_labels(g['labels'], rank)} "
                         f"{_prom_value(sample['value'])}")
    for key in sorted(view.get("histograms", {})):
        h = view["histograms"][key]
        if h["name"] not in seen:
            seen.add(h["name"])
            lines.append(f"# TYPE {h['name']} summary")
        for rank in sorted(h["by_rank"], key=int):
            snap = h["by_rank"][rank]
            for q_key, q_label in (("p50", "0.5"), ("p95", "0.95"),
                                   ("p99", "0.99")):
                if snap.get(q_key) is not None:
                    lines.append(
                        f"{h['name']}"
                        f"{_prom_labels(dict(h['labels'], quantile=q_label), rank)} "
                        f"{_prom_value(snap[q_key])}")
            lines.append(f"{h['name']}_count"
                         f"{_prom_labels(h['labels'], rank)} "
                         f"{_prom_value(snap.get('count', 0))}")
            lines.append(f"{h['name']}_sum"
                         f"{_prom_labels(h['labels'], rank)} "
                         f"{_prom_value(snap.get('sum', 0))}")
    if health is not None:
        lines.append("# TYPE mesh_live_ranks gauge")
        lines.append(f"mesh_live_ranks {health.get('live_ranks', 0)}")
        lines.append("# TYPE mesh_rank_up gauge")
        for rank, info in sorted(health.get("ranks", {}).items(),
                                 key=lambda kv: int(kv[0])):
            up = 1 if info["status"] in ("ok", "finished") else 0
            lines.append(f'mesh_rank_up{{rank="{rank}"}} {up}')
    return "\n".join(lines) + ("\n" if lines else "")
