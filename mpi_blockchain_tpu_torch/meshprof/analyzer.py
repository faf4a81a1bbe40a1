"""Mesh-wide skew analyzer: join per-rank spans into arrival deltas.

The port's copy of the reference's ``meshprof/analyzer.py``. In the port
the spans come from the ``mesh.sweep`` winner-select round of a world of
processes (``backend/cuda.py``), carried by each rank's shard.
``analyze_skew(shards)`` is a PURE function of a meshwatch shard set —
re-running it on the same shards is byte-identical (the ``skew-smoke``
determinism contract) — that aligns every rank's spans on the
(site, round) key and derives, per site:

* **clock-offset normalization** — per-rank offset = the median, over
  the rounds that rank joined, of (its arrival − the round's median
  arrival). Subtracting it first means a rank whose monotonic anchor
  (or host clock) sits a constant Δ away contributes ZERO fabricated
  skew: only round-to-round arrival VARIATION survives, which is the
  quantity that actually idles chips. The estimated offsets are
  reported (``clock_offset_ms``) so a real constant straggler — which
  is indistinguishable from a clock offset without a synchronized
  clock — is still visible, just not silently priced as skew;
* **arrival-delta distribution** — per-round skew = last normalized
  arrival − first, summarized as mean/p50/p95/max (``skew_ms``) and
  kept per round (``round_skews_ms``, round order) for the registry
  histogram;
* **the straggler** — the rank with the largest mean lag behind the
  round's first arrival (ties break to the LOWEST rank, so the verdict
  is deterministic), its lag, and the implied idle chip-time: the sum
  over rounds of every early rank's wait for the last arrival — the
  wall the mesh pays for the straggler.

``publish_skew`` mirrors a report onto the live registry
(``collective_skew_ms{site}`` histogram, which chainwatch's
``collective_skew_spike`` rule reads, and the ``mesh_straggler_rank``
gauge); ``skew_shape`` strips the timing values so two same-seed runs
can be compared structurally (timings are weather, the joined shape is
not); ``skew_summary`` is the bounded digest ``/healthz`` carries.
"""
from __future__ import annotations

#: Rounds need at least this many ranks to say anything about skew.
MIN_RANKS = 2


def _median(sorted_xs: list[float]) -> float:
    n = len(sorted_xs)
    mid = n // 2
    if n % 2:
        return sorted_xs[mid]
    return (sorted_xs[mid - 1] + sorted_xs[mid]) / 2.0


def _quantile(sorted_xs: list[float], q: float) -> float:
    """Nearest-rank quantile of an ascending list (deterministic, no
    interpolation surprises across Python versions)."""
    if not sorted_xs:
        return 0.0
    idx = min(int(q * len(sorted_xs)), len(sorted_xs) - 1)
    return sorted_xs[idx]


def collect_spans(shards: list[dict]) -> dict:
    """{site: {round: {rank: t_enter}}} from a shard set. Malformed
    spans are skipped (a reader must survive a half-written mesh
    directory, same tolerance as ``aggregate.read_shards``)."""
    per_site: dict[str, dict[int, dict[int, float]]] = {}
    for shard in shards:
        try:
            rank = int(shard["rank"])
        except (KeyError, TypeError, ValueError):
            continue
        for rec in shard.get("skew_spans") or []:
            if not isinstance(rec, dict):
                continue
            site = rec.get("site")
            rnd = rec.get("round")
            t = rec.get("t_enter")
            if not isinstance(site, str) or rnd is None or t is None:
                continue
            try:
                per_site.setdefault(site, {}) \
                    .setdefault(int(rnd), {})[rank] = float(t)
            except (TypeError, ValueError):
                continue
    return per_site


def analyze_skew(shards: list[dict], min_ranks: int = MIN_RANKS) -> dict:
    """The mesh-wide skew report of a shard set (see module docstring).
    Deterministic: pure function, sorted iteration, rounded floats."""
    per_site = collect_spans(shards)
    sites: dict[str, dict] = {}
    world: set[int] = set()
    overall = (-1.0, -1)        # (mean lag ms, -rank) of the straggler
    max_skew = 0.0
    for site in sorted(per_site):
        rounds = {r: a for r, a in per_site[site].items()
                  if len(a) >= min_ranks}
        if not rounds:
            continue
        ranks = sorted({rk for a in rounds.values() for rk in a})
        world.update(ranks)
        centers = {r: _median(sorted(a.values()))
                   for r, a in rounds.items()}
        offsets: dict[int, float] = {}
        for rk in ranks:
            diffs = sorted(a[rk] - centers[r]
                           for r, a in rounds.items() if rk in a)
            offsets[rk] = _median(diffs)
        skews: list[float] = []        # round order
        lag_sum = {rk: 0.0 for rk in ranks}
        lag_n = {rk: 0 for rk in ranks}
        idle_ms = 0.0
        for r in sorted(rounds):
            arrivals = rounds[r]
            norm = {rk: t - offsets[rk] for rk, t in arrivals.items()}
            first = min(norm.values())
            last = max(norm.values())
            skews.append((last - first) * 1e3)
            for rk, t in norm.items():
                lag_sum[rk] += (t - first) * 1e3
                lag_n[rk] += 1
                idle_ms += (last - t) * 1e3
        mean_lag = {rk: lag_sum[rk] / lag_n[rk] for rk in ranks}
        straggler = max(ranks, key=lambda rk: (mean_lag[rk], -rk))
        asc = sorted(skews)
        dist = {"mean": round(sum(skews) / len(skews), 3),
                "p50": round(_quantile(asc, 0.50), 3),
                "p95": round(_quantile(asc, 0.95), 3),
                "max": round(asc[-1], 3)}
        max_skew = max(max_skew, asc[-1])
        if (mean_lag[straggler], -straggler) > overall:
            overall = (mean_lag[straggler], -straggler)
        sites[site] = {
            "rounds": len(rounds),
            "ranks": ranks,
            "clock_offset_ms": {str(rk): round(offsets[rk] * 1e3, 3)
                                for rk in ranks},
            "skew_ms": dist,
            "round_skews_ms": [round(s, 3) for s in skews],
            "per_rank_lag_ms": {str(rk): round(mean_lag[rk], 3)
                                for rk in ranks},
            "straggler_rank": straggler,
            "straggler_lag_ms": round(mean_lag[straggler], 3),
            "idle_chip_ms": round(idle_ms, 3),
        }
    return {
        "version": 1,
        "world": sorted(world),
        "site_count": len(sites),
        "sites": sites,
        "straggler_rank": -overall[1] if sites else -1,
        "max_skew_ms": round(max_skew, 3),
    }


def skew_shape(report: dict) -> dict:
    """The structural projection of a report — what joined, not how
    long it took. Two same-seed runs must produce identical shapes
    (the skew-smoke cross-run determinism gate): timings are weather,
    the (site, round, rank) join is not."""
    return {
        "world": list(report.get("world", [])),
        "sites": {site: {"rounds": v["rounds"], "ranks": list(v["ranks"])}
                  for site, v in sorted(report.get("sites", {}).items())},
    }


def skew_summary(report: dict) -> dict:
    """The bounded digest the mesh ``/healthz`` payload carries: enough
    to name the straggler and size the problem without shipping every
    round's delta on every scrape."""
    return {
        "site_count": report.get("site_count", 0),
        "straggler_rank": report.get("straggler_rank", -1),
        "max_skew_ms": report.get("max_skew_ms", 0.0),
        "sites": {site: {"rounds": v["rounds"],
                         "straggler_rank": v["straggler_rank"],
                         "straggler_lag_ms": v["straggler_lag_ms"],
                         "skew_p95_ms": v["skew_ms"]["p95"],
                         "idle_chip_ms": v["idle_chip_ms"]}
                  for site, v in sorted(report.get("sites", {}).items())},
    }


def publish_skew(report: dict) -> None:
    """Mirror a report onto the live registry: one
    ``collective_skew_ms`` observation per joined round under its
    ``site`` label, and the mesh-wide straggler gauge (per-site under
    ``site``, overall unlabeled). No-op under the kill switch (the
    telemetry helpers hand back NULL_METRIC then)."""
    from ..telemetry import gauge, histogram

    for site, v in sorted(report.get("sites", {}).items()):
        h = histogram("collective_skew_ms",
                      help="per-round rendezvous arrival skew (last "
                           "arrival - first, clock-offset normalized)",
                      site=site)
        for s in v["round_skews_ms"]:
            h.observe(s)
        gauge("mesh_straggler_rank",
              help="rank with the largest mean rendezvous lag "
                   "(-1: no joined rounds)",
              site=site).set(v["straggler_rank"])
    gauge("mesh_straggler_rank",
          help="rank with the largest mean rendezvous lag "
               "(-1: no joined rounds)").set(
        report.get("straggler_rank", -1))
