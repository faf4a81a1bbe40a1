"""chainwatch anomaly rules: streaming detectors over live telemetry.

The port's copy of the reference's ``chainwatch/rules.py``: the eight
rules, their ``MPIBT_CHAINWATCH_*`` knobs and defaults. Every rule is a
small state machine sampled on a cadence the run already pays for (the
per-block ``observe_block_metrics`` call), never a new thread, never a
device query of its own. A rule reads only surfaces that already exist:
the metrics registry, the event ring, the pipeline profiler, the memory
watermarks (``meshprof.memory``: the allocator of the card), the compile
census (``dispatchwatch``) and the front door's stats
(``service.service_stats``).

The firing discipline (``Rule.evaluate``) is shared by every detector:

* **debounce**: a breach must persist for ``debounce_n`` consecutive
  samples before the rule fires;
* **hysteresis**: once fired, the rule is an open episode and does not
  fire again until the signal has been clean for ``clear_n`` consecutive
  samples (a flapping signal makes one incident, not a stream);
* **severity**: ``warn`` or ``critical``, carried by the incident.

A clean fixed-seed run must raise zero incidents, so every threshold errs
quiet and every baseline is learned in the run, never an absolute wall
time.
"""
from __future__ import annotations

import collections
import time

from ..telemetry.events import env_number

#: Severity levels, mildest first (render/sort order).
SEVERITIES = ("warn", "critical")

#: Event names that count toward the event-storm rule: retries,
#: degradations, collective timeouts, injected faults — the "the run is
#: absorbing damage" burst signals.
STORM_EVENTS = frozenset({
    "retry", "collective_timeout", "backend_rung_unavailable",
    "speculative_dispatch_failed", "backend_probe_failed",
    "fault_injected",
})


class Rule:
    """Debounce/hysteresis wrapper around a boolean ``sample``.

    Subclasses implement ``sample(ctx) -> (breach, detail)``; the base
    class turns that stream into at-most-one firing per open episode.
    ``ctx`` is the evaluation context dict chainwatch passes every rule
    (see ``chainwatch.evaluate``): ``height``, ``source``, ``now``.
    """

    name = "rule"
    severity = "warn"
    debounce_n = 2
    clear_n = 2

    def __init__(self):
        self._breach_streak = 0
        self._clear_streak = 0
        self.open = False
        self.fired_total = 0

    def sample(self, ctx: dict) -> tuple[bool, dict]:
        raise NotImplementedError

    def evaluate(self, ctx: dict) -> dict | None:
        """One sampling step. Returns the firing detail dict exactly
        once per episode (debounced breach while closed), else None."""
        breach, detail = self.sample(ctx)
        if breach:
            self._breach_streak += 1
            self._clear_streak = 0
            if not self.open and self._breach_streak >= self.debounce_n:
                self.open = True
                self.fired_total += 1
                return dict(detail)
        else:
            self._breach_streak = 0
            if self.open:
                self._clear_streak += 1
                if self._clear_streak >= self.clear_n:
                    self.open = False
                    self._clear_streak = 0
        return None

    def reset(self) -> None:
        self.__init__()


# ---- rule catalogue --------------------------------------------------------


class HashrateCollapse(Rule):
    """EWMA hash rate vs the in-run rolling baseline.

    Rate = Δ``hashes_tried_total`` (summed over labelsets in the live
    registry) / Δwall between samples. The first ``warmup_n`` rates
    build the baseline; after warmup the rule breaches while the EWMA
    sits below ``collapse_frac`` of the rolling baseline. Short runs
    never leave warmup, so they can never fire — mining-time variance
    is geometric per block, but the *rate* is stable, which is exactly
    why the rule watches rate and not block latency."""

    name = "hashrate_collapse"
    severity = "critical"
    debounce_n = 3

    def __init__(self):
        super().__init__()
        self.warmup_n = env_number("MPIBT_CHAINWATCH_HASHRATE_WARMUP", 8,
                                   cast=int, minimum=2)
        self.collapse_frac = env_number(
            "MPIBT_CHAINWATCH_HASHRATE_FRAC", 0.4, cast=float, minimum=0)
        self._last = None          # (wall, total hashes)
        self._ewma = None
        self._baseline = None
        self._samples = 0

    @staticmethod
    def _total_hashes() -> float:
        # The sum over labelsets, read off the live metrics: the
        # reference builds a whole registry snapshot for it, every
        # histogram's quantiles included, which on a long run's registry
        # costs milliseconds a sweep.
        from ..telemetry import default_registry

        return float(default_registry().total("hashes_tried_total"))

    def sample(self, ctx):
        now = ctx.get("now", time.monotonic())
        total = self._total_hashes()
        if self._last is None:
            self._last = (now, total)
            return False, {}
        dt = now - self._last[0]
        dh = total - self._last[1]
        if dt <= 0 or dh <= 0:
            # No new work between samples (same flush tick, idle rank):
            # not evidence of collapse, not a sample.
            return False, {}
        self._last = (now, total)
        rate = dh / dt
        self._ewma = rate if self._ewma is None else \
            0.3 * rate + 0.7 * self._ewma
        self._samples += 1
        if self._samples <= self.warmup_n:
            self._baseline = self._ewma if self._baseline is None else \
                0.2 * self._ewma + 0.8 * self._baseline
            return False, {}
        # Past warmup the baseline keeps drifting SLOWLY so a long run's
        # legitimate plateau shift is absorbed, while a collapse is not.
        self._baseline = 0.02 * self._ewma + 0.98 * self._baseline
        breach = self._ewma < self.collapse_frac * self._baseline
        return breach, {"ewma_rate": round(self._ewma, 3),
                        "baseline_rate": round(self._baseline, 3),
                        "collapse_frac": self.collapse_frac}


class CollectiveSkewSpike(Rule):
    """``collective_skew_ms`` p95 (live registry histogram, per site)
    over the absolute bound. The histogram is populated by
    ``meshprof.analyzer.publish_skew`` from the ``mesh.sweep`` spans the
    ranks' shards carry; a world that never publishes skew never feeds
    this rule."""

    name = "collective_skew_spike"
    severity = "warn"

    def __init__(self):
        super().__init__()
        self.bound_ms = env_number("MPIBT_CHAINWATCH_SKEW_MS", 1000.0,
                                   cast=float, minimum=0)
        self.min_count = env_number("MPIBT_CHAINWATCH_SKEW_MIN_ROUNDS", 4,
                                    cast=int, minimum=1)

    def sample(self, ctx):
        from ..telemetry import default_registry

        worst = None
        # The live histograms, not a registry snapshot (see
        # HashrateCollapse._total_hashes): the same p95 and count.
        for m in default_registry().metrics():
            if m.name != "collective_skew_ms" or m.kind != "histogram":
                continue
            p95 = m.quantile(0.95)
            if p95 is None or m.count < self.min_count:
                continue
            if worst is None or p95 > worst[0]:
                worst = (p95, dict(m.labels).get("site", ""))
        if worst is None or worst[0] <= self.bound_ms:
            return False, {}
        return True, {"skew_p95_ms": round(worst[0], 3),
                      "site": worst[1], "bound_ms": self.bound_ms}


class HbmWatermarkGrowth(Rule):
    """Per-device ``last_bytes_in_use`` vs the first-seen in-run
    baseline: sustained growth past ``growth_factor``× (above an
    absolute floor, so small allocations can't trip it) is the
    out-of-memory precursor worth an incident before the allocator kills
    the run. Processes that never initialized CUDA sample ``{}`` and
    never fire."""

    name = "hbm_watermark_growth"
    severity = "warn"
    debounce_n = 3

    def __init__(self):
        super().__init__()
        self.growth_factor = env_number(
            "MPIBT_CHAINWATCH_HBM_GROWTH", 1.5, cast=float, minimum=1)
        self.floor_bytes = env_number(
            "MPIBT_CHAINWATCH_HBM_FLOOR", 64 * 1024 * 1024,
            cast=int, minimum=0)
        self._baseline: dict[str, float] = {}

    def sample(self, ctx):
        from ..meshprof.memory import memory_snapshot

        worst = None
        for dev, mark in memory_snapshot().items():
            cur = mark.get("last_bytes_in_use", 0)
            base = self._baseline.setdefault(dev, cur)
            if base <= 0 or cur < self.floor_bytes:
                continue
            ratio = cur / base
            if ratio > self.growth_factor and (
                    worst is None or ratio > worst[0]):
                worst = (ratio, dev, cur, base)
        if worst is None:
            return False, {}
        return True, {"device": worst[1], "growth": round(worst[0], 3),
                      "bytes_in_use": worst[2], "baseline_bytes": worst[3],
                      "growth_factor": self.growth_factor}


class StaleRank(Rule):
    """Mesh membership damage straight off the event ring:
    ``mesh_shrunk`` (an eviction), ``mesh_rank_stale``/
    ``mesh_rank_failed`` (a mesh aggregator's announcements) or
    ``rank_death`` since the last sample. Membership loss is definitive
    (no debounce), and the episode stays open until the ring goes quiet,
    so one lost rank is one incident. The port emits all four: the
    elastic mesh emits ``mesh_shrunk`` and ``rank_death``
    (``resilience/elastic.py``), the mesh aggregator ``mesh_rank_stale``
    and ``mesh_rank_failed`` (``meshwatch/aggregate.py``)."""

    name = "stale_rank"
    severity = "critical"
    debounce_n = 1

    WATCHED = ("mesh_shrunk", "mesh_rank_stale", "mesh_rank_failed",
               "rank_death")

    def __init__(self):
        super().__init__()
        self._since = None

    def sample(self, ctx):
        from ..telemetry.events import latest_seq, recent_with_seq

        if self._since is None:
            # First sample anchors past history: pre-install events are
            # the installer's context, not a live anomaly.
            self._since = latest_seq()
            return False, {}
        hits = [e for _, e in recent_with_seq(since=self._since)
                if e.get("event") in self.WATCHED]
        self._since = latest_seq()
        if not hits:
            return False, {}
        last = hits[-1]
        return True, {"events": len(hits), "last_event": last.get("event"),
                      "rank": last.get("evicted", last.get("rank")),
                      "reason": last.get("reason", "")}


class BubbleRegression(Rule):
    """Pipeline ``bubble_fraction`` regression vs the in-run baseline.

    Reads ``pipeline_report`` over the profiler's recent records
    (interval math over a bounded tail), throttled to at most one real
    computation per ``min_interval_s`` (throttled samples cost one clock
    read). Absolute bubble depends on the backend (the C++ sweep's is all
    bubble); only a regression against this run's own warmup baseline
    fires."""

    name = "bubble_regression"
    severity = "warn"
    debounce_n = 3

    TAIL = 128

    def __init__(self):
        super().__init__()
        self.warmup_n = env_number("MPIBT_CHAINWATCH_BUBBLE_WARMUP", 6,
                                   cast=int, minimum=2)
        self.margin = env_number("MPIBT_CHAINWATCH_BUBBLE_MARGIN", 0.3,
                                 cast=float, minimum=0)
        self.min_interval_s = env_number(
            "MPIBT_CHAINWATCH_BUBBLE_INTERVAL", 0.5, cast=float, minimum=0)
        self._last_eval = 0.0
        self._baseline = None
        self._samples = 0
        self._breach_hold = False

    def sample(self, ctx):
        now = ctx.get("now", time.monotonic())
        if now - self._last_eval < self.min_interval_s:
            # Throttled: hold the last verdict so debounce streaks are
            # counted in real samples, not in call frequency.
            return self._breach_hold, {}
        self._last_eval = now
        from ..meshwatch.pipeline import pipeline_report, profiler

        rep = pipeline_report(profiler().records(tail=self.TAIL))
        bubble = rep.get("bubble_fraction")
        if bubble is None:
            self._breach_hold = False
            return False, {}
        self._samples += 1
        if self._samples <= self.warmup_n or self._baseline is None:
            self._baseline = bubble if self._baseline is None else \
                0.5 * bubble + 0.5 * self._baseline
            self._breach_hold = False
            return False, {}
        # bubble_fraction <= 1.0, so a baseline within `margin` of full
        # idle can never breach — regression detection, not an absolute
        # bound (the C++ sweep's natural bubble is not an SLO).
        breach = bubble > self._baseline + self.margin
        if not breach:
            self._baseline = 0.1 * bubble + 0.9 * self._baseline
        self._breach_hold = breach
        return breach, {"bubble_fraction": bubble,
                        "baseline": round(self._baseline, 4),
                        "margin": self.margin}


class EventStorm(Rule):
    """Burst of damage-absorption events (``STORM_EVENTS``) over the
    ring: ``storm_n`` or more inside ``window_s`` breaches. A healthy run
    emits none of these; a run riding its retry budget hard is degrading
    even when every retry succeeds."""

    name = "event_storm"
    severity = "warn"
    debounce_n = 1

    def __init__(self):
        super().__init__()
        self.storm_n = env_number("MPIBT_CHAINWATCH_STORM_N", 10,
                                  cast=int, minimum=1)
        self.window_s = env_number("MPIBT_CHAINWATCH_STORM_WINDOW", 10.0,
                                   cast=float, minimum=0.1)
        self._since = None
        self._times: collections.deque = collections.deque(maxlen=4096)

    def sample(self, ctx):
        from ..telemetry.events import latest_seq, recent_with_seq

        now = ctx.get("now", time.monotonic())
        if self._since is None:
            self._since = latest_seq()
            return False, {}
        hits = [e for _, e in recent_with_seq(since=self._since)
                if e.get("event") in STORM_EVENTS]
        self._since = latest_seq()
        for e in hits:
            self._times.append((now, e.get("event")))
        while self._times and now - self._times[0][0] > self.window_s:
            self._times.popleft()
        if len(self._times) < self.storm_n:
            return False, {}
        kinds = collections.Counter(k for _, k in self._times)
        return True, {"events": len(self._times),
                      "window_s": self.window_s,
                      "kinds": dict(sorted(kinds.items()))}


class RecompileStorm(Rule):
    """Compile churn off the dispatchwatch census: total compiles
    (``nvcc`` builds, k-block programs) growing after the warmup samples
    breaches. A healthy steady-state run builds the kernel library at
    most once and each k-block program once, during warmup, and never
    again; later growth means some seam keeps recompiling. The first
    ``warmup_n`` samples absorb startup compilation; ``allowed`` compiles
    per sample are tolerated after that (default 0: any growth is churn).
    Processes that never compiled sample ``{}`` and never fire; the
    incident detail carries the per-site census."""

    name = "recompile_storm"
    severity = "warn"

    def __init__(self):
        super().__init__()
        self.warmup_n = env_number("MPIBT_CHAINWATCH_RECOMPILE_WARMUP", 4,
                                   cast=int, minimum=1)
        self.allowed = env_number("MPIBT_CHAINWATCH_RECOMPILE_ALLOWED", 0,
                                  cast=int, minimum=0)
        self._prev_total = None
        self._samples = 0

    def sample(self, ctx):
        from ..dispatchwatch import compile_census

        census = compile_census()
        if not census:
            return False, {}
        total = sum(int(st.get("compiles", 0)) for st in census.values())
        prev, self._prev_total = self._prev_total, total
        if prev is None:
            return False, {}
        self._samples += 1
        grown = total - prev
        if self._samples <= self.warmup_n or grown <= self.allowed:
            return False, {}
        return True, {"compiles_total": total, "grown": grown,
                      "allowed": self.allowed,
                      "sites": {site: int(st.get("compiles", 0))
                                for site, st in census.items()}}


class MempoolSaturation(Rule):
    """The front door under sustained overload: the door shedding more
    than ``shed_n`` requests between samples, or the pool at or above
    ``full_frac`` of its capacity. Transient spikes ride the debounce; the
    episode clears by hysteresis once the pool drains and sheds stop.
    Processes with no door sample ``{}`` and never fire, and an idle door
    never breaches. The incident detail carries the shed breakdown and
    depth."""

    name = "mempool_saturation"
    severity = "warn"

    def __init__(self):
        super().__init__()
        self.shed_n = env_number("MPIBT_CHAINWATCH_MEMPOOL_SHED_N", 5,
                                 cast=int, minimum=1)
        self.full_frac = env_number("MPIBT_CHAINWATCH_MEMPOOL_FRAC", 0.95,
                                    cast=float, minimum=0)
        self._prev_shed = None

    def sample(self, ctx):
        from ..service import service_stats

        stats = service_stats()
        if not stats:
            return False, {}
        shed_total = sum((stats.get("shed_total") or {}).values())
        prev, self._prev_shed = self._prev_shed, shed_total
        pool = stats.get("mempool") or {}
        depth, cap = int(pool.get("depth", 0)), int(pool.get("cap", 0))
        full = cap > 0 and depth >= self.full_frac * cap
        shed_delta = 0 if prev is None else shed_total - prev
        if shed_delta < self.shed_n and not full:
            return False, {}
        return True, {"depth": depth, "cap": cap,
                      "shed_delta": shed_delta,
                      "shed_total": dict(stats.get("shed_total") or {}),
                      "accept_gate": stats.get("accept_gate") or {},
                      "full_frac": self.full_frac}


def default_rules() -> list[Rule]:
    """Fresh instances of the full catalogue, evaluation order fixed
    (the reference's)."""
    return [HashrateCollapse(), CollectiveSkewSpike(),
            HbmWatermarkGrowth(), StaleRank(), BubbleRegression(),
            EventStorm(), RecompileStorm(), MempoolSaturation()]
