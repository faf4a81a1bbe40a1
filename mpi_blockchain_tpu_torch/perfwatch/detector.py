"""Spread-aware perf-regression detection over the history store.

The port's copy of the reference's ``perfwatch/detector.py``. For every
series (history key) the baseline is the best prior value, max for
higher-is-better metrics and min for lower-is-better ones. The newest
entry, or an unrecorded candidate payload, regresses when it falls short
of that baseline by more than

    max(threshold_pct, k * spread_pct, the section's floor)

where ``spread_pct`` is the larger of the candidate's and the baseline's
recorded spread. Sections in ``SECTION_BOUNDS`` are judged instead by an
absolute bound on the metric's value: ``serve`` caps the serve smoke's
p99 submit latency at 2000 ms, generous on purpose, since admission is
microseconds of host work and the bound is there to catch a wedged or
queueing door. Findings carry their arithmetic, and ``improved`` and
``insufficient-history`` verdicts are reported too, so that a green check
can be told from a vacuous one.
"""
from __future__ import annotations

import dataclasses

from .history import SECTION_METRICS, Entry, HistoryStore, entry_key

DEFAULT_THRESHOLD_PCT = 10.0
DEFAULT_SPREAD_K = 2.0

# Per-section noise floors that beat the global threshold (host-time
# series on a shared box).
SECTION_FLOOR_PCT = {"cpu_np8": 60.0, "sim_adversarial": 60.0}

# Sections judged by an ABSOLUTE bound on the metric's value, not a
# relative drop from the best prior: {section: max allowed value}.
SECTION_BOUNDS = {"trace_overhead": 3.0, "trace_block_observe": 300.0,
                  "pipeline_bubble": 0.15, "collective_skew": 10000.0,
                  "compile_cache": 0.0, "serve": 2000.0}


@dataclasses.dataclass(frozen=True)
class Finding:
    key: str
    section: str
    metric: str
    direction: str
    verdict: str          # "regression" | "ok" | "improved"
                          # | "insufficient-history"
    candidate: float | None = None
    baseline: float | None = None
    baseline_at: str | None = None
    delta_pct: float | None = None     # positive = worse, by direction
    allowed_pct: float | None = None   # max(threshold, k*spread) | bound
    spread_pct: float | None = None
    # WHICH allowance won the max (the threshold that actually applied):
    # "threshold" | "spread" | "section-floor" | "absolute-bound".
    basis: str | None = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    def render(self) -> str:
        """The text verdict, carrying the candidate-vs-baseline delta
        AND the threshold that applied — the gate's arithmetic must be
        auditable from the terminal, not only from --json."""
        if self.verdict == "insufficient-history":
            return f"{self.key}: insufficient history (1 entry)"
        arrow = {"regression": "REGRESSION", "improved": "improved",
                 "ok": "ok"}[self.verdict]
        basis = f" [{self.basis}]" if self.basis else ""
        if self.basis == "absolute-bound":
            return (f"{self.key}: {arrow} {self.metric}="
                    f"{self.candidate:g} vs bound {self.allowed_pct:g} "
                    f"(absolute budget, no baseline){basis}")
        return (f"{self.key}: {arrow} {self.metric}={self.candidate:g} "
                f"vs baseline {self.baseline:g} "
                f"(delta {self.delta_pct:+.1f}%, positive = worse; "
                f"allowed {self.allowed_pct:.1f}%{basis})")


def _delta_worse_pct(direction: str, baseline: float,
                     candidate: float) -> float:
    """How much worse the candidate is than the baseline, in percent of
    the baseline; negative = better."""
    scale = max(abs(baseline), 1e-12)
    if direction == "higher":
        return 100.0 * (baseline - candidate) / scale
    return 100.0 * (candidate - baseline) / scale


def _judge(key: str, baseline_pool: list[Entry], candidate: Entry,
           threshold_pct: float, k: float) -> Finding:
    metric, direction = candidate.metric
    if not baseline_pool:
        return Finding(key=key, section=candidate.section, metric=metric,
                       direction=direction or "",
                       verdict="insufficient-history",
                       candidate=candidate.value)
    pick = max if direction == "higher" else min
    best = pick(baseline_pool, key=lambda e: e.value)
    delta = _delta_worse_pct(direction, best.value, candidate.value)
    spread = max(candidate.spread_pct, best.spread_pct)
    floor = SECTION_FLOOR_PCT.get(candidate.section, 0.0)
    allowed = max(threshold_pct, k * spread, floor)
    basis = ("section-floor" if allowed == floor and floor > threshold_pct
             else "spread" if allowed == k * spread
             and k * spread > threshold_pct
             else "threshold")
    verdict = ("regression" if delta > allowed
               else "improved" if delta < 0 else "ok")
    return Finding(key=key, section=candidate.section, metric=metric,
                   direction=direction, verdict=verdict,
                   candidate=candidate.value, baseline=best.value,
                   baseline_at=best.recorded_at,
                   delta_pct=round(delta, 2),
                   allowed_pct=round(allowed, 2),
                   spread_pct=round(spread, 2), basis=basis)


def _judge_bound(key: str, candidate: Entry) -> Finding:
    """Absolute-bound sections (SECTION_BOUNDS): the metric VALUE must
    stay under the budget — no baseline, no spread, no history needed."""
    metric, _ = candidate.metric
    bound = SECTION_BOUNDS[candidate.section]
    verdict = "regression" if candidate.value > bound else "ok"
    return Finding(key=key, section=candidate.section, metric=metric,
                   direction="bounded", verdict=verdict,
                   candidate=candidate.value,
                   allowed_pct=bound, basis="absolute-bound")


def check_history(store: HistoryStore,
                  threshold_pct: float = DEFAULT_THRESHOLD_PCT,
                  k: float = DEFAULT_SPREAD_K) -> list[Finding]:
    """Judges the NEWEST entry of every series against the best of the
    rest. Newest by ``recorded_at`` (ISO-8601 Z strings sort
    lexicographically; the stable sort keeps file order for ties), NOT
    by file position: a late backfill lands at the end of the file but
    carries its historical timestamp, and must become baseline, not
    candidate. Series whose section has direction None are skipped."""
    findings: list[Finding] = []
    for key, entries in sorted(store.by_key().items()):
        ordered = sorted(entries, key=lambda e: e.recorded_at)
        newest = ordered[-1]
        if newest.section in SECTION_BOUNDS:
            findings.append(_judge_bound(key, newest))
            continue
        if entries[0].metric[1] is None:
            continue
        findings.append(_judge(key, ordered[:-1], newest,
                               threshold_pct, k))
    return findings


def check_candidate(store: HistoryStore, section: str, payload: dict,
                    threshold_pct: float = DEFAULT_THRESHOLD_PCT,
                    k: float = DEFAULT_SPREAD_K) -> Finding:
    """Judges an un-recorded payload (the merge-gate shape: measure,
    check, only record when accepted) against the FULL history of its
    series."""
    spec = SECTION_METRICS.get(section)
    if spec is None or (spec[1] is None and section not in SECTION_BOUNDS):
        checked = sorted(s for s, (_, d) in SECTION_METRICS.items()
                         if d or s in SECTION_BOUNDS)
        raise ValueError(f"section {section!r} is not regression-checked; "
                         f"have {checked}")
    if spec[0] not in payload:
        raise ValueError(f"payload lacks {section!r}'s metric {spec[0]!r}")
    cand = Entry(section=section, key=entry_key(section, payload),
                 recorded_at="", source="candidate", payload=dict(payload))
    if section in SECTION_BOUNDS:
        return _judge_bound(cand.key, cand)
    pool = [e for e in store.entries(section) if e.key == cand.key]
    return _judge(cand.key, pool, cand, threshold_pct, k)


def regressions(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.verdict == "regression"]
