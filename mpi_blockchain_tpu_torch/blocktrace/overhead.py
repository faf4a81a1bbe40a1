"""Telemetry self-overhead audit: what does always-on tracing cost?

The port's copy of the reference's ``blocktrace/overhead.py``. It prices
the whole instrumentation stack as one number: one sweep round is run with
the identical loop body, once fully instrumented with the miner's
per-round emit pattern (block trace context, spans, counters, heartbeat,
a pipeline dispatch with segments, a skew span, a compile scope, the
watchdog step) and once under ``MPIBT_TELEMETRY_OFF`` (every emit point a
flag check), and

    overhead_pct = 100 * (t_on - t_off) / t_off

is the ``trace_overhead`` payload, held to the reference's absolute 3%
bound (``perfwatch.detector.SECTION_BOUNDS``).

The round: on a CUDA device, one sweep of 2^chunk_pow2 nonces through
``sha256_cuda.sweep_launch`` and its read-back, at a difficulty nothing
meets (a full sweep, no early exit); the default, 2^24, is the main
path's sweep of one block. Instrumented, the sweep is the stamped build,
whose read-back brings its span on the card, and its window is taken from
those stamps, as the pipelined ``Miner`` launches and consumes it; off,
the plain build. Each carries one plain completion event. On the CPU it
is the C++ ``cpu_search`` of 2^13 nonces, the reference's round.

The per-block critical-path observation (``observe_block_metrics``) does
not fire per sweep round; ``measure_block_observe`` prices it alone: the
median microseconds of one observation, each sample timed right after an
un-timed instrumented round, as in the mining loop.

Noise: host noise is multiplicative and slow, so each sample runs one
instrumented and one off round back to back, alternating which goes
first, and the estimate is the median of the per-pair deltas pooled over
all repetitions. The instrumented half emits into a local pipeline
profiler and metric series labeled ``backend="trace-audit"``, so the
audit does not touch the run's own telemetry.
"""
from __future__ import annotations

import statistics
import time

from .. import chainwatch, core
from ..dispatchwatch import compile_scope, note_cache
from ..meshprof.spans import skew_span
from ..telemetry import (counter, heartbeat, set_telemetry_disabled,
                         telemetry_disabled)
from ..telemetry.spans import span
from .context import trace_block
from .critical_path import observe_block_metrics

_IMPOSSIBLE_DIFFICULTY = 64   # pure sweep: no winner, no early exit
_HEADER = bytes(range(80))


def _sweep_fn(device: str):
    """The round's sweep on ``device``: ``fn(base, count)``."""
    if device == "cpu":
        return lambda base, chunk: core.cpu_search(
            _HEADER, base, chunk, _IMPOSSIBLE_DIFFICULTY)
    import torch

    from ..ops import extend_midstate, sha256_cuda

    dev = torch.device(device)
    ext = extend_midstate(*core.header_midstate(_HEADER))

    def sweep(base: int, chunk: int):
        # As the pipelined Miner's issue and consume: instrumented, the
        # sweep is stamped and its window read from the stamps that came
        # back with its result; off, the plain build.
        with sha256_cuda.timed_launches(not telemetry_disabled()):
            launched = sha256_cuda.sweep_launch(
                ext, base % (1 << 32), chunk, _IMPOSSIBLE_DIFFICULTY,
                device=dev)
        res = launched.result()
        if launched.timed:
            launched.timing()
        return res
    return sweep


def _instrumented_round(profiler, height: int, base: int, chunk: int,
                        sweep):
    """The miner's per-round emit pattern: trace context, dispatch record,
    enqueue/device segments, sweep span, round and hash counters,
    heartbeat, skew span, compile scope, watchdog step. The one copy both
    audits run. Returns the round's dispatch record."""
    with trace_block(height):
        prec = profiler.dispatch(kind="sweep", height=height,
                                 backend="trace-audit")
        with prec.segment("enqueue"):
            pass
        with span("miner.sweep", height=height), \
                prec.segment("device"):
            sweep(base, chunk)
        counter("mining_rounds_total",
                help="backend sweep rounds issued",
                backend="trace-audit").inc()
        counter("hashes_tried_total",
                help="nonces evaluated across all sweeps",
                backend="trace-audit").inc(chunk)
        heartbeat("bench_heartbeat").inc()
        with skew_span(site="trace-audit"):
            pass
        # The cache note is a per-cache-miss emit: priced once, on the
        # first round, at its real cadence.
        with compile_scope(site="trace-audit"):
            pass
        if height <= 1:
            note_cache(site="trace-audit", entries=1)
        # The watchdog step: the audits arm chainwatch, so the on half
        # pays the real throttle and rules, the off half a flag check.
        chainwatch.evaluate(height=height, source="audit")
    return prec


def _one_round(profiler, rounds: int, base: int, chunk: int, sweep,
               instrumented: bool) -> float:
    """One sweep round; returns its wall seconds. The body is identical in
    both halves; only the kill switch differs."""
    prev = set_telemetry_disabled(not instrumented)
    try:
        t0 = time.perf_counter()
        _instrumented_round(profiler, rounds + 1, base, chunk, sweep)
        return time.perf_counter() - t0
    finally:
        set_telemetry_disabled(prev)


def _paired_rep(seconds: float, chunk: int, sweep,
                null: bool = False) -> tuple[list, float, float]:
    """One repetition: paired rounds until the wall budget runs out;
    returns (per-pair delta pcts, fastest on-round rate, fastest off-round
    rate). ``null`` runs both halves off."""
    from ..meshwatch.pipeline import PipelineProfiler

    profiler = PipelineProfiler()
    deltas: list[float] = []
    best_on = best_off = float("inf")
    base = 0
    rounds = 0
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline or not deltas:
        first_on = len(deltas) % 2 == 0
        t_a = _one_round(profiler, rounds, base, chunk, sweep,
                         first_on and not null)
        base += chunk
        rounds += 1
        t_b = _one_round(profiler, rounds, base, chunk, sweep,
                         not first_on and not null)
        base += chunk
        rounds += 1
        t_on, t_off = (t_a, t_b) if first_on else (t_b, t_a)
        deltas.append(100.0 * (t_on - t_off) / t_off)
        best_on = min(best_on, t_on)
        best_off = min(best_off, t_off)
    return (deltas, chunk / best_on, chunk / best_off)


def _armed():
    """Arms chainwatch for an audit; returns whether it was armed
    before (the caller disarms only what it armed)."""
    was_armed = chainwatch.installed()
    if not was_armed:
        chainwatch.install()
    return was_armed


def measure_block_observe(samples: int = 400, chunk_pow2: int = 11,
                          device: str = "cpu") -> dict:
    """The ``trace_block_observe`` payload: the median microseconds one
    per-block critical-path observation costs, each sample observing a
    freshly instrumented round's own record right after the (un-timed)
    round ran."""
    from ..meshwatch.pipeline import PipelineProfiler

    profiler = PipelineProfiler()
    sweep = _sweep_fn(device)
    chunk = 1 << chunk_pow2
    times: list[float] = []
    base = 0
    prev = set_telemetry_disabled(False)
    was_armed = _armed()
    try:
        for i in range(max(8, samples)):
            prec = _instrumented_round(profiler, i + 1, base, chunk, sweep)
            base += chunk
            t0 = time.perf_counter()
            observe_block_metrics(i + 1, records=[prec.record],
                                  backend="trace-audit")
            times.append((time.perf_counter() - t0) * 1e6)
    finally:
        set_telemetry_disabled(prev)
        if not was_armed:
            chainwatch.uninstall()
    times.sort()
    return {
        "backend": _backend_name(device),
        "chunk_pow2": chunk_pow2,
        "samples": len(times),
        "block_observe_us": round(statistics.median(times), 1),
        "p90_us": round(times[int(0.9 * (len(times) - 1))], 1),
    }


def _backend_name(device: str) -> str:
    return "cpu" if device == "cpu" else "cuda"


def measure_trace_overhead(seconds: float = 1.0, reps: int = 3,
                           chunk_pow2: int | None = None,
                           device: str = "cpu", null: bool = False) -> dict:
    """The ``trace_overhead`` payload: ``overhead_pct`` is the median over
    all pairs pooled across ``reps`` repetitions. May be negative on a
    noisy host; the bound only limits the upside. ``chunk_pow2`` defaults
    to 24 on a CUDA device (a block's sweep on the main path) and 13 on
    the CPU (the reference's round). ``null`` runs both halves with the
    telemetry off: the estimator's own zero on this host."""
    if chunk_pow2 is None:
        chunk_pow2 = 13 if device == "cpu" else 24
    chunk = 1 << chunk_pow2
    sweep = _sweep_fn(device)
    sweep(0, chunk)    # warm: the kernel library is built and loaded
    was_armed = _armed()
    try:
        rep_runs = [_paired_rep(seconds, chunk, sweep, null)
                    for _ in range(max(1, reps))]
    finally:
        if not was_armed:
            chainwatch.uninstall()
    pooled = [d for deltas, _, _ in rep_runs for d in deltas]
    rep_medians = [statistics.median(deltas) for deltas, _, _ in rep_runs]
    return {
        "backend": _backend_name(device),
        "chunk_pow2": chunk_pow2,
        "seconds_per_rep": seconds,
        "reps": len(rep_runs),
        "pairs": len(pooled),
        "hashes_per_sec_instrumented": round(
            max(on for _, on, _ in rep_runs), 1),
        "hashes_per_sec_off": round(
            max(off for _, _, off in rep_runs), 1),
        "overhead_pct": round(statistics.median(pooled), 3),
        "spread_pct": round(max(rep_medians) - min(rep_medians), 2),
        "all_overhead_pct": [round(m, 3) for m in rep_medians],
    }
