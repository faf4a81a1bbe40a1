"""Splits the telemetry self-overhead audit's per-round delta on one NVIDIA
GPU into where the instrumented round spends its extra time.

    python -m mpi_blockchain_tpu_torch.tools.overhead_split \\
        [--seconds 2.0] [--reps 3] [--chunk-pow2 24]

``blocktrace.overhead.measure_trace_overhead`` prices a round (one sweep
and its read-back) instrumented against the same round with the telemetry
off, as one number. This tool runs the same paired rounds, through the
audit's own ``_instrumented_round``, with the sweep stamped on the host's
clock, and splits each round into:

- ``pre``: the emits before the launch call (trace context, dispatch
  record, segments, span);
- ``launch``: the launch call (with its timing event pair when timed);
- ``wait``: from the launch's return to the read-back's;
- ``timing``: reading the timing events (timed sweeps only);
- ``post``: the emits after the sweep (counters, heartbeat, skew span,
  compile scope, watchdog step).

It pairs, each against an off round, three "on" variants: ``full`` (the
audit: emits on, a timed sweep), ``emits`` (emits on, a sweep with its one
plain event) and ``timed`` (emits off, a timed sweep). It also times the
emit pattern alone in a hot loop (a sweep that does nothing), on and off,
and, in ``pieces``, each emit of the round on its own: the round's body
written out with a stamp between emits (``_stamped_round``, which follows
``_instrumented_round``), in the same pairs, each piece's median on and
off (µs) after a real sweep and in the hot loop.

Prints one line for each variant, and as the last line one JSON object:
for each variant the median per-pair delta (µs and % of the off round)
and each segment's median on and off (µs), the hot loop's median on and
off (µs), the pieces, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

SEGMENTS = ("pre", "launch", "wait", "timing", "post")
VARIANTS = {"full": (True, True), "emits": (True, False),
            "timed": (False, True)}


def _stamped_sweep(device: str, stamps: dict, timed_override: list):
    """The audit's sweep on ``device`` with host stamps around its launch,
    read-back and timing read; ``timed_override[0]``, when not None,
    decides the timing events instead of the telemetry switch."""
    import torch

    from .. import core
    from ..blocktrace.overhead import _HEADER, _IMPOSSIBLE_DIFFICULTY
    from ..ops import extend_midstate, sha256_cuda
    from ..telemetry import telemetry_disabled

    dev = torch.device(device)
    ext = extend_midstate(*core.header_midstate(_HEADER))

    def sweep(base: int, chunk: int):
        timed = timed_override[0]
        if timed is None:
            timed = not telemetry_disabled()
        stamps["enter"] = time.perf_counter()
        with sha256_cuda.timed_launches(timed):
            launched = sha256_cuda.sweep_launch(
                ext, base % (1 << 32), chunk, _IMPOSSIBLE_DIFFICULTY,
                device=dev)
        stamps["launched"] = time.perf_counter()
        res = launched.result()
        stamps["read"] = time.perf_counter()
        if launched.timed:
            launched.timing()
        stamps["exit"] = time.perf_counter()
        return res
    return sweep


def _round(profiler, height: int, base: int, chunk: int, sweep,
           stamps: dict, emits: bool) -> dict:
    """One audit round; its wall and segments in microseconds."""
    from ..blocktrace.overhead import _instrumented_round
    from ..telemetry import set_telemetry_disabled

    prev = set_telemetry_disabled(not emits)
    try:
        t0 = time.perf_counter()
        _instrumented_round(profiler, height, base, chunk, sweep)
        t1 = time.perf_counter()
    finally:
        set_telemetry_disabled(prev)
    marks = (t0, stamps["enter"], stamps["launched"], stamps["read"],
             stamps["exit"], t1)
    out = {name: (marks[i + 1] - marks[i]) * 1e6
           for i, name in enumerate(("pre", "launch", "wait", "timing",
                                     "post"))}
    out["wall"] = (t1 - t0) * 1e6
    return out


def split(variant: str, seconds: float, reps: int, chunk: int,
          device: str) -> dict:
    """Paired rounds of ``variant`` against off rounds, alternating which
    goes first, for ``reps`` repetitions of ``seconds`` each."""
    from ..meshwatch.pipeline import PipelineProfiler

    emits, timed = VARIANTS[variant]
    stamps: dict = {}
    override: list = [None]
    sweep = _stamped_sweep(device, stamps, override)
    on_rounds, off_rounds, deltas = [], [], []
    base = height = 0
    for _ in range(max(1, reps)):
        profiler = PipelineProfiler()
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline or not deltas:
            first_on = len(deltas) % 2 == 0
            pair = {}
            for on in ((True, False) if first_on else (False, True)):
                override[0] = timed if on else False
                height += 1
                pair[on] = _round(profiler, height, base, chunk, sweep,
                                  stamps, emits if on else False)
                base += chunk
            on_rounds.append(pair[True])
            off_rounds.append(pair[False])
            deltas.append(pair[True]["wall"] - pair[False]["wall"])
    off_wall = statistics.median(r["wall"] for r in off_rounds)
    return {
        "pairs": len(deltas),
        "delta_us": round(statistics.median(deltas), 2),
        "delta_pct": round(100.0 * statistics.median(
            d / off["wall"] for d, off in zip(deltas, off_rounds)), 3),
        "off_wall_us": round(off_wall, 2),
        "on": {s: round(statistics.median(r[s] for r in on_rounds), 2)
               for s in SEGMENTS},
        "off": {s: round(statistics.median(r[s] for r in off_rounds), 2)
                for s in SEGMENTS},
    }


def hot_loop(rounds: int = 20000) -> dict:
    """The emit pattern alone, a sweep that does nothing: median µs a
    round, on and off."""
    from ..blocktrace.overhead import _instrumented_round
    from ..meshwatch.pipeline import PipelineProfiler
    from ..telemetry import set_telemetry_disabled

    out = {}
    for on in (True, False, True, False):
        profiler = PipelineProfiler()
        prev = set_telemetry_disabled(not on)
        times = []
        try:
            for i in range(rounds):
                t0 = time.perf_counter()
                _instrumented_round(profiler, i + 2, 0, 1,
                                    lambda base, chunk: None)
                times.append(time.perf_counter() - t0)
        finally:
            set_telemetry_disabled(prev)
        out["on" if on else "off"] = round(
            statistics.median(times) * 1e6, 2)
    return out


PIECES = ("trace_enter", "dispatch", "enqueue", "span_enter",
          "device_enter", "sweep", "device_exit", "span_exit", "counters",
          "heartbeat", "skew_span", "compile_scope", "watchdog",
          "trace_exit")


def _stamped_round(profiler, height: int, base: int, chunk: int,
                   sweep) -> list:
    """``_instrumented_round`` with a host stamp after each emit; returns
    the stamps (the first before the round)."""
    from .. import chainwatch
    from ..blocktrace.context import trace_block
    from ..dispatchwatch import compile_scope, note_cache
    from ..meshprof.spans import skew_span
    from ..telemetry import counter, heartbeat
    from ..telemetry.spans import span

    clock = time.perf_counter
    t = [clock()]
    tb = trace_block(height)
    tb.__enter__()
    t.append(clock())
    prec = profiler.dispatch(kind="sweep", height=height,
                             backend="trace-audit")
    t.append(clock())
    with prec.segment("enqueue"):
        pass
    t.append(clock())
    sp = span("miner.sweep", height=height)
    sp.__enter__()
    t.append(clock())
    seg = prec.segment("device")
    seg.__enter__()
    t.append(clock())
    sweep(base, chunk)
    t.append(clock())
    seg.__exit__(None, None, None)
    t.append(clock())
    sp.__exit__(None, None, None)
    t.append(clock())
    counter("mining_rounds_total", help="backend sweep rounds issued",
            backend="trace-audit").inc()
    counter("hashes_tried_total",
            help="nonces evaluated across all sweeps",
            backend="trace-audit").inc(chunk)
    t.append(clock())
    heartbeat("bench_heartbeat").inc()
    t.append(clock())
    with skew_span(site="trace-audit"):
        pass
    t.append(clock())
    with compile_scope(site="trace-audit"):
        pass
    if height <= 1:
        note_cache(site="trace-audit", entries=1)
    t.append(clock())
    chainwatch.evaluate(height=height, source="audit")
    t.append(clock())
    tb.__exit__(None, None, None)
    t.append(clock())
    return t


def pieces(seconds: float, chunk: int, device: str) -> dict:
    """Each emit's median µs, on and off, after a real sweep (paired
    rounds as in ``split``) and in the hot loop."""
    from ..meshwatch.pipeline import PipelineProfiler
    from ..telemetry import set_telemetry_disabled

    real = _stamped_sweep(device, {}, [None])
    out = {}
    for where, sweep, budget in (("card", real, seconds),
                                 ("hot", lambda base, n: None, seconds)):
        profiler = PipelineProfiler()
        rows = {True: [], False: []}
        height = base = 0
        deadline = time.perf_counter() + budget
        while time.perf_counter() < deadline or not rows[True]:
            for on in ((True, False) if height % 4 == 0
                       else (False, True)):
                height += 1
                prev = set_telemetry_disabled(not on)
                try:
                    stamps = _stamped_round(profiler, height + 1, base,
                                            chunk, sweep)
                finally:
                    set_telemetry_disabled(prev)
                base += chunk
                rows[on].append([(b - a) * 1e6 for a, b in
                                 zip(stamps, stamps[1:])])
        out[where] = {
            name: [round(statistics.median(r[i] for r in rows[on]), 2)
                   for on in (True, False)]
            for i, name in enumerate(PIECES)}
        out[where]["pairs"] = len(rows[True])
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.tools.overhead_split",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chunk-pow2", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from .. import chainwatch

    if not torch.cuda.is_available():
        print("overhead_split: no CUDA device", file=sys.stderr)
        return 2
    chunk = 1 << args.chunk_pow2
    sweep = _stamped_sweep(args.device, {}, [None])
    sweep(0, chunk)                   # the kernel library built and loaded
    was_armed = chainwatch.installed()
    if not was_armed:
        chainwatch.install()
    try:
        result = {v: split(v, args.seconds, args.reps, chunk, args.device)
                  for v in VARIANTS}
        result["hot_loop_us"] = hot_loop()
        result["pieces_us_on_off"] = pieces(args.seconds, chunk,
                                            args.device)
    finally:
        if not was_armed:
            chainwatch.uninstall()
    for v in VARIANTS:
        print(f"{v}: {json.dumps(result[v])}")
    result["card"] = card()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
