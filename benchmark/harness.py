"""One run of one cell: set-up, the timed window, the traced sub-window,
the comparison with the reference, the result line.

    python -m benchmark --workload fused-d24 --seed 7 --seconds 20 --trace 0

The run:

1. finds the cell's files by name (``spec``) and refuses to run without
   as many CUDA devices as the cell asks for;
2. makes the cell's driver (``drivers/<driver>.py``) with the chain's
   payload prefix made from ``--seed``, and warms it up: the program's
   libraries built or loaded, one k-block call of the cell's difficulty;
   ``setup_s`` runs from the process's start to the first timed block;
3. mines spans of the cell's size until ``--seconds`` have passed: the
   window ends at the end of the span that crosses it, and every block
   appended in it counts;
4. with ``--trace 1``, mines one more span inside a profiler capture
   (``devtrace``);
5. reads the device's memory peak, then compares the whole chain, as the
   program's node holds it, with the reference (``reference``), on every
   rank of a world;
6. prints each number compared beside its limit on stderr, and one JSON
   line on stdout: the end-to-end metrics with ``--trace 0``, the
   per-layer ones with ``--trace 1``, each read by the file of its name
   (``metrics/<name>.py``).

Nothing here imports JAX or the JAX package; a run that finds either in
``sys.modules`` once its window has closed prints no result and fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

from . import devtrace, reference, spec

#: Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_blockchain_tpu")


@dataclasses.dataclass(frozen=True)
class Block:
    height: int
    nonce: int
    extra_nonce: int
    t: float            # host perf_counter when its append was logged

    @property
    def needed(self) -> int:
        return reference.needed_nonces(self.nonce, self.extra_nonce)


@dataclasses.dataclass
class Ctx:
    """What a driver is made from."""
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str                  # "cuda" or "cpu"
    rank: int = 0
    port: int | None = None
    launch: object = None        # starts another rank's process (worlds)

    @property
    def prefix(self) -> str:
        return f"seed-{self.seed}"

    @property
    def difficulty(self) -> int:
        return int(self.cell.config["difficulty_bits"])

    def blocks_for(self, key: str, multiple: int = 1) -> int:
        """Blocks of a span of 2^traffic[key] needed nonces, a whole
        number of ``multiple`` and at least one of it."""
        n = 1 << max(int(self.cell.traffic[key]) - self.difficulty, 0)
        return max(n // multiple, 1) * multiple


@dataclasses.dataclass
class Rank:
    """What one rank's run leaves for the comparison and the readers."""
    blocks: list
    window_s: float
    t_parent: float     # when the block before the window's first was logged
    spans: dict
    skew: list
    trace: devtrace.Trace | None
    trace_blocks: list
    memory_peak: int
    chain: bytes
    hashes: list
    logged: list        # (height, nonce) of every block logged, in order


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    cell: spec.Cell
    setup_s: float
    window_s: float
    blocks: list                 # rank 0's blocks appended in the window
    t_parent: float              # when the block before them was logged
    spans: dict                  # program span -> (count, seconds), window
    skew: list                   # rank 0's mesh.sweep spans, seconds
    trace: devtrace.Trace | None
    trace_blocks: list           # blocks mined in the traced sub-window


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (``/proc/self/stat`` field 22) against the uptime."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def span_totals() -> dict:
    """The program's ``span_seconds``: span -> (count, seconds)."""
    from mpi_blockchain_tpu_torch.telemetry import default_registry

    out = {}
    for m in default_registry().metrics():
        if m.name == "span_seconds":
            out[dict(m.labels).get("span")] = (m.count, m.sum)
    return out


def _span_delta(after: dict, before: dict) -> dict:
    return {k: (n - before.get(k, (0, 0.0))[0], s - before.get(k, (0, 0.0))[1])
            for k, (n, s) in after.items()}


class _Skew:
    """The program's ``mesh.sweep`` skew spans since the last harvest (the
    ring is bounded: harvest at least every few thousand rounds)."""

    def __init__(self):
        self.last = -1
        self.seconds: list[float] = []

    def harvest(self, keep: bool) -> None:
        from mpi_blockchain_tpu_torch.meshprof.spans import spans_tail

        for rec in spans_tail(None):
            if rec["site"] == "mesh.sweep" and rec["round"] > self.last:
                self.last = rec["round"]
                if keep:
                    self.seconds.append(rec["t_exit"] - rec["t_enter"])


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_rank(driver, ctx: Ctx, on_setup=None) -> Rank:
    """A rank's part of a run: warm-up, window, traced sub-window. Every
    rank of a world runs it in step: each span's go-ahead is rank 0's."""
    driver.warmup()
    skew = _Skew()
    skew.harvest(False)
    before = span_totals()
    driver.agree(True)               # every rank is warm
    t_parent = driver.blocks[-1].t
    t0 = time.perf_counter()
    if on_setup is not None:
        on_setup(t0)
    blocks = []
    span = driver.span_blocks
    while driver.agree(time.perf_counter() - t0 < ctx.seconds):
        blocks += driver.mine(span)
        skew.harvest(True)
    window_s = time.perf_counter() - t0
    spans = _span_delta(span_totals(), before)
    trace, trace_blocks = None, []
    if ctx.trace:
        trace_blocks, trace = devtrace.capture(
            lambda: driver.mine(driver.trace_blocks), driver.device)
    return Rank(blocks=blocks, window_s=window_s, t_parent=t_parent,
                spans=spans, skew=skew.seconds, trace=trace,
                trace_blocks=trace_blocks,
                memory_peak=driver.memory_peak(), chain=driver.chain(),
                hashes=driver.block_hashes(),
                logged=[(b.height, b.nonce) for b in driver.blocks])


def make_driver(ctx: Ctx):
    module = spec.load_module(spec.driver_file(ctx.cell.traffic["driver"],
                                               ctx.cell.here))
    return module.make(ctx)


def power_limit() -> str | None:
    """``nvidia-smi``'s power limit of card 0, or None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def read_metrics(entries: list, run: Run) -> dict:
    out = {}
    for m in entries:
        path = spec.metric_file(m["name"], run.cell.here)
        value = spec.load_module(path).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", launch=None, cell: spec.Cell | None = None
        ) -> tuple[dict, int]:
    """One run of ``workload``; returns (the result line's object, exit
    code). ``device="cpu"`` runs the program's CPU path (tests)."""
    import torch

    c = cell if cell is not None else spec.cell(workload)
    ctx = Ctx(c, seed, seconds, trace, device, launch=launch)
    setup = {}
    driver = make_driver(ctx)
    error = None
    try:
        r = run_rank(driver, ctx,
                     on_setup=lambda t0: setup.update(age=process_age_s()))
        ranks = driver.finish(r)
    except Exception as e:        # the program failed inside the run
        import traceback
        traceback.print_exc()
        error = f"{type(e).__name__}: {e}"
        r, ranks = None, []
    finally:
        driver.close()
    if r is None:
        return {"correct": False, "attempted": 0, "failed": 1,
                "metrics": {}, "device": _device(torch, ctx, 0),
                "compared": {"run_error": {"value": error, "limit": None}}}, 1
    setup_s = setup["age"]
    del driver
    t_check = time.perf_counter()
    verdict = reference.check_chain(
        r.chain, prefix=ctx.prefix, bits=ctx.difficulty, seed=seed,
        block_hashes=r.hashes, logged=r.logged,
        others=[o.chain for o in ranks[1:]],
        scan_budget=1 << int(c.traffic["check_nonces_pow2"]),
        scan_blocks=int(c.traffic["check_blocks"]),
        device=_scan_device(torch, ctx))
    print(f"benchmark: window {r.window_s:.3f} s, {len(r.blocks)} blocks "
          f"({len(r.blocks) / r.window_s:.1f} blocks/s), chain height "
          f"{verdict.blocks}; reference: lowest-nonce scan of "
          f"{verdict.sampled_blocks} blocks ({verdict.sampled_nonces} "
          f"nonces) in {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    traces = [o.trace for o in ranks if o.trace is not None]
    run_ = Run(cell=c, setup_s=setup_s, window_s=r.window_s,
               blocks=r.blocks, t_parent=r.t_parent, spans=r.spans,
               skew=r.skew, trace=r.trace, trace_blocks=r.trace_blocks)
    metrics = read_metrics(c.per_layer if trace else c.end_to_end, run_)
    dev = _device(torch, ctx, max(o.memory_peak for o in ranks))
    if trace and traces:
        # The traced busy time and window, each the mean over the cards.
        dev["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        dev["window_s"] = sum(t.window_s for t in traces) / len(traces)
    result = {"correct": verdict.correct, "attempted": verdict.blocks,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if trace and r.trace is not None:
        result["breakdown"] = r.trace.breakdown()
    result["scanned"] = {"blocks": verdict.sampled_blocks,
                         "nonces": verdict.sampled_nonces}
    result["compared"] = verdict.compared()     # last in the line
    return result, 0


def _scan_device(torch, ctx: Ctx):
    return torch.device("cuda", 0) if ctx.device == "cuda" else "cpu"


def _device(torch, ctx: Ctx, peak: int) -> dict:
    if ctx.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": ctx.cell.chips, "memory_peak_bytes": peak,
            "power_limit": power_limit()}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m benchmark",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        c = spec.cell(args.workload)
    except spec.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < c.chips:
        print(f"benchmark: {args.workload} needs {c.chips} CUDA device(s); "
              f"{found} found", file=sys.stderr)
        return 2
    result, rc = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), cell=c)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return rc
