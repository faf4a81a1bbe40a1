"""Times a workload of two checkouts of the port in turns on one NVIDIA
GPU: what a change to the per-block path, or to the launch, costs.

    python -m mpi_blockchain_tpu_torch.tools.tree_turns PARENT_DIR CHANGE_DIR \\
        [--rounds 2] [--workload miner|sim|trace|overhead|step]

Each round runs the two trees in the order A, B, B, A (A the first tree),
each run in a process of its own started in that tree's directory, so
each imports its own package and builds its own kernel. A run builds, mines
a short d20/n10 chain to warm the card and the process, resets the
telemetry, then mines d24/n1000 at 2^24 behind ``ResilientBackend`` with
``chip_smoke.mine_timed`` (CUDA events around every sweep launch) and
prints its wall, sweeps, host time a block (wall minus sweeps, over the
blocks) and the spans a block (``chip_smoke.span_ms_per_block``).

``--workload sim`` times config 5 instead, ``sim --preset adversarial``
through the port's CLI (``chip_smoke.sim_run``: a launch a search), after
a warming run, then the same chain on the C++ sweep (``--backend cpu``),
which has no device and so shows the host's own pace in that turn; it
prints both walls and the host time a search (wall over searches).

``--workload trace`` mines the same d24/n1000 chain with the telemetry
on and the sweeps' events around the library's launch call, as phase 11 a
of ``chip_smoke.py`` does, and prints the pipeline's ``bubble_fraction``
beside 1 - the sweeps' event sum / wall (the figure phase 11 a holds it
to) and the span the pipeline's segments cover, without the phase's
checks, so that a run that would fail them is read and not lost.

``--workload overhead`` reads the trace-overhead audit instead
(``blocktrace.overhead.measure_trace_overhead`` on the card, its defaults:
three repetitions of a second of paired 2^24 sweep rounds, instrumented
against ``MPIBT_TELEMETRY_OFF``) and prints its ``overhead_pct``.

``--workload step`` times the fused miner's step kernel as phase 5 of
``chip_smoke.py`` does (``chip_smoke.phase_step``: 1000 launches back to
back in one call, then the measuring build's ``clock64`` stamps of each
launch's body, in SM clocks, which a lower SM clock does not change),
then mines d24/n1000 through ``FusedMiner`` at 100 blocks a call after a
warm-up, and prints the step's µs a launch, the body's median clocks and
the chain's wall.

Both trees must end at the same tip (the audit mines none). The last line is one JSON object with
every run, the medians per tree, and the card's name and power limit. The
environment passes through, so ``MPIBT_TELEMETRY_OFF=1`` in it times both
trees with their telemetry off.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

# Runs inside each tree: its own chip_smoke helpers and its own package.
_RUN = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.core.build import ensure_built
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_cuda

sha256_cuda.build()
ensure_built()
Miner(MinerConfig(difficulty_bits=20, n_blocks=10, batch_pow2=20,
                  backend="cuda", kernel="cuda", device="cuda"),
      pipeline=True).mine_chain()
telemetry.reset()
run = chip_smoke.mine_timed(Miner(MinerConfig(
    difficulty_bits=24, n_blocks=1000, batch_pow2=24, backend="cuda",
    kernel="cuda", device="cuda"), pipeline=True))
run["host_ms_per_block"] = chip_smoke.host_ms_per_block(run, 1000)
run["span_ms_per_block"] = chip_smoke.span_ms_per_block(1000)
print(json.dumps(run))
"""

_SIM = """
import json, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke
from mpi_blockchain_tpu_torch.core.build import ensure_built
from mpi_blockchain_tpu_torch.ops import sha256_cuda

sha256_cuda.build()
ensure_built()
with tempfile.TemporaryDirectory() as tmp:
    chip_smoke.sim_run(["--preset", "adversarial"], tmp, "warm")
    run = chip_smoke.sim_run(["--preset", "adversarial"], tmp, "preset")
    cpp = chip_smoke.sim_run(["--difficulty", "16", "--blocks", "20",
                              "--backend", "cpu"], tmp, "cpp")
searches = 2 * run["summary"]["steps"]
print(json.dumps({
    "wall_s": run["wall_s"], "launches": run["launches"],
    "host_ms_per_search": 1e3 * run["wall_s"] / searches,
    "dispatch_ms_per_search": 1e3 * run["dispatch_s"] / searches,
    "cpp_wall_s": cpp["wall_s"],
    "cpp_ms_per_search": 1e3 * cpp["wall_s"] / searches,
    "tip_hash": [(r["summary"]["tips"], r["dump_sha256"])
                 for r in (run, cpp)]}))
"""

_TRACE = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.core.build import ensure_built
from mpi_blockchain_tpu_torch.meshwatch.pipeline import (pipeline_report,
                                                         profiler,
                                                         reset_profiler)
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_cuda

sha256_cuda.build()
ensure_built()
Miner(MinerConfig(difficulty_bits=20, n_blocks=10, batch_pow2=20,
                  backend="cuda", kernel="cuda", device="cuda"),
      pipeline=True).mine_chain()
telemetry.reset()
reset_profiler()
run = chip_smoke.mine_timed(Miner(MinerConfig(
    difficulty_bits=24, n_blocks=1000, batch_pow2=24, backend="cuda",
    kernel="cuda", device="cuda"), pipeline=True), bracket="library",
    sample_clocks=False)
pipe = pipeline_report(profiler().records())
run["host_ms_per_block"] = chip_smoke.host_ms_per_block(run, 1000)
run["bubble_fraction"] = pipe["bubble_fraction"]
run["events_bubble"] = 1 - run["kernel_s"] / run["wall_s"]
run["pipeline_wall_s"] = pipe["ranks"]["0"]["wall_s"]
print(json.dumps(run))
"""

_OVERHEAD = """
import json, sys
sys.path.insert(0, ".")
from mpi_blockchain_tpu_torch.blocktrace.overhead import \\
    measure_trace_overhead
from mpi_blockchain_tpu_torch.ops import sha256_cuda

sha256_cuda.build()
run = measure_trace_overhead(device="cuda")
run["tip_hash"] = None
print(json.dumps(run))
"""

_STEP = """
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.core.build import ensure_built
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.ops import sha256_cuda

sha256_cuda.build()
ensure_built()
device = torch.device("cuda", 0)
clock_mhz = float(chip_smoke.nvidia_smi("clocks.max.sm", units=False))
step = chip_smoke.phase_step(np.random.default_rng(20261016), device,
                             clock_mhz)
fm = FusedMiner(MinerConfig(difficulty_bits=24, n_blocks=1000,
                            batch_pow2=24, backend="cuda", kernel="cuda",
                            device="cuda"), blocks_per_call=100)
fm.warmup()
t0 = time.perf_counter()
fm.mine_chain()
wall = time.perf_counter() - t0
print(json.dumps({
    "step_us": step["device_us"],
    "body_clocks": step["body_clocks"]["median"],
    "fused_wall_s": wall, "tip_hash": fm.node.tip_hash.hex()}))
"""

#: Per workload: the script run in each tree, the keys whose medians are
#: printed, and the line printed for each run.
WORKLOADS = {
    "miner": (_RUN, ("wall_s", "kernel_s", "host_ms_per_block"),
              lambda run: (
                  f"wall {run['wall_s']:.6f} s, sweeps "
                  f"{run['kernel_s']:.6f} s, host "
                  f"{run['host_ms_per_block']:.4f} ms a block, spans "
                  f"{ {k: round(v, 6) for k, v in run['span_ms_per_block'].items()} }")),
    "sim": (_SIM, ("wall_s", "host_ms_per_search", "cpp_wall_s"),
            lambda run: (
                f"wall {run['wall_s']:.6f} s, {run['launches']} launches, "
                f"host {run['host_ms_per_search']:.6f} ms a search "
                f"(dispatch {run['dispatch_ms_per_search']:.6f}); C++ "
                f"sweep wall {run['cpp_wall_s']:.6f} s")),
    "trace": (_TRACE, ("wall_s", "host_ms_per_block", "bubble_fraction",
                       "events_bubble"),
              lambda run: (
                  f"wall {run['wall_s']:.6f} s, sweeps "
                  f"{run['kernel_s']:.6f} s, host "
                  f"{run['host_ms_per_block']:.4f} ms a block, "
                  f"bubble_fraction {run['bubble_fraction']} against "
                  f"1 - sweeps / wall {run['events_bubble']:.4f}, "
                  f"segments span {run['pipeline_wall_s']:.6f} s")),
    "step": (_STEP, ("step_us", "body_clocks", "fused_wall_s"),
             lambda run: (
                 f"step {run['step_us']:.4f} us a launch, body "
                 f"{run['body_clocks']} SM clocks; fused d24/n1000 wall "
                 f"{run['fused_wall_s']:.6f} s")),
    "overhead": (_OVERHEAD, ("overhead_pct",),
                 lambda run: (
                     f"overhead {run['overhead_pct']}% (repetitions "
                     f"{run['all_overhead_pct']}), {run['pairs']} pairs")),
}


def run_tree(tree: pathlib.Path, script: str = _RUN) -> dict:
    """One timed run of ``script`` in ``tree``'s own process."""
    proc = subprocess.run([sys.executable, "-c", script], cwd=tree,
                          capture_output=True, text=True, check=True,
                          timeout=600)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.tools.tree_turns")
    parser.add_argument("trees", nargs=2, type=pathlib.Path,
                        help="two checkouts of the repo (A, then B)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--workload", choices=sorted(WORKLOADS),
                        default="miner")
    args = parser.parse_args(argv)
    script, keys, describe = WORKLOADS[args.workload]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    a, b = (t.resolve() for t in args.trees)
    runs: dict[str, list] = {str(a): [], str(b): []}
    for r in range(args.rounds):
        for tree in (a, b, b, a):
            run = run_tree(tree, script)
            runs[str(tree)].append(run)
            print(f"round {r} {tree.name}: {describe(run)}", flush=True)
    tips = {json.dumps(run["tip_hash"]) for rs in runs.values()
            for run in rs}
    if len(tips) != 1:
        print(f"tree_turns: FAIL: the runs end at {tips}", file=sys.stderr)
        return 1
    medians = {tree: {key: statistics.median(r[key] for r in rs)
                      for key in keys}
               for tree, rs in runs.items()}
    for tree, m in medians.items():
        print(f"median {pathlib.Path(tree).name}: {m}", flush=True)
    print(json.dumps({"card": card, "runs": runs, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
