"""The sweep kernel's share of its roofline in the traced sub-window:
the nonces the sub-window's blocks need, times the fewest SM clocks a
nonce needs (``benchmark/replay.py``, frozen per difficulty class in
``sweep_roofline.json``), over the published peak's SM clocks in the
sweep kernel's device time (``sha256d_sweep_kernel`` by name in the
profiler's trace)."""
import json
import pathlib

from benchmark.replay import clocks_per_nonce, difficulty_class

DATA = json.loads(pathlib.Path(__file__).with_suffix(".json").read_text())


def read(run):
    if run.trace is None or not run.trace_blocks:
        return None
    seconds = run.trace.seconds("sha256d_sweep_kernel")
    work = DATA["work"][str(difficulty_class(
        run.cell.config["difficulty_bits"]))]
    clocks = clocks_per_nonce(work["alu_only"], work["adds"])
    if seconds <= 0 or clocks <= 0:
        return None
    peak = DATA["peak"]
    capacity = seconds * peak["sms"] * peak["sm_clock_mhz"] * 1e6
    return 100.0 * sum(b.needed for b in run.trace_blocks) * clocks \
        / capacity
