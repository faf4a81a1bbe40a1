"""Counts the device events ``torch.profiler`` drops at the edge of its
capture window on one NVIDIA GPU, with and without the port's pad.

    python -m mpi_blockchain_tpu_torch.tools.profile_window \\
        [--reps 300] [--hogs 14] [--kernels 16]

The profiler keeps a kernel only where its conversion of the card's clock
to the host's puts the kernel inside the window; on a loaded host that
conversion is off by milliseconds. Each rep takes two captures of
``--kernels`` small kernels on the card, launched at once after the
capture opens ("unpadded") and inside ``utils.profiling.padded_window``
("padded"), while ``--hogs`` processes spin on the host's cores (stopped
before the tool exits). For each capture it reads the Chrome trace: how
many launches have no kernel event, how long after the window opened the
first launch came, and the least gap between a launch and its kernel (a
negative gap is the conversion's error).

Prints a line for each capture that lost a kernel or saw a gap below
-100 us, and as the last line one JSON object with each variant's count
of captures that lost kernels, its gap quantiles, and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
VARIANTS = ("unpadded", "padded")


def trace_window(path: str) -> dict:
    """A Chrome trace's kernel launches (runtime calls), how many of them
    have no kernel event (``lost``), the first launch's distance from the
    window's opening (``first_launch_us``) and the least gap from a launch
    to its kernel (``min_gap_us``, None when no kernel was kept)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, kernels, opened = {}, {}, None
    for ev in events:
        cat, args = ev.get("cat"), ev.get("args", {})
        if cat == "cuda_runtime" and "Launch" in ev["name"] \
                and "correlation" in args:
            launches[args["correlation"]] = float(ev["ts"])
        elif cat == "kernel":
            kernels[args.get("correlation")] = float(ev["ts"])
        elif cat == "Trace" and opened is None:
            opened = float(ev["ts"])
    gaps = [kernels[c] - ts for c, ts in launches.items() if c in kernels]
    return {"launches": len(launches),
            "lost": sum(c not in kernels for c in launches),
            "first_launch_us": (min(launches.values()) - opened
                                if launches and opened is not None
                                else None),
            "min_gap_us": min(gaps) if gaps else None}


def capture(variant: str, kernels: int) -> dict:
    """One capture of ``kernels`` additions on the card, read back."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import padded_window

    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    window = (padded_window() if variant == "padded"
              else contextlib.nullcontext())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, window:
        for _ in range(kernels):
            x.add_(1)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_window(path)
    finally:
        os.unlink(path)


def quantiles(values: list[float]) -> dict:
    values = sorted(values)
    if not values:
        return {}
    return {q: values[min(len(values) - 1, int(f * len(values)))]
            for q, f in (("min", 0.0), ("p10", 0.1), ("median", 0.5))}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.tools.profile_window",
        description="device events the profiler drops at its window's "
                    "edge, with and without the port's pad, on a loaded "
                    "host")
    parser.add_argument("--reps", type=int, default=300)
    parser.add_argument("--hogs", type=int, default=14,
                        help="host processes spinning while it captures")
    parser.add_argument("--kernels", type=int, default=16)
    args = parser.parse_args(argv)
    import torch

    from ..utils.profiling import WINDOW_PAD_S

    if not torch.cuda.is_available():
        print("profile_window: the capture is of a CUDA device, and there "
              "is none here", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke

    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.hogs)]
    rows = []
    try:
        for rep in range(args.reps):
            for variant in VARIANTS:
                row = {"variant": variant, "rep": rep,
                       **capture(variant, args.kernels)}
                rows.append(row)
                if row["lost"] or (row["min_gap_us"] or 0) < -100:
                    print(json.dumps(row), flush=True)
    finally:
        for h in hogs:
            h.kill()
            h.wait()
    out = {}
    for variant in VARIANTS:
        mine = [r for r in rows if r["variant"] == variant]
        out[variant] = {
            "captures": len(mine),
            "captures_that_lost_kernels": sum(bool(r["lost"]) for r in mine),
            "kernels_lost": sum(r["lost"] for r in mine),
            "min_gap_us": quantiles([r["min_gap_us"] for r in mine
                                     if r["min_gap_us"] is not None]),
            "first_launch_us": quantiles([r["first_launch_us"] for r in mine
                                          if r["first_launch_us"]
                                          is not None])}
    print(json.dumps({"variants": out, "reps": args.reps,
                      "hogs": args.hogs, "kernels": args.kernels,
                      "pad_s": WINDOW_PAD_S, "torch": torch.__version__,
                      "card": chip_smoke.nvidia_smi("name,power.limit")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
