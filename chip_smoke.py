#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from the sources in this checkout (the C++
chain core with g++, the CUDA kernels with nvcc, both started at once),
then:

1. holds the hand-written sweep kernel against its plain PyTorch version
   on the same card, bit for bit, at every difficulty class boundary, at
   the edges of the nonce space and at the edges of the kernel's slices
   (two winners in different slices, a count that is not a multiple of
   the slice, a winner in the first slice and one in the last, ragged
   slice ending at 2^32);
2. holds the CUDA backend against the CPU backend and the C++
   ``cpu_search`` on random headers, starts and ranges;
3. mines the chains the reference pinned in PERF_HISTORY.jsonl through the
   port's entry points (``mine`` d20/n10/b20 through the CLI, d16/n30, and
   the full-size d24/n1000 at batch 2^24 through the pipelined ``Miner``)
   and checks their tips, with the kernel's launches counted over the
   d24 run;
4. times the kernel at the main path's launch shape (one early-exit
   launch over the whole nonce space at dbits 24), beside a full sweep of
   exactly the nonces that launch needs, and at a full 2^24 sweep, against
   the plain version and the bound from the function's work (the compiled
   loop's ALU-only instructions and the source's adds), and counts the
   nonces the early exit hashes past the winner over OVERSHOOT_LAUNCHES
   launches against one slice per resident warp (the median must stay
   within it; the tail is printed); and, in the same turns as the 2^24
   sweep, the sweep that reads the extended midstate from the library's
   ``__constant__`` symbol, with the registers and blocks per SM of both;
5. drives the fused k-block miner (``mine --fused``): its step kernel
   against the plain step on the card, bit for bit, over seeded
   prev/data/height and the sentinel nonce and over the edge cases
   (``step_edge_cases``: prev words all-zero and all-ones, heights 0 and
   0xFFFFFFFF, bits 0, 24 and 64, nonces 0 and 0xFFFFFFFF); whole k-block
   calls (``mine_k``) at k 1, 2 and 6 and caps 2^12 and 2^32 against
   ``mine_k_plain``; the constant-ext sweep against the by-value sweep at
   the slice edges; the step kernel's time three ways (launches enqueued
   back to back in one call, the body's SM clocks from the measuring
   build's clock stamps, and a Python loop apart), with its compiled
   instructions and ptxas's registers, stack and spills; then the pinned
   d16/n30 (16 blocks a call) and d24/n1000 (100 a call) through
   ``FusedMiner``, their tips against the pins, with the sweep and step
   launches, the host waits per call and PyTorch's count of hidden syncs,
   the wall beside the pipelined ``Miner``'s of phase 3, and, in a second
   run with CUDA events around each sweep and after each step, the sweeps'
   share of the wall, the per-block device gaps within a call
   (``block_gaps``: median, 90th percentile, max), split into the step and
   the symbol copy, and the rest of the wall;
6. drives the resilience layer on the card: (a) the pipelined ``Miner`` at
   d24/n1000 behind ``ResilientBackend`` (its ``search_async`` launches at
   once and reads back when the driver consumes the sweep) and on the raw
   backend (a synchronous ``search_async``), in turns, with the wall, the
   sweeps' CUDA-event time, the kernel share and the host time per block
   of each; (b) a plan that
   kills every ``backend.cuda.dispatch`` (d8/n2/b11) steps down to ``cpu``
   with rc 0 and the ``--backend cpu`` oracle's tip; (c) a ``corrupt``
   winner at the first dispatch is retried once and the run stays on
   ``cuda:cuda`` with the pinned d20/n10 tip; (d) a ``mine`` subprocess with
   no ``nvcc`` exits 2 with a JSON error naming it, with no retry and no
   step-down in its metrics; (e) a d20 ``mine --checkpoint-every 1`` on the
   card is SIGKILLed, resumed to 10 blocks and verified, at the pinned tip.

Every ``mine`` of phases 3 and 6 goes through the wrapper; the smoke fails
on any retry or step-down that its plan did not cause.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line; with no CUDA device it fails at once. It takes about
three minutes on one NVIDIA H100, the builds included.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
import warnings

PINNED_TIPS = {   # PERF_HISTORY.jsonl, mined by the reference package
    (20, 10, 20):
        "000008584f3d49230531993ab565d6fd422b9199d8d3d0279a6b03e9c4b7f445",
    (16, 30, 20):
        "0000920e5985e6c7571d5094847875c2fa96ee43cff93294339fc12283597371",
    (24, 1000, 24):
        "000000cb3a6e7b2e520d7843bbea907d84a0ae2ecca7e882e689fad96d1cd3a5",
}
KERNEL_SOURCE = "mpi_blockchain_tpu_torch/ops/csrc/sha256d_sweep.cu"
REPLACES = "mpi_blockchain_tpu/ops/sha256_pallas.py:295"
# The fused miner's step kernel replaces the reference's jnp header build
# and winner digest (no Pallas kernel).
STEP_REPLACES = "mpi_blockchain_tpu/models/fused.py:89"
# Pinned chains mined by the fused miner, and the blocks of each call.
FUSED_RUNS = {(16, 30, 20): 16, (24, 1000, 24): 100}
STEP_CASES = 64
STEP_TIMED_LAUNCHES = 1000
M32 = 0xFFFFFFFF
# Edge cases of the step kernel (``step_edge_cases``) and the k-block calls
# held against the plain sequence.
STEP_EDGE_PREVS = (0, M32)          # every word of prev
STEP_EDGE_HEIGHTS = (0, M32)
STEP_EDGE_BITS = (0, 24, 64)
STEP_EDGE_NONCES = (0, M32)
STEP_CALL_KS = (1, 2, 6)
STEP_CALL_CAPS = (1 << 12, 1 << 32)
# The fused events run's per-block gap figures, in the step's kernel row.
GAP_KEYS = ("gap_ms", "gap_step_ms", "gap_copy_ms", "gaps_s", "rest_s")
NONCE_SPACE = 1 << 32
TIMED_NONCES = 1 << 24
TIMED_DBITS = 24
# Measuring launches at the main-path shape. The overshoot past the winner
# varies from launch to launch: warps of different blocks on one SM do not
# progress evenly (PERF.md), and a winner in a slow warp's slice is
# reported late.
OVERSHOOT_LAUNCHES = 101
# Phase 6 (a): the d24/n1000 Miner runs, in this order. The other forms of
# search_async are measured by ``tools/dispatch_variants.py``.
MINER_TURNS = ("wrapped", "raw", "raw", "wrapped")
REPO_ROOT = str(pathlib.Path(__file__).resolve().parent)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class ClockSampler:
    """Samples the SM clock (MHz) and power draw (W) with nvidia-smi on a
    thread while a run lasts."""

    def __init__(self, period_s: float = 0.25):
        self.samples: list[tuple[float, float]] = []
        self._period = period_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            line = nvidia_smi("clocks.sm,power.draw", units=False)
            self.samples.append(tuple(float(v) for v in line.split(",")))
            self._stop.wait(self._period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def summary(self) -> dict:
        clocks = sorted(c for c, _ in self.samples)
        power = [p for _, p in self.samples]
        if not clocks:
            return {}
        return {"samples": len(clocks), "sm_clock_mhz_min": clocks[0],
                "sm_clock_mhz_median": clocks[len(clocks) // 2],
                "sm_clock_mhz_max": clocks[-1],
                "power_w_max": max(power)}


def fault_plan(site: str, kind: str, call: int = 0, times: int = 1,
               seconds: float = 0.05) -> dict:
    """A fault plan of one fault, as ``mine --fault-plan`` reads it."""
    return {"version": 1, "faults": [{"site": site, "kind": kind,
                                      "call": call, "times": times,
                                      "seconds": seconds}]}


def without_nvcc(environ: dict, missing: str) -> dict:
    """``environ`` with ``CUDA_HOME`` at the directory ``missing`` (which
    does not exist) and every ``PATH`` entry that holds an ``nvcc`` taken
    out, so that ``sha256_cuda.find_nvcc`` finds none."""
    path = [p for p in environ.get("PATH", "").split(os.pathsep)
            if p and not (pathlib.Path(p) / "nvcc").exists()]
    return {**environ, "CUDA_HOME": missing, "CUDA_PATH": missing,
            "PATH": os.pathsep.join(path)}


def metric_total(prometheus: str, name: str) -> float:
    """The sum of every sample of metric ``name`` in Prometheus text."""
    total = 0.0
    for line in prometheus.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        key, _, value = line.rpartition(" ")
        if key.split("{")[0] == name:
            total += float(value)
    return total


def check_no_step_down(summary: dict, rung: str, what: str) -> None:
    """Fails unless a mine summary reports the rung ``rung`` and no
    step-down."""
    check(summary.get("rung") == rung and "degraded" not in summary,
          f"{what}: rung {summary.get('rung')}, degraded "
          f"{summary.get('degraded_to')}, not {rung} without a step-down")


def run_cli(argv: list[str]) -> tuple[int, dict]:
    """The port's CLI in this process: (rc, the last JSON line)."""
    from mpi_blockchain_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else {})


def random_header(rng) -> bytes:
    return rng.integers(0, 256, size=80, dtype="uint8").tobytes()


def find_header(rng, accept, tries: int = 4000) -> bytes:
    """The first seeded random header that ``accept`` takes."""
    for _ in range(tries):
        hdr = random_header(rng)
        if accept(hdr):
            return hdr
    raise SmokeFailure(f"no header in {tries} draws fits the case")


def slice_edge_cases(rng, g: int):
    """(header, dbits, base, count) cases at the edges of the kernel's
    slices of ``g`` nonces, each found by trying seeded headers against the
    C++ ``cpu_search``."""
    from mpi_blockchain_tpu_torch import core

    lg = g.bit_length() - 1             # dbits with about one winner per g
    base = int(rng.integers(0, 1 << 31))

    def search(hdr, d, start, count):
        return core.cpu_search(hdr, start, count, d)[0]

    def two_slices(hdr):                # the two lowest in other slices
        lo = search(hdr, lg + 2, base, 64 * g)
        if lo is None:
            return False
        hi = search(hdr, lg + 2, lo + 1, base + 64 * g - lo - 1)
        return hi is not None and (hi - base) // g != (lo - base) // g

    def first_slice(hdr):
        return search(hdr, lg + 1, base, g) is not None

    ragged = g // 2 + 3                 # the last slice's length
    top = NONCE_SPACE - 2 * g - ragged

    def last_slice(hdr):
        return search(hdr, lg, top, 2 * g) is None and \
            search(hdr, lg, NONCE_SPACE - ragged, ragged) is not None

    return [(find_header(rng, two_slices), lg + 2, base, 64 * g),
            (random_header(rng), 8, base, 100 * g + 13),
            (find_header(rng, first_slice), lg + 1, base, 64 * g),
            (find_header(rng, last_slice), lg, top, 2 * g + ragged)]


def phase_kernel_vs_plain(rng, device):
    """The kernel against the plain version on the card. Returns
    (mismatches, max_abs_err)."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda, sha256_torch
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    cases = [(d, 0, 1 << 20) for d in (0, 1, 8, 31, 32, 33, 63, 64)]
    cases += [(d, int(rng.integers(0, 1 << 31)), 1 << 18)
              for d in (1, 8, 16)]
    cases += [(8, 0xFFFFE000, 1 << 13),      # ends exactly at 2^32
              (0, 0xFFFFFFFF, 1),            # the last nonce is findable
              (TIMED_DBITS, 0, 1 << 24)]     # a full-size round
    cases = [(None, *case) for case in cases]
    # The slice cases draw from their own generator, so the draws of the
    # other phases (and phase 4's header) stay as they were.
    cases += slice_edge_cases(np.random.default_rng(20261017),
                              sha256_cuda.SLICE_NONCES)
    mismatches, max_err = 0, 0
    for hdr, d, base, count in cases:
        ext = extend_midstate(*core.header_midstate(
            random_header(rng) if hdr is None else hdr))
        ext_t = torch.as_tensor(ext.astype(np.int64), device=device)
        for early_exit in (False, True):
            k = sha256_cuda.sweep(ext, base, count, d, device=device,
                                  early_exit=early_exit)
            p = sha256_torch.sweep_core_ext(ext_t, base, count, d,
                                            early_exit=early_exit)
            if early_exit:
                same = k[1] == p[1] and (k[0] > 0) == (p[0] > 0)
                err = abs(k[1] - p[1])
            else:
                same = k == p
                err = max(abs(k[0] - p[0]), abs(k[1] - p[1]))
            max_err = max(max_err, err)
            if not same:
                mismatches += 1
                log(f"MISMATCH dbits={d} base={base:#x} count={count} "
                    f"early_exit={early_exit}: kernel {k} plain {p}")
    torch.cuda.synchronize()
    last = sha256_cuda.sweep(
        extend_midstate(*core.header_midstate(random_header(rng))),
        0xFFFFFFFF, 1, 0, device=device)
    check(last == (1, 0xFFFFFFFF),
          f"[0xFFFFFFFF, 2^32) at dbits 0 gave {last}, not (1, 0xFFFFFFFF)")
    log(f"phase 1 kernel vs plain: {2 * len(cases)} comparisons, "
        f"mismatches {mismatches}, max_abs_err {max_err}")
    check(mismatches == 0, f"{mismatches} kernel/plain mismatches")
    return mismatches, max_err


def phase_backend(rng, device):
    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
    from mpi_blockchain_tpu_torch.backend.cuda import CudaBackend

    cuda_be = CudaBackend(batch_pow2=20, kernel="cuda", device=device)
    cpu_be = CpuBackend()
    n = 0
    for i in range(24):
        hdr = random_header(rng)
        d = int(rng.integers(4, 17))
        if i % 4 == 0:
            start = 0xFFFFE000 + int(rng.integers(0, 1 << 12))
        else:
            start = int(rng.integers(0, 1 << 32))
        max_count = int(rng.integers(1, 1 << 20))
        a = cuda_be.search(hdr, d, start, max_count)
        b = cpu_be.search(hdr, d, start, max_count)
        oracle, _ = core.cpu_search(hdr, start, max_count, d)
        check((a.nonce, a.hash) == (b.nonce, b.hash) and a.nonce == oracle,
              f"backend mismatch at dbits={d} start={start:#x} "
              f"max_count={max_count}: cuda {a} cpu {b} oracle {oracle}")
        n += 1
    log(f"phase 2 backend: {n} searches, CudaBackend == CpuBackend == "
        f"cpu_search")


def mine_timed(miner) -> dict:
    """Mines ``miner``'s chain with CUDA events around every sweep launch
    and its CUDA backend's searches counted (each starts with the
    backend's ``launch``, whether ``search`` or the resilient wrapper
    calls it); returns wall, sweep time, launches, searches and the card's
    clocks during the run."""
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    backend = getattr(miner.backend, "active_backend", miner.backend)
    searches, events = 0, []
    start, launch = backend.launch, sha256_cuda.launch

    def counted_start(*args, **kwargs):
        nonlocal searches
        searches += 1
        return start(*args, **kwargs)

    def timed_launch(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        launch(*args, **kwargs)
        ev[1].record()
        events.append(ev)

    backend.launch = counted_start
    sha256_cuda.launch = timed_launch
    sha256_cuda.launches = 0
    try:
        torch.cuda.synchronize()
        with ClockSampler() as clocks:
            t0 = time.perf_counter()
            miner.mine_chain()
            wall = time.perf_counter() - t0
    finally:
        sha256_cuda.launch = launch
        del backend.launch
    launches = sha256_cuda.launches
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    return {"wall_s": wall, "kernel_s": kernel_s, "launches": launches,
            "searches": searches, "clocks": clocks.summary(),
            "tip_hash": miner.node.tip_hash.hex()}


def phase_tips(device):
    """Mines the pinned chains through the resilient backend; returns the
    d24/n1000 run's numbers."""
    from mpi_blockchain_tpu_torch import core, telemetry
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "d20.bin")
        telemetry.reset()
        sha256_cuda.launches = 0
        rc, summary = run_cli(["mine", "--difficulty", "20", "--blocks",
                               "10", "--batch-pow2", "20", "--out", out])
        launches = sha256_cuda.launches
        check(rc == 0, f"mine d20/n10/b20 exited {rc}: {summary}")
        node = core.Node(20)
        with open(out, "rb") as f:
            check(node.load(f.read()), "the d20 chain file does not verify")
    tip = node.tip_hash.hex()
    check(tip == PINNED_TIPS[(20, 10, 20)], f"d20/n10/b20 tip {tip}")
    check(launches == 10, f"d20/n10 made {launches} launches, not 10")
    check_no_step_down(summary, "cuda:cuda", "mine d20/n10")
    reg = telemetry.default_registry()
    check(reg.total("retries_total") == 0, "mine d20/n10 retried")
    log(f"phase 3 d20/n10/b20 via the CLI: tip {tip} matches, "
        f"{launches} launches, rung {summary['rung']}, no retry or "
        f"step-down")

    results = {}
    for (d, blocks, pow2), pinned in PINNED_TIPS.items():
        if d == 20:
            continue
        cfg = MinerConfig(difficulty_bits=d, n_blocks=blocks,
                          batch_pow2=pow2, backend="cuda", kernel="cuda",
                          device="cuda")
        telemetry.reset()
        miner = Miner(cfg, pipeline=True)
        run = mine_timed(miner)
        wall, kernel_s = run["wall_s"], run["kernel_s"]
        launches, searches = run["launches"], run["searches"]
        tip = miner.node.tip_hash.hex()
        check(tip == pinned, f"d{d}/n{blocks} tip {tip} != pinned {pinned}")
        check(launches > 0 and launches == searches,
              f"d{d}/n{blocks}: {launches} launches for {searches} "
              f"searches")
        check(miner.backend.rung == "cuda:cuda"
              and miner.backend.degradations == []
              and telemetry.default_registry().total("retries_total") == 0,
              f"d{d}/n{blocks}: rung {miner.backend.rung}, degradations "
              f"{miner.backend.degradations}")
        # Each block's window starts at nonce 0, so the kernel hashed at
        # least winner + 1 nonces for it.
        least_work = sum(r.nonce + 1 for r in miner.records)
        results[(d, blocks)] = {
            **run, "hashes_tried": miner.total_hashes(),
            "hashes_per_s": miner.total_hashes() / wall,
            "least_nonces": least_work}
        log(f"phase 3 d{d}/n{blocks}/b{pow2} via Miner (pipelined, "
            f"rung {miner.backend.rung}): tip {tip} matches; wall "
            f"{wall:.6f} s, "
            f"{miner.total_hashes() / wall:.6g} hashes/s (reference "
            f"accounting), {launches} launches for {searches} searches; "
            f"kernel {kernel_s:.6f} s ({kernel_s / wall:.4f} of wall), "
            f"least nonces hashed {least_work} "
            f"({least_work / kernel_s / 1e9:.4f} GH/s in the kernel); "
            f"card during the run {run['clocks']}")
    return results[(24, 1000)]


def time_in_turns(ext, configs: dict, reps: int, expect_min: int,
                  device) -> dict:
    """Median CUDA-event time (ms) of one launch at dbits TIMED_DBITS for
    each named config (``count``, optionally its own ``ext``, and the
    keyword arguments of ``sha256_cuda.launch``, from nonce 0), launched in
    turns: one of each per round, in reverse order every other round, so
    that all share the card's state. Each launch's buffer is reset first;
    each config's last result must have ``expect_min``."""
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    fresh = sha256_cuda.new_result(device)
    outs = {name: fresh.clone() for name in configs}
    events = {name: [] for name in configs}
    names = list(configs)
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            cfg = dict(configs[name])
            count = cfg.pop("count")
            launch_ext = cfg.pop("ext", ext)
            outs[name].copy_(fresh)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            sha256_cuda.launch(launch_ext, 0, count, TIMED_DBITS, outs[name],
                               **cfg)
            ev[1].record()
            events[name].append(ev)
    torch.cuda.synchronize()
    medians = {}
    for name in names:
        got = sha256_cuda.read_result(outs[name])[1]
        check(got == expect_min, f"timed launch {name} found {got:#x}, "
              f"not {expect_min:#x}")
        times = sorted(a.elapsed_time(b) for a, b in events[name])
        medians[name] = times[len(times) // 2]
    return medians


def full_sweep_min(winner: int) -> int:
    """The lowest qualifier a sweep of [0, TIMED_NONCES) finds."""
    return winner if winner < TIMED_NONCES else 0xFFFFFFFF


def phase_timing(rng, device):
    """The kernel at the main path's launch shape: one early-exit launch
    over the whole nonce space at dbits 24, for a header whose lowest
    winner W is known. Counts the nonces it hashes (measuring build, over
    OVERSHOOT_LAUNCHES launches) against the overshoot bound, times it in
    turns with a full sweep of
    exactly [0, W], times a full sweep of 2^24 nonces and the plain version
    on the early-exit input, and takes the bound from the function's work.
    Returns the numbers."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda, sha256_torch
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    # A header whose winner lies within a factor 2 of its mean 2^24, so
    # the plain version's run stays short.
    for _ in range(32):
        ext = extend_midstate(*core.header_midstate(random_header(rng)))
        found, winner = sha256_cuda.sweep(ext, 0, NONCE_SPACE, TIMED_DBITS,
                                          device=device, early_exit=True)
        if found and (1 << 23) <= winner < (1 << 25):
            break
    else:
        raise SmokeFailure("no header in 32 draws has a dbits-24 winner in "
                           "[2^23, 2^25)")
    need = winner + 1
    check(sha256_cuda.sweep(ext, 0, need, TIMED_DBITS, device=device)
          == (1, winner), f"{winner:#x} is not the lowest qualifying nonce")
    warps = sha256_cuda.resident_warps(TIMED_DBITS, device)
    g = sha256_cuda.SLICE_NONCES
    fresh = sha256_cuda.new_result(device)
    outs = [fresh.clone() for _ in range(OVERSHOOT_LAUNCHES)]
    hashed = torch.zeros(OVERSHOOT_LAUNCHES, dtype=torch.int64,
                         device=device)
    for i, out in enumerate(outs):
        sha256_cuda.launch(ext, 0, NONCE_SPACE, TIMED_DBITS, out,
                           early_exit=True, hashed=hashed[i:i + 1])
    check(all(sha256_cuda.read_result(out)[1] == winner for out in outs),
          "the measuring build found another winner")
    over = sorted(int(n) - need for n in hashed.tolist())
    median_over = over[len(over) // 2]
    n_hashed = need + median_over
    past_bound = sum(o > warps * g for o in over)

    with ClockSampler() as clocks:
        turns = time_in_turns(
            ext, {"main": {"count": NONCE_SPACE, "early_exit": True},
                  "exact": {"count": need}}, 30, winner, device)
        ext_device = torch.from_numpy(ext).to(device)
        fulls = time_in_turns(
            ext, {"full": {"count": TIMED_NONCES},
                  "full_ext_symbol": {"count": TIMED_NONCES,
                                      "ext": ext_device}},
            50, full_sweep_min(winner), device)
    full, full_symbol = fulls["full"], fulls["full_ext_symbol"]
    ms, exact_ms = turns["main"], turns["exact"]
    regs, per_sm = sha256_cuda.occupancy(TIMED_DBITS, device)
    regs_symbol, per_sm_symbol = sha256_cuda.occupancy(TIMED_DBITS, device,
                                                       ext_from_symbol=True)

    ext_t = torch.as_tensor(ext.astype(np.int64), device=device)
    sha256_torch.sweep_core_ext(ext_t, 0, 1 << 16, TIMED_DBITS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sha256_torch.sweep_core_ext(ext_t, 0, NONCE_SPACE, TIMED_DBITS,
                                        early_exit=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(plain[1] == winner, f"the plain version found {plain[1]:#x}")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    census = sha256_cuda.loop_census(sha256_cuda.disassemble(), TIMED_DBITS)
    adds = sha256_cuda.source_adds(TIMED_DBITS)
    alu_only = sha256_cuda.alu_only_count(census)
    per_nonce = sha256_cuda.bound_sm_clocks_per_nonce(census, adds)
    by_census = sha256_cuda.sm_clocks_per_nonce(census)
    alu, fma, total = sha256_cuda.pipe_counts(census)

    def clocks_ms(nonces: int, clocks_per_nonce: float) -> float:
        return nonces * clocks_per_nonce / (sms * clock_mhz * 1e6) * 1e3

    bound, bound_full = clocks_ms(need, per_nonce), \
        clocks_ms(TIMED_NONCES, per_nonce)
    resident = sha256_cuda.resident_blocks(TIMED_DBITS, device)
    log(f"phase 4 loop of the dbits-{TIMED_DBITS} kernel: {total} "
        f"instructions, {alu} on the ALU pipe ({alu_only} of them ALU-only), "
        f"{fma} on the FMA pipe; by opcode {census}; the source's adds "
        f"{adds} a nonce; bound {per_nonce:.4f} SM clocks a nonce (census "
        f"of this build: {by_census:.4f}); persistent grid {resident} "
        f"blocks, {warps} warps, on {sms} SMs")
    log(f"phase 4 main-path launch (early exit over [0, 2^32), dbits "
        f"{TIMED_DBITS}, winner {winner}, slices of {g} nonces): kernel "
        f"{ms:.4f} ms, bound {bound:.4f} ms for the {need} nonces it needs, "
        f"hashed {n_hashed} nonces in the median of {len(over)} measuring "
        f"launches ({n_hashed / need:.4f} of the need): overshoot "
        f"{median_over} against the bound {warps} warps x {g} = "
        f"{warps * g} (over the launches: min {over[0]}, 90th percentile "
        f"{over[len(over) * 9 // 10]}, max {over[-1]}; {past_bound} past "
        f"the bound); a full sweep of exactly those {need} nonces takes "
        f"{exact_ms:.4f} ms in the same turns ({ms / exact_ms:.4f} of it); "
        f"plain version {plain_ms:.1f} ms")
    log(f"phase 4 full sweep of {TIMED_NONCES} nonces: kernel {full:.4f} ms "
        f"({TIMED_NONCES / full / 1e6:.4f} GH/s), bound {bound_full:.4f} ms "
        f"({bound_full / full:.4f} of the kernel's time; census figure "
        f"{clocks_ms(TIMED_NONCES, by_census):.4f} ms) at {clock_mhz:.0f} "
        f"MHz; card during the timed launches {clocks.summary()}")
    log(f"phase 4 the same sweep with ext from the __constant__ symbol, in "
        f"the same turns: {full_symbol:.4f} ms ({full_symbol / full:.4f} of "
        f"the by-value build's); registers {regs} by value, {regs_symbol} "
        f"from the symbol; blocks per SM {per_sm} and {per_sm_symbol}")
    check(median_over <= warps * g,
          f"the early exit hashed a median {median_over} nonces past the "
          f"need, more than one slice per resident warp ({warps * g})")
    check(ms <= 1.15 * exact_ms,
          f"the main-path launch took {ms:.4f} ms, more than 1.15 times the "
          f"exact sweep of [0, W] ({exact_ms:.4f} ms)")
    check(full >= bound_full,
          f"the 2^24 sweep took {full:.4f} ms, under its bound "
          f"{bound_full:.4f} ms: the bound is not a floor")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "winner": winner, "nonces_needed": need,
            "nonces_hashed": n_hashed, "exact_sweep_ms": exact_ms,
            "ms_per_2^24": full, "bound_ms_per_2^24": bound_full,
            "ms_per_2^24_ext_symbol": full_symbol,
            "ext_symbol_over_by_value_2^24": full_symbol / full,
            "registers": regs, "registers_ext_symbol": regs_symbol,
            "blocks_per_sm": per_sm, "blocks_per_sm_ext_symbol": per_sm_symbol,
            "share_of_bound_2^24": bound_full / full,
            "sm_clocks_per_nonce": per_nonce,
            "source_adds_per_nonce": adds, "loop_alu_only_ops": alu_only,
            "census_sm_clocks_per_nonce": by_census,
            "census_bound_ms_per_2^24": clocks_ms(TIMED_NONCES, by_census),
            "loop_alu_ops": alu, "loop_fma_ops": fma,
            "loop_instructions": total, "slice_nonces": g,
            "resident_warps": warps, "overshoot_bound": warps * g,
            "overshoot": median_over, "overshoot_max": over[-1],
            "overshoot_launches": len(over),
            "overshoot_past_bound": past_bound, "resident_blocks": resident,
            "sms": sms, "sm_clock_mhz": clock_mhz}


def step_edge_cases(rng) -> list[tuple]:
    """(prev, data, heights, nonces, bits) groups of step cases at the
    edges of its inputs, one group per difficulty in STEP_EDGE_BITS: every
    prev word all-zero or all-ones, height 0 or 0xFFFFFFFF (whose next
    block's height wraps to 0), and nonce 0 or 0xFFFFFFFF in both of a
    case's finalizing steps; the data words are seeded."""
    import numpy as np

    rows = [(pv, h, nz) for pv in STEP_EDGE_PREVS for h in STEP_EDGE_HEIGHTS
            for nz in STEP_EDGE_NONCES]
    prev = np.array([[pv] * 8 for pv, _, _ in rows], dtype=np.uint32)
    heights = np.array([h for _, h, _ in rows], dtype=np.int64)
    nonces = np.array([[nz, M32 - nz] for _, _, nz in rows], dtype=np.uint32)
    return [(prev, rng.integers(0, 1 << 32, (len(rows), 2, 8),
                                dtype=np.uint32), heights, nonces, bits)
            for bits in STEP_EDGE_BITS]


def step_vs_plain(prev, data, heights, nonces, bits: int, device
                  ) -> tuple[int, int]:
    """The step kernel against the plain step on the card, bit for bit,
    over n cases (numpy: prev (n, 8), data (n, 2, 8), heights (n,), nonces
    (n, 2)) at ``bits``: each builds a block, finalizes it with its first
    nonce and builds the next at height + 1, then finalizes that into the
    tip with its second nonce; the plain version computes all cases at
    once. Returns (cases that differ, max_abs_err)."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_block
    from mpi_blockchain_tpu_torch.ops.sha256_block import (
        block_template, winner_digest)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n = len(prev)
    prev_t, data_t = card(prev), card(data)
    built, both = [], []
    nonce_out = torch.zeros((n, 2), dtype=torch.uint32, device=device)
    tips = torch.zeros((n, 8), dtype=torch.uint32, device=device)
    for i in range(n):
        h = int(heights[i])
        scratch = sha256_block.new_scratch(device)
        sha256_block.step(scratch, prev=prev_t[i], data=data_t[i, 0],
                          height=h, difficulty_bits=bits)
        built.append(scratch.clone())
        scratch.view(torch.uint32)[1] = int(nonces[i, 0])
        sha256_block.step(scratch, data=data_t[i, 1], height=h + 1,
                          difficulty_bits=bits, nonce_out=nonce_out[i, :1])
        both.append(scratch.clone())
        scratch.view(torch.uint32)[1] = int(nonces[i, 1])
        sha256_block.step(scratch, nonce_out=nonce_out[i, 1:],
                          tip_out=tips[i])
    torch.cuda.synchronize()

    h_t = torch.from_numpy(heights.astype(np.int64)).to(device)
    n_t = sha256_block.to_words(card(nonces))
    reset = torch.tensor([0, M32, 0, 0], dtype=torch.int64,
                         device=device).expand(n, 4)
    ms, tail, ext = block_template(prev_t, data_t[:, 0], h_t, bits)
    want_built = torch.cat([reset, ext, ms, tail], dim=1)
    digest = winner_digest(ms, tail, n_t[:, 0])
    ms2, tail2, ext2 = block_template(digest, data_t[:, 1], h_t + 1, bits)
    want_both = torch.cat([reset, ext2, ms2, tail2], dim=1)
    want_tip = winner_digest(ms2, tail2, n_t[:, 1])
    got = [sha256_block.to_words(t) for t in (torch.stack(built),
                                               torch.stack(both), nonce_out,
                                               tips)]
    want = [want_built, want_both, n_t, want_tip]
    diff = torch.cat([(g - w).abs() for g, w in zip(got, want)], dim=1)
    return int((diff.amax(dim=1) > 0).sum()), int(diff.max())


def k_block_calls_vs_plain(rng, device) -> int:
    """Whole k-block calls (``mine_k``) against ``mine_k_plain`` on the
    CPU at each k in STEP_CALL_KS and cap in STEP_CALL_CAPS (dbits 12: the
    smaller cap leaves some blocks without a winner, the sentinel carried
    on): nonces and tip. Returns the calls that differ."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_block

    bad = 0
    for k in STEP_CALL_KS:
        prev = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
        data = rng.integers(0, 1 << 32, (k, 8), dtype=np.uint32)
        for cap in STEP_CALL_CAPS:
            got = sha256_block.mine_k(torch.from_numpy(prev).to(device),
                                      torch.from_numpy(data).to(device),
                                      41, 12, cap)
            want = sha256_block.mine_k_plain(torch.from_numpy(prev),
                                             torch.from_numpy(data), 41, 12,
                                             cap)
            if [t.cpu().tolist() for t in got] != [t.tolist() for t in want]:
                bad += 1
                log(f"MISMATCH k-block call k={k} cap={cap:#x}: kernel "
                    f"{[t.cpu().tolist() for t in got]} plain "
                    f"{[t.tolist() for t in want]}")
    return bad


def phase_step(rng, device, clock_mhz: float):
    """The fused step kernel on the card: against the plain step, bit for
    bit, over STEP_CASES seeded cases (sentinel nonce among them) and the
    edge cases (``step_edge_cases``); whole k-block calls against the plain
    sequence; then its time three ways, each over STEP_TIMED_LAUNCHES
    finalize-and-build steps: launched from a Python loop (what the host
    pays), enqueued back to back in one call into the library (the device
    time of a launch), and the body's SM clocks from the measuring build's
    clock stamps; its compiled size and ptxas's registers, stack and
    spills. Returns the numbers."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    n, d = STEP_CASES, TIMED_DBITS
    prev = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
    data = rng.integers(0, 1 << 32, (n, 2, 8), dtype=np.uint32)
    heights = rng.integers(0, 1 << 32, n)
    nonces = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
    nonces[0, 0] = nonces[1, 1] = M32
    mismatches, max_err = step_vs_plain(prev, data, heights, nonces, d,
                                        device)
    log(f"phase 5 step kernel vs plain: {n} cases x 3 steps (build, "
        f"finalize and build, finalize into the tip; sentinel nonce in 2), "
        f"mismatches {mismatches}, max_abs_err {max_err}")
    edge_rng = np.random.default_rng(20261019)
    edge_cases, edge_mismatches = 0, 0
    for case in step_edge_cases(edge_rng):
        bad, err = step_vs_plain(*case, device)
        edge_cases += len(case[0])
        edge_mismatches += bad
        max_err = max(max_err, err)
    log(f"phase 5 step kernel vs plain at the edges (prev words "
        f"{STEP_EDGE_PREVS}, heights {STEP_EDGE_HEIGHTS}, bits "
        f"{STEP_EDGE_BITS}, nonces {STEP_EDGE_NONCES}): {edge_cases} cases "
        f"x 3 steps, mismatches {edge_mismatches}")
    call_mismatches = k_block_calls_vs_plain(edge_rng, device)
    log(f"phase 5 k-block calls vs mine_k_plain (k {STEP_CALL_KS}, caps "
        f"{[hex(c) for c in STEP_CALL_CAPS]}): mismatches {call_mismatches}")
    check(mismatches + edge_mismatches + call_mismatches == 0,
          f"step kernel/plain mismatches: {mismatches} seeded, "
          f"{edge_mismatches} at the edges, {call_mismatches} k-block calls")

    prev_t = torch.from_numpy(prev).to(device)
    data_t = torch.from_numpy(data).to(device)
    scratch = sha256_block.new_scratch(device)
    sha256_block.step(scratch, prev=prev_t[0], data=data_t[0, 0],
                      height=int(heights[0]), difficulty_bits=d)
    slot = torch.zeros(1, dtype=torch.uint32, device=device)
    step_args = dict(data=data_t[0, 1], height=1, difficulty_bits=d,
                     nonce_out=slot)
    launches = STEP_TIMED_LAUNCHES

    def timed(enqueue) -> float:
        """CUDA-event ms of what ``enqueue`` puts on the stream."""
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
        enqueue()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1])

    def python_loop():
        for _ in range(launches):
            sha256_block.step(scratch, **step_args)

    sha256_block.step_repeat(100, scratch, **step_args)      # warm-up
    python_us = timed(python_loop) / launches * 1e3
    device_us = timed(lambda: sha256_block.step_repeat(
        launches, scratch, **step_args)) / launches * 1e3
    stamps = torch.zeros(2 * launches, dtype=torch.int64, device=device)
    sha256_block.step_repeat(launches, scratch, stamps=stamps, **step_args)
    clocks = (stamps[1::2] - stamps[::2]).tolist()
    body = spread(clocks)
    body_us = body["median"] / clock_mhz
    plain = []
    for _ in range(5):
        t0 = time.perf_counter()
        sha256_block.step_plain(scratch, **step_args)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    plain_ms = sorted(plain)[len(plain) // 2]
    ops = sha256_block.STEP_DEPENDENT_OPS
    bound_ops = ops / (clock_mhz * 1e6) * 1e3
    # Bytes: the data words, the previous midstate, template and result
    # read; the nonce and the new scratch written.
    step_bytes = 4 * (8 + 24 + 4 + 1 + sha256_block.SCRATCH_WORDS)
    bound_bytes = step_bytes / 3.35e12 * 1e3
    bound = max(bound_ops, bound_bytes)
    # One thread issues at most one instruction a clock: the compiled
    # step's length is a floor of the design (not of the function).
    census = sha256_cuda.function_census(sha256_cuda.disassemble(),
                                         sha256_cuda.STEP_KERNEL_SYMBOL)
    instructions = sum(census.values())
    resources = sha256_cuda.ptxas_report(sha256_cuda.build_report(),
                                         sha256_cuda.STEP_KERNEL_SYMBOL)
    log(f"phase 5 step kernel (finalize and build, {launches} launches): "
        f"{device_us:.4f} us a launch on the card, enqueued back to back in "
        f"one call; {python_us:.4f} us a launch from a Python loop; body "
        f"{body['median']} SM clocks median ({body_us:.4f} us at "
        f"{clock_mhz:.0f} MHz; 90th percentile {body['p90']}, max "
        f"{body['max']}, first launch {clocks[0]}); bound "
        f"{bound * 1e3:.4f} us ({ops} dependent operations at one clock "
        f"each; {step_bytes} bytes take {bound_bytes * 1e6:.4f} ns); "
        f"the compiled kernel has {instructions} instructions "
        f"({instructions / clock_mhz:.4f} us at one a clock), by opcode "
        f"{census}; ptxas {resources}; plain step on the card "
        f"{plain_ms:.3f} ms")
    return {"mismatches": mismatches, "edge_cases": edge_cases,
            "edge_mismatches": edge_mismatches,
            "k_block_call_mismatches": call_mismatches,
            "max_abs_err": max_err, "ms": device_us / 1e3,
            "device_us": device_us, "python_loop_us": python_us,
            "body_us": body_us, "body_clocks": body, "plain_ms": plain_ms,
            "bound_ms": bound, "dependent_ops": ops, "bytes": step_bytes,
            "instructions": instructions, **resources}


def phase_ext_symbol(device):
    """The sweep reading ext from the __constant__ symbol against the
    by-value sweep, full and early-exit, at the slice edges. Returns the
    mismatches."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    fresh = sha256_cuda.new_result(device)
    cases = slice_edge_cases(np.random.default_rng(20261017),
                             sha256_cuda.SLICE_NONCES)
    mismatches = 0
    for hdr, d, base, count in cases:
        ext = extend_midstate(*core.header_midstate(hdr))
        for early_exit in (False, True):
            got = []
            for e in (ext, torch.from_numpy(ext).to(device)):
                out = fresh.clone()
                sha256_cuda.launch(e, base, count, d, out,
                                   early_exit=early_exit)
                got.append(sha256_cuda.read_result(out))
            if got[0] != got[1]:
                mismatches += 1
                log(f"MISMATCH ext symbol dbits={d} base={base:#x} "
                    f"count={count} early_exit={early_exit}: {got}")
    log(f"phase 5 constant-ext sweep vs by-value sweep at the slice "
        f"edges: {2 * len(cases)} comparisons, mismatches {mismatches}")
    check(mismatches == 0, f"{mismatches} constant-ext/by-value mismatches")
    return mismatches


def spread(values) -> dict:
    """Median, 90th percentile and max of ``values`` (and their number)."""
    v = sorted(values)
    if not v:
        return {"n": 0, "median": None, "p90": None, "max": None}
    return {"n": len(v), "median": v[len(v) // 2],
            "p90": v[len(v) * 9 // 10], "max": v[-1]}


def block_gaps(calls) -> dict[str, list[float]]:
    """Per-block device gaps of a fused run from its CUDA-event times (ms
    on one clock), given per k-block call as ``{"sweeps": [(before,
    after)] * k, "steps": [after] * (k + 1)}``; step j runs before sweep j
    and step k finalizes the call. Block j's gap ("gap") runs from the end
    of sweep j to the start of sweep j + 1 of the same call; the step
    between them takes its first part ("step"), the symbol copy the rest
    ("copy"; the sweep's own launch lies inside its events). Nothing
    across two calls counts: the host and the calls' first and last steps
    lie there."""
    out = {"gap": [], "step": [], "copy": []}
    for call in calls:
        sweeps, steps = call["sweeps"], call.get("steps")
        for j in range(len(sweeps) - 1):
            end, start = sweeps[j][1], sweeps[j + 1][0]
            out["gap"].append(start - end)
            if steps is not None:
                out["step"].append(steps[j + 1] - end)
                out["copy"].append(start - steps[j + 1])
    return out


def count_syncs(caught) -> int:
    """Warnings of PyTorch's sync debug mode ("called a synchronizing CUDA
    operation") among ``caught``; its first switch to "warn" also warns
    that the mode is a prototype, which does not count."""
    return sum("synchronizing" in str(w.message) for w in caught)


def sync_detector_works(device) -> bool:
    """Whether sync debug mode flags a known synchronizing call here."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.ones(1, device=device).item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return count_syncs(caught) > 0


def phase_fused(device, miner_chain: dict) -> dict:
    """Mines the FUSED_RUNS pins through FusedMiner: an untimed run (tip,
    launches, host waits, hidden syncs flagged by PyTorch, wall) and an
    events run, whose sweeps are bracketed by CUDA events and whose steps
    are followed by one (kernel share; the per-block device gaps and their
    split, ``block_gaps``; the rest of the wall, host head and tail).
    Returns the numbers by (dbits, blocks)."""
    import torch

    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.fused import FusedMiner
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    check(sync_detector_works(device),
          "sync debug mode did not flag .item() on the card")
    results = {}
    for (d, blocks, pow2), k in FUSED_RUNS.items():
        cfg = MinerConfig(difficulty_bits=d, n_blocks=blocks,
                          batch_pow2=pow2, backend="cuda", kernel="cuda",
                          device="cuda")
        pinned = PINNED_TIPS[(d, blocks, pow2)]
        calls = -(-blocks // k)
        row = {}
        for timed in (False, True):
            fm = FusedMiner(cfg, blocks_per_call=k)
            fm.warmup()
            call_events = []
            mine_k = sha256_block.mine_k

            def timed_mine_k(prev, data, *args, **kwargs):
                n = data.shape[0]
                evs = [torch.cuda.Event(enable_timing=True)
                       for _ in range(3 * n + 1)]
                for ev in evs:      # creates each event before the call
                    ev.record()
                call_events.append(evs)
                return mine_k(prev, data, *args, sweep_events=evs[:2 * n],
                              step_events=evs[2 * n:], **kwargs)

            torch.cuda.synchronize()
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
            if timed:
                sha256_block.mine_k = timed_mine_k
            sha256_cuda.launches = sha256_block.step_launches = 0
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        t0 = time.perf_counter()
                        fm.mine_chain()
                        wall = time.perf_counter() - t0
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
            finally:
                sha256_block.mine_k = mine_k
            sweeps, steps = sha256_cuda.launches, sha256_block.step_launches
            torch.cuda.synchronize()
            syncs = count_syncs(caught)
            tip = fm.node.tip_hash.hex()
            check(tip == pinned, f"fused d{d}/n{blocks} tip {tip} != "
                  f"pinned {pinned}")
            check(sweeps == blocks and steps == blocks + calls,
                  f"fused d{d}/n{blocks}: {sweeps} sweeps and {steps} "
                  f"steps, not {blocks} and {blocks + calls}")
            check(fm.host_waits == calls, f"fused d{d}/n{blocks}: "
                  f"{fm.host_waits} host waits for {calls} calls")
            check(syncs == 0, f"fused d{d}/n{blocks}: PyTorch flagged "
                  f"{syncs} synchronizing operations")
            check(fm.recovery is None or fm.recovery.degradations == [],
                  f"fused d{d}/n{blocks}: the recovery search stepped down")
            if timed:
                times = [[origin.elapsed_time(ev) for ev in evs]
                         for evs in call_events]
                split = block_gaps(
                    [{"sweeps": list(zip(t[:2 * (len(t) // 3):2],
                                         t[1:2 * (len(t) // 3):2])),
                      "steps": t[2 * (len(t) // 3):]} for t in times])
                kernel_s = sum(t[2 * j + 1] - t[2 * j] for t in times
                               for j in range(len(t) // 3)) / 1e3
                gaps_s = sum(split["gap"]) / 1e3
                row.update(timed_wall_s=wall, kernel_s=kernel_s,
                           kernel_share=kernel_s / wall,
                           gap_ms=spread(split["gap"]),
                           gap_step_ms=spread(split["step"]),
                           gap_copy_ms=spread(split["copy"]),
                           gaps_s=gaps_s,
                           rest_s=wall - kernel_s - gaps_s)
            else:
                row.update(wall_s=wall, sweeps=sweeps, steps=steps,
                           host_waits=fm.host_waits, calls=calls,
                           hidden_syncs=syncs)
        results[(d, blocks)] = row
        beside = ""
        if (d, blocks) == (24, 1000):
            beside = (f" (pipelined Miner, phase 3: "
                      f"{miner_chain['wall_s']:.6f} s, kernel share "
                      f"{miner_chain['kernel_s'] / miner_chain['wall_s']:.4f})")
        log(f"phase 5 fused d{d}/n{blocks}/b{pow2} at {k} blocks a call: tip "
            f"{tip} matches; wall {row['wall_s']:.6f} s{beside}; "
            f"{row['sweeps']} sweeps, {row['steps']} steps, "
            f"{row['host_waits']} host waits for {calls} calls, "
            f"{row['hidden_syncs']} hidden syncs; events run: wall "
            f"{row['timed_wall_s']:.6f} s, sweeps {row['kernel_s']:.6f} s "
            f"({row['kernel_share']:.4f} of wall), gaps between sweeps in a "
            f"call {row['gaps_s']:.6f} s, rest (host head and tail, calls' "
            f"first and last steps) {row['rest_s']:.6f} s; per-block gap "
            f"(ms) {row['gap_ms']}, of it the step {row['gap_step_ms']} and "
            f"the symbol copy {row['gap_copy_ms']}")
    return results


def phase_resilience(device) -> dict:
    """Phase 6: the resilience layer on the card, (a) to (e) as the module
    docstring says. Returns the numbers."""
    import statistics

    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.backend import backend_from_config
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.resilience.__main__ import (
        smoke_degradation, smoke_kill_resume)

    out: dict = {}
    # (a) wrapped (launch at once, read back when consumed) and raw (the
    # synchronous search_async), in turns.
    cfg = MinerConfig(difficulty_bits=24, n_blocks=1000, batch_pow2=24,
                      backend="cuda", kernel="cuda", device="cuda")
    pinned = PINNED_TIPS[(24, 1000, 24)]
    runs: dict[str, list] = {turn: [] for turn in MINER_TURNS}
    for turn in MINER_TURNS:
        telemetry.reset()
        backend = backend_from_config(cfg, resilient=(turn != "raw"))
        run = mine_timed(Miner(cfg, backend=backend, pipeline=True))
        runs[turn].append(run)
        check(run["launches"] == run["searches"] == 1000,
              f"6a {turn}: {run['launches']} launches, {run['searches']} "
              f"searches")
        if turn != "raw":
            check(backend.rung == "cuda:cuda" and backend.degradations == []
                  and telemetry.default_registry().total("retries_total")
                  == 0, f"6a wrapped: rung {backend.rung}, degradations "
                  f"{backend.degradations}")
    for turn, rs in runs.items():
        for r in rs:
            check(r["tip_hash"] == pinned, f"6a {turn}: tip {r['tip_hash']}")
        wall = statistics.median(r["wall_s"] for r in rs)
        kernel = statistics.median(r["kernel_s"] for r in rs)
        out[f"miner_d24_n1000_{turn}"] = {
            "wall_s": [r["wall_s"] for r in rs],
            "kernel_s": [r["kernel_s"] for r in rs],
            "kernel_share": [r["kernel_s"] / r["wall_s"] for r in rs],
            "host_ms_per_block": [host_ms_per_block(r, 1000) for r in rs],
            "clocks": [r["clocks"] for r in rs]}
        log(f"phase 6a d24/n1000 pipelined Miner, {turn}: walls "
            f"{[round(r['wall_s'], 6) for r in rs]} s (median {wall:.6f}), "
            f"sweeps {[round(r['kernel_s'], 6) for r in rs]} s, kernel "
            f"share {[round(r['kernel_s'] / r['wall_s'], 4) for r in rs]}, "
            f"host time a block "
            f"{[round(host_ms_per_block(r, 1000), 4) for r in rs]} ms "
            f"(median wall minus median sweeps: "
            f"{(wall - kernel) / 1000 * 1e3:.4f} ms)")

    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        # (b) every CUDA dispatch killed: cuda:cuda -> cuda:torch -> cpu.
        telemetry.reset()
        got = smoke_degradation(tmp, device=device.type)
        steps = telemetry.default_registry().total(
            "backend_degradations_total")
        check(steps == 2, f"6b: {steps} step-downs, not 2")
        out["step_down"] = {"rung": got["degraded"]["rung"],
                            "step_downs": steps,
                            "tip_hash": got["degraded"]["tip_hash"]}
        log(f"phase 6b dead CUDA dispatch (d8/n2/b11): rc 0, {steps} "
            f"step-downs to {got['degraded']['degraded_to']}, tip "
            f"{got['degraded']['tip_hash']} == the --backend cpu oracle's")

        # (c) a corrupt winner at the first dispatch: one retry, same rung.
        plan = tmp / "corrupt.json"
        plan.write_text(json.dumps(fault_plan("backend.cuda.dispatch",
                                              "corrupt")))
        telemetry.reset()
        rc, summary = run_cli(["mine", "--difficulty", "20", "--blocks",
                               "10", "--batch-pow2", "20", "--fault-plan",
                               str(plan)])
        reg = telemetry.default_registry()
        retries, corrupt = reg.total("retries_total"), \
            reg.total("corrupt_results_total")
        check(rc == 0 and summary.get("tip_hash") == PINNED_TIPS[
            (20, 10, 20)], f"6c: rc {rc}, summary {summary}")
        check_no_step_down(summary, "cuda:cuda", "6c")
        check(retries == 1 and corrupt == 1,
              f"6c: {retries} retries, {corrupt} corrupt results, not 1")
        out["corrupt_retried"] = {"retries": retries, "rung":
                                  summary["rung"]}
        log(f"phase 6c corrupt winner at call 0 (d20/n10): {corrupt} caught "
            f"by re-validation, {retries} retry, rung {summary['rung']}, "
            f"tip {summary['tip_hash']} matches the pin")

        # (d) no nvcc: the top rung's kernel cannot build.
        metrics = tmp / "no_nvcc.prom"
        env = without_nvcc(dict(os.environ), str(tmp / "no_cuda_home"))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p)
        proc = subprocess.run(
            [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
             "--difficulty", "8", "--blocks", "1", "--metrics-dump",
             str(metrics)], capture_output=True, text=True, env=env,
            cwd=str(tmp), timeout=300)
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        err = json.loads(lines[-1]) if lines else {}
        text = metrics.read_text() if metrics.exists() else ""
        retries = metric_total(text, "retries_total")
        steps = metric_total(text, "backend_degradations_total")
        check(proc.returncode == 2 and err.get("kind") == "kernel"
              and "nvcc" in err.get("error", ""),
              f"6d: rc {proc.returncode}, stdout {proc.stdout[-400:]!r}, "
              f"stderr {proc.stderr[-800:]!r}")
        check(metrics.exists() and retries == 0 and steps == 0,
              f"6d: metrics dump {metrics.exists()}, {retries} retries, "
              f"{steps} step-downs")
        out["no_nvcc"] = {"rc": proc.returncode, "retries": retries,
                          "step_downs": steps}
        log(f"phase 6d no nvcc: rc {proc.returncode}, {err}, {retries:.0f} "
            f"retries, {steps:.0f} step-downs")

        # (e) SIGKILL mid-run, resume, verify.
        kill_dir = tmp / "kill"
        kill_dir.mkdir()
        got = smoke_kill_resume(kill_dir, device=device.type,
                                difficulty=20, blocks=10)
        check(got["tip_hash"] == PINNED_TIPS[(20, 10, 20)],
              f"6e: resumed tip {got['tip_hash']}")
        out["kill_resume"] = got
        log(f"phase 6e d20 mine --checkpoint-every 1 SIGKILLed after "
            f"{got['mined_before_kill']} blocks (checkpoint at height "
            f"{got['checkpoint_height']}), resumed to {got['resumed_to']}, "
            f"verified, tip matches the pin; torn tail truncated to "
            f"{got['torn_truncated_to']} and re-mined")
    return out


def host_ms_per_block(run: dict, blocks: int) -> float:
    """The wall that is not sweep time, per block, in ms."""
    return (run["wall_s"] - run["kernel_s"]) / blocks * 1e3


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        from mpi_blockchain_tpu_torch.core.build import ensure_built
        from mpi_blockchain_tpu_torch.ops import sha256_cuda
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not here ({e})",
              file=sys.stderr)
        return 1
    try:
        device = torch.device("cuda", 0)
        card = nvidia_smi("name,power.limit")
        log(card)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            builds = [pool.submit(sha256_cuda.build),
                      pool.submit(ensure_built)]
            for b in builds:
                b.result()
        log(f"built the CUDA kernel and the C++ core in "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(20261016)
        mismatches, max_err = phase_kernel_vs_plain(rng, device)
        phase_backend(rng, device)
        chain = phase_tips(device)
        timing = phase_timing(rng, device)
        step = phase_step(rng, device, timing["sm_clock_mhz"])
        symbol_mismatches = phase_ext_symbol(device)
        fused = phase_fused(device, chain)
        resilience = phase_resilience(device)
    except (SmokeFailure, subprocess.CalledProcessError, RuntimeError,
            ValueError, AssertionError) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    f24, f16 = fused[(24, 1000)], fused[(16, 30)]
    log(f"card: {card}")
    log(json.dumps({"kernels": [{
        "name": "sha256d_sweep", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": f24["sweeps"],
        "launches_miner_d24_n1000": chain["launches"],
        "searches": chain["searches"], "mismatches": mismatches,
        "ext_symbol_mismatches": symbol_mismatches,
        "max_abs_err": max_err, "bound_by": "operations", "library_ms": None,
        **timing,
        "d24_n1000_wall_s": chain["wall_s"],
        "d24_n1000_hashes_per_s": chain["hashes_per_s"],
        "d24_n1000_kernel_s": chain["kernel_s"],
        "d24_n1000_kernel_share": chain["kernel_s"] / chain["wall_s"],
        "d24_n1000_least_nonces": chain["least_nonces"],
        "fused_d24_n1000": f24, "fused_d16_n30": f16,
        "resilience": resilience}, {
        "name": "sha256d_block_step", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": STEP_REPLACES,
        "launches": f24["steps"], "bound_by": "operations",
        "library_ms": None, **step,
        "gap_d24_n1000": {key: f24[key] for key in GAP_KEYS},
        "gap_d16_n30": {key: f16[key] for key in GAP_KEYS}}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
