"""Rebuilds the fused step kernel in the shapes its design was chosen
against and measures each against the shipped build, in turns, on one
NVIDIA GPU.

    python -m mpi_blockchain_tpu_torch.tools.step_variants

Each variant is ``ops/csrc/sha256d_sweep.cu`` with a few lines replaced
(``VARIANTS``), as ``sweep_variants`` builds the sweep's:

* ``shipped``: the source as it is: one thread, the three compressions
  unrolled, every global load before any store through ``__restrict__``
  pointers, and a programmatic dependent launch for a step after a sweep;
* ``compact_1``: the loop over the three compressions not unrolled, so the
  code holds one unrolled compression;
* ``compact_2``: also a compression's 4 trips of 16 rounds not unrolled,
  so the code holds one 16-round body;
* ``loads_in_order``: no ``__restrict__``; the nonce stored before the
  template and midstate are loaded, the data words loaded after the
  finalizing compressions;
* ``no_pdl``: every step in plain stream order;
* ``first_shape``: ``loads_in_order`` and ``no_pdl`` together, the order
  of loads, stores and launches of the step's first design.

For each it prints the step's compiled instructions and ptxas's registers,
stack and spills, then, all variants in turns (one of each per round, in
reverse order every other round): the step's device time a launch over
STEP_LAUNCHES launches enqueued back to back in one call; the body's SM
clocks from the measuring build's clock stamps; and whole k-block calls
(``sha256d_fused_enqueue``) of K_BLOCKS blocks at dbits LOW_DBITS, where
the sweeps are short and the time between them shows, and at dbits
FULL_DBITS, the full-size chain's difficulty: the device time per block of
calls without events (the median, the spread, and the median over rounds
of the difference to the shipped build's call in the same round), and,
from calls with events after each sweep and each step, the median gap
between two sweeps and its step and symbol-copy parts. The events hold
the programmatic dependent launch off, so only the calls without them show
it. Every variant must mine what ``mine_k_plain`` mines. The last line is
one JSON object with every number.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from ..core.build import BUILD_DIR, build_shared
from ..ops import sha256_block, sha256_cuda

_COMPACT_1 = [("#pragma unroll\n  for (int c = 0; c < 3; ++c) {",
               "#pragma unroll 1\n  for (int c = 0; c < 3; ++c) {")]
_COMPACT_2 = _COMPACT_1 + [
    ("#pragma unroll\n  for (int t = 0; t < 4; ++t) {",
     "#pragma unroll 1\n  for (int t = 0; t < 4; ++t) {")]
_LOADS_IN_ORDER = [
    ("const uint32_t* __restrict__ src", "const uint32_t* src"),
    ("block_step_kernel(const uint32_t* __restrict__ prev,\n"
     "                      const uint32_t* __restrict__ data,\n"
     "                      uint32_t* __restrict__ scratch,\n"
     "                      uint32_t* __restrict__ nonce_out,\n"
     "                      uint32_t* __restrict__ tip_out,",
     "block_step_kernel(const uint32_t* prev, const uint32_t* data,\n"
     "                      uint32_t* scratch, uint32_t* nonce_out,\n"
     "                      uint32_t* tip_out,"),
    ("  if (finalize) {\n    load_words(m, tail);\n"
     "    load_words(s, midstate);\n  }\n  if (build) load_words(dw, data);\n",
     ""),
    ("    nonce = result[1];\n",
     "    nonce = result[1];\n    *nonce_out = nonce;\n"
     "    load_words(m, tail);\n    load_words(s, midstate);\n"),
    ("    } else if (c == 2) {\n",
     "    } else if (c == 2) {\n      load_words(dw, data);\n"),
    ("  if (finalize) *nonce_out = nonce;\n", ""),
]
_NO_PDL = [
    ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n', ""),
    ("config.numAttrs = after_sweep ? 1 : 0;", "config.numAttrs = 0;"),
]
#: Variant name -> (text in the source, its replacement), each text found
#: exactly once.
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "shipped": [],
    "compact_1": _COMPACT_1,
    "compact_2": _COMPACT_2,
    "loads_in_order": _LOADS_IN_ORDER,
    "no_pdl": _NO_PDL,
    "first_shape": _LOADS_IN_ORDER + _NO_PDL,
}
STEP_LAUNCHES = 1000
K_BLOCKS = 100
LOW_DBITS, FULL_DBITS = 12, 24
LOW_REPS, FULL_REPS, FULL_EVENT_REPS = 10, 15, 3
CHECK_K, CHECK_DBITS = 6, 12


def variant_source(name: str) -> str:
    """The kernel's source with ``name``'s replacements made. Raises
    ValueError when a text to replace is not in the source exactly once."""
    text = sha256_cuda.SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is in the kernel's "
                             f"source {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def build_variant(name: str) -> pathlib.Path:
    """Writes and compiles one variant into the git-ignored build tree."""
    nvcc = sha256_cuda.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    src = BUILD_DIR / "variants" / f"sha256d_step_{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(variant_source(name))
    return build_shared([nvcc, *sha256_cuda.NVCC_FLAGS], [src], [],
                        src.with_name(f"libsha256d_step_{name}.so"))


def _u32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)) \
        .to(device)


class _Call:
    """The buffers of one k-block call and the call itself through one
    library; ``events`` (3 k + 1, recorded once) are recorded before and
    after each sweep and after each step."""

    def __init__(self, prev, data, dbits: int, device):
        self.prev, self.data, self.dbits = prev, data, dbits
        self.k = data.shape[0]
        self.scratch = torch.zeros(sha256_block.SCRATCH_WORDS,
                                   dtype=torch.int32, device=device)
        self.nonces = torch.zeros(self.k, dtype=torch.uint32, device=device)
        self.tip = torch.zeros(8, dtype=torch.uint32, device=device)

    def enqueue(self, lib, events=None) -> None:
        stream = torch.cuda.current_stream(self.prev.device).cuda_stream
        sweeps = steps = None
        if events is not None:
            handles = [ctypes.c_void_p(ev.cuda_event) for ev in events]
            sweeps = (ctypes.c_void_p * (2 * self.k))(*handles[:2 * self.k])
            steps = (ctypes.c_void_p * (self.k + 1))(*handles[2 * self.k:])
        err = lib.sha256d_fused_enqueue(
            self.prev.data_ptr(), self.data.data_ptr(), self.k, 0,
            self.dbits, 1 << 32, self.scratch.data_ptr(),
            self.nonces.data_ptr(), self.tip.data_ptr(), sweeps, steps,
            stream)
        if err:
            raise RuntimeError(f"fused enqueue failed: CUDA error {err}")

    def result(self) -> list:
        return [self.nonces.cpu().tolist(), self.tip.cpu().tolist()]


def _events(n: int) -> list:
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for ev in evs:              # creates each event before the call
        ev.record()
    return evs


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2]


def gaps_us(evs: list, k: int) -> tuple[list, list, list]:
    """The gaps between sweeps j and j + 1 of one call with events
    (``_Call.enqueue``), their step parts and their symbol-copy parts, in
    µs."""
    t = [evs[0].elapsed_time(ev) * 1e3 for ev in evs]
    gap = [t[2 * j + 2] - t[2 * j + 1] for j in range(k - 1)]
    step = [t[2 * k + j + 1] - t[2 * j + 1] for j in range(k - 1)]
    copy = [t[2 * j + 2] - t[2 * k + j + 1] for j in range(k - 1)]
    return gap, step, copy


def _nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           f"--format={fmt}"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("step_variants: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = _nvidia_smi("name,power.limit")
    clock_mhz = float(_nvidia_smi("clocks.max.sm", units=False))
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    torch.cuda.set_device(device)
    libs = {name: sha256_cuda.bind(path) for name, path in paths.items()}

    rng = np.random.default_rng(20261020)
    # Every variant mines a short call as the plain sequence does.
    prev = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
    data = rng.integers(0, 1 << 32, (CHECK_K, 8), dtype=np.uint32)
    want = [t.tolist() for t in sha256_block.mine_k_plain(
        _u32(prev, "cpu"), _u32(data, "cpu"), 0, CHECK_DBITS, 1 << 32)]
    agrees = {}
    for name, lib in libs.items():
        call = _Call(_u32(prev, device), _u32(data, device), CHECK_DBITS,
                     device)
        call.enqueue(lib)
        # The k-block call's read-back from the card (.cpu() of its
        # outputs), not a future: nothing on another thread completes it.
        agrees[name] = call.result() == want  # chainlint: disable=FUT002

    # The timed work: steps in a row, and k-block calls at two difficulties.
    prev_t = _u32(rng.integers(0, 1 << 32, 8, dtype=np.uint32), device)
    data_t = _u32(rng.integers(0, 1 << 32, (K_BLOCKS, 8), dtype=np.uint32),
                  device)
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch = sha256_block.new_scratch(device)
    slot = torch.zeros(1, dtype=torch.uint32, device=device)
    stamps = torch.zeros(2 * STEP_LAUNCHES, dtype=torch.int64, device=device)
    calls = {d: _Call(prev_t, data_t, d, device)
             for d in (LOW_DBITS, FULL_DBITS)}
    names = list(libs)

    def repeat(lib, n, stamp=None):
        err = lib.sha256d_block_step_repeat(
            n, prev_t.data_ptr(), data_t[1].data_ptr(), scratch.data_ptr(),
            slot.data_ptr(), None, 1, FULL_DBITS,
            None if stamp is None else stamp.data_ptr(), stream)
        if err:
            raise RuntimeError(f"step repeat failed: CUDA error {err}")

    def bracket(enqueue) -> list:
        """Events recorded before and after what ``enqueue`` enqueues."""
        ev = _events(2)
        ev[0].record()
        enqueue()
        ev[1].record()
        return ev

    times = {name: {"step_us": [], "body_clocks": [], "low_call": [],
                    "low_gaps": [], "full_call": [], "full_gaps": []}
             for name in names}
    for name, lib in libs.items():                      # warm-up
        repeat(lib, 10)
        calls[LOW_DBITS].enqueue(lib)
    torch.cuda.synchronize()
    pending = []
    for rep in range(LOW_REPS):
        for name in (names if rep % 2 == 0 else names[::-1]):
            lib, row = libs[name], times[name]
            ev = bracket(lambda: repeat(lib, STEP_LAUNCHES))
            pending.append((row["step_us"], ev, 1e3 / STEP_LAUNCHES))
            repeat(lib, STEP_LAUNCHES, stamps)
            row["body_clocks"].append(_median(
                (stamps[1::2] - stamps[::2]).tolist()))
            ev = bracket(lambda: calls[LOW_DBITS].enqueue(lib))
            pending.append((row["low_call"], ev, 1e3 / K_BLOCKS))
            evs = _events(3 * K_BLOCKS + 1)
            calls[LOW_DBITS].enqueue(lib, evs)
            row["low_gaps"].append(evs)
    for rep in range(FULL_REPS):
        for name in (names if rep % 2 == 0 else names[::-1]):
            ev = bracket(lambda: calls[FULL_DBITS].enqueue(libs[name]))
            pending.append((times[name]["full_call"], ev, 1e3 / K_BLOCKS))
            if rep < FULL_EVENT_REPS:
                evs = _events(3 * K_BLOCKS + 1)
                calls[FULL_DBITS].enqueue(libs[name], evs)
                times[name]["full_gaps"].append(evs)
    torch.cuda.synchronize()
    for dst, ev, scale in pending:
        dst.append(ev[0].elapsed_time(ev[1]) * scale)

    report = {}
    for name, path in paths.items():
        census = sha256_cuda.function_census(
            sha256_cuda.disassemble(path), sha256_cuda.STEP_KERNEL_SYMBOL)
        resources = sha256_cuda.ptxas_report(
            sha256_cuda.build_report(path), sha256_cuda.STEP_KERNEL_SYMBOL)
        row = times[name]
        body = _median(row["body_clocks"])
        out = {"instructions": sum(census.values()), **resources,
               "step_device_us": _median(row["step_us"]),
               "body_clocks": body, "body_us": body / clock_mhz}
        for d, key in ((LOW_DBITS, "low"), (FULL_DBITS, "full")):
            call = row[f"{key}_call"]
            diff = [a - b for a, b in zip(call, times["shipped"][
                f"{key}_call"])]
            split = [sum(parts, []) for parts in zip(
                *(gaps_us(evs, K_BLOCKS) for evs in row[f"{key}_gaps"]))]
            out.update({
                f"d{d}_call_us_per_block": _median(call),
                f"d{d}_call_us_per_block_min": min(call),
                f"d{d}_call_us_per_block_max": max(call),
                f"d{d}_call_minus_shipped_us": _median(diff),
                f"d{d}_gap_us": _median(split[0]),
                f"d{d}_gap_step_us": _median(split[1]),
                f"d{d}_gap_copy_us": _median(split[2])})
        out["agrees"] = agrees[name]
        report[name] = out
        print(f"{name}: {out['instructions']} instructions, {resources}; "
              f"step {out['step_device_us']:.4f} us a launch back to back; "
              f"body {body} SM clocks ({out['body_us']:.4f} us at "
              f"{clock_mhz:.0f} MHz); " + "; ".join(
                  f"d{d} call {out[f'd{d}_call_us_per_block']:.4f} us a "
                  f"block (min {out[f'd{d}_call_us_per_block_min']:.4f}, "
                  f"max {out[f'd{d}_call_us_per_block_max']:.4f}, minus "
                  f"shipped {out[f'd{d}_call_minus_shipped_us']:.4f}), gap "
                  f"{out[f'd{d}_gap_us']:.4f} us (step "
                  f"{out[f'd{d}_gap_step_us']:.4f}, copy "
                  f"{out[f'd{d}_gap_copy_us']:.4f})"
                  for d in (LOW_DBITS, FULL_DBITS))
              + f"; agrees {out['agrees']}", flush=True)
    print(json.dumps({"card": card, "sm_clock_mhz": clock_mhz,
                      "k_blocks": K_BLOCKS, "low_reps": LOW_REPS,
                      "full_reps": FULL_REPS,
                      "full_event_reps": FULL_EVENT_REPS,
                      "variants": report}))
    return 0 if all(r["agrees"] for r in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
