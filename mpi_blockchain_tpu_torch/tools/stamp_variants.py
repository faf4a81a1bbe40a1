"""Rebuilds the stamped sweep with its end stamp (or its start stamp) in
other places and times each against the plain build, on one NVIDIA GPU.

    python -m mpi_blockchain_tpu_torch.tools.stamp_variants [--rounds 2]

The stamped build (``sha256d_sweep_launch_stamped``) times a sweep on the
card for the traced per-block miner: each block of the sweep takes the
minimum of ``%globaltimer`` into a start word when it enters, and a
one-thread kernel that follows the sweep on its stream writes the timer
into an end word. Each variant is ``ops/csrc/sha256d_sweep.cu`` with a few
lines replaced (``VARIANTS``):

* ``shipped``: the source as it is;
* ``end_after_barrier``: thread 0 of each block takes the maximum of the
  timer into the end word once every warp of its block has left the loop
  (a barrier), and no following kernel;
* ``end_by_warp``: lane 0 of each warp does so when its warp leaves the
  loop, no barrier;
* ``end_opaque_address``: as ``end_after_barrier``, the end word's address
  computed from ``out`` in inline PTX, which the compiler cannot share
  with the start word's;
* ``start_by_parameter``: as ``end_after_barrier``, the start word passed
  to the kernel apart, in its ``hashed`` argument;
* ``start_not_inlined``: as ``end_after_barrier``, the start stamp in a
  ``__noinline__`` function;
* ``start_by_kernel``: the start word written by a one-thread kernel that
  precedes the sweep on its stream, the end after a barrier in the sweep.

For each it prints ptxas's registers for the stamped and the plain
instantiation at dbits 64 and the census of the stamped loop, then, in
turns (variants in reverse order every other round), one plain and one
stamped full sweep of 2^24 nonces at dbits 64 each on an idle card, with
CUDA events around the library's call and a marker kernel before and
after that reads the timer (the library's ``sha256d_globaltimer_tick``):
the events' µs, the µs from the first marker to the second, and for the
stamped sweep its window (end less start). Medians over the rounds'
launches. The last line is one JSON object with every number, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from .. import core
from ..core.build import BUILD_DIR, build_log, build_shared
from ..ops import sha256_cuda
from ..ops.sha256_sched import extend_midstate

DBITS = 64
FULL_NONCES = 1 << 24
LAUNCHES_A_ROUND = 10

_START = """  if (kStamp && threadIdx.x == 0)
    atomicMin(reinterpret_cast<unsigned long long*>(out + kStampStart),
              global_timer());
"""
_LOOP_END = """        atomicMin(out + 1, lowest);
      }
    }
  }
}
"""
_END_KERNEL = """  const int err =
      launch_mode<false, false, true>(difficulty_bits, args, o, nullptr, s);
  if (err != 0) return err;
  sweep_end_stamp_kernel<<<1, 1, 0, s>>>(
      reinterpret_cast<unsigned long long*>(o + kStampEnd));
  return static_cast<int>(cudaGetLastError());"""
_NO_END_KERNEL = """  return launch_mode<false, false, true>(difficulty_bits, args, o, nullptr,
                                         s);"""
_BY_PARAMETER = """  return launch_mode<false, false, true>(
      difficulty_bits, args, o,
      reinterpret_cast<unsigned long long*>(o + kStampStart), s);"""
_BY_KERNEL = """  sweep_start_stamp_kernel<<<1, 1, 0, s>>>(
      reinterpret_cast<unsigned long long*>(o + kStampStart));
  return launch_mode<false, false, true>(difficulty_bits, args, o, nullptr,
                                         s);"""
_STAMP_KERNEL_AT = "// The stamped build's end: one thread, launched right"
_START_KERNEL = """__global__ void __launch_bounds__(1)
    sweep_start_stamp_kernel(unsigned long long* __restrict__ start) {
  *start = global_timer();
}

""" + _STAMP_KERNEL_AT
_HELPERS_AT = "// One trip of the loop takes a slice from the cursor"
_HELPERS = """__device__ __forceinline__ unsigned long long* opaque_word(uint32_t* out,
                                                           int word) {
  unsigned long long* p;
  asm volatile("add.u64 %0, %1, %2;"
               : "=l"(p)
               : "l"(out), "l"(static_cast<unsigned long long>(4 * word)));
  return p;
}

__device__ __noinline__ void stamp_start(uint32_t* out) {
  atomicMin(reinterpret_cast<unsigned long long*>(out + kStampStart),
            global_timer());
}

""" + _HELPERS_AT


def _end(warp: bool = False, opaque: bool = False) -> str:
    word = ("opaque_word(out, kStampEnd)" if opaque else
            "reinterpret_cast<unsigned long long*>(out + kStampEnd)")
    if warp:
        body = f"""  if (kStamp && lane == 0) atomicMax({word}, global_timer());
"""
    else:
        body = f"""  if (kStamp) {{
    __syncthreads();
    if (threadIdx.x == 0) atomicMax({word}, global_timer());
  }}
"""
    return _LOOP_END[:-2] + body + "}\n"


def _in_kernel_end(**end) -> list[tuple[str, str]]:
    return [(_LOOP_END, _end(**end)), (_END_KERNEL, _NO_END_KERNEL),
            (_HELPERS_AT, _HELPERS)]


#: Variant name -> (text in the source, its replacement), each text found
#: exactly once.
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "shipped": [],
    "end_after_barrier": _in_kernel_end(),
    "end_by_warp": _in_kernel_end(warp=True),
    "end_opaque_address": _in_kernel_end(opaque=True),
    "start_by_parameter": [
        (_START, "  if (kStamp && threadIdx.x == 0) "
                 "atomicMin(hashed, global_timer());\n"),
        (_LOOP_END, _end()), (_END_KERNEL, _BY_PARAMETER)],
    "start_not_inlined": [
        (_START, "  if (kStamp && threadIdx.x == 0) stamp_start(out);\n"),
        *_in_kernel_end()],
    "start_by_kernel": [
        (_START, ""), (_LOOP_END, _end()), (_END_KERNEL, _BY_KERNEL),
        (_STAMP_KERNEL_AT, _START_KERNEL)],
}


def variant_source(name: str) -> str:
    """The kernel's source with ``name``'s replacements made. Raises
    ValueError when a text to replace is not in the source exactly
    once."""
    text = sha256_cuda.SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is in the kernel's "
                             f"source {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def build_variant(name: str):
    """Writes and compiles one variant into the git-ignored build tree."""
    nvcc = sha256_cuda.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    src = BUILD_DIR / "stamp_variants" / f"sha256d_sweep_{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(variant_source(name))
    return build_shared([nvcc, *sha256_cuda.NVCC_FLAGS], [src], [],
                        src.with_name(f"libsha256d_sweep_{name}.so"))


def compiled(path) -> dict:
    """ptxas's registers of the plain and the stamped instantiation at
    DBITS, and the stamped loop's census (instructions, ALU-only)."""
    log = build_log(path).read_text()
    census = sha256_cuda.loop_census(sha256_cuda.disassemble(path), DBITS,
                                     stamped=True)
    return {"registers_plain": sha256_cuda.ptxas_report(
                log, sha256_cuda.kernel_symbol(DBITS))["registers"],
            "registers_stamped": sha256_cuda.ptxas_report(
                log, sha256_cuda.kernel_symbol(DBITS, stamped=True)
            )["registers"],
            "stamped_loop": sum(census.values()),
            "stamped_loop_alu_only": sha256_cuda.alu_only_count(census)}


def one_launch(lib, ext: np.ndarray, stamped: bool,
               device: torch.device) -> dict:
    """One full sweep on an idle card between marker kernels and CUDA
    events; its µs."""
    stream = torch.cuda.current_stream(device).cuda_stream
    before = torch.zeros(4, dtype=torch.int64, device=device)
    after = torch.zeros(4, dtype=torch.int64, device=device)
    out = sha256_cuda.new_result(device, stamped=stamped)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if lib.sha256d_globaltimer_tick(before.data_ptr(), 2, stream):
        raise RuntimeError("the marker kernel did not launch")
    a.record()
    if stamped:
        err = lib.sha256d_sweep_launch_stamped(
            ext.ctypes.data, 0, FULL_NONCES, DBITS, 0, out.data_ptr(), stream)
    else:
        err = lib.sha256d_sweep_launch(
            ext.ctypes.data, 0, FULL_NONCES, DBITS, 0, out.data_ptr(), None,
            stream)
    b.record()
    if err or lib.sha256d_globaltimer_tick(after.data_ptr(), 2, stream):
        raise RuntimeError(f"launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    first, last = before.tolist()[3], after.tolist()[2]
    row = {"events_us": a.elapsed_time(b) * 1e3,
           "markers_us": (last - first) / 1e3}
    count, best, *stamps = sha256_cuda.read_result(
        out, sha256_cuda.STAMPED_RESULT_WORDS if stamped else 2)
    if (count, best) != (0, 0xFFFFFFFF):
        raise RuntimeError(f"a sweep at dbits {DBITS} found {count, best}")
    if stamped:
        start, end = stamps
        if not first <= start <= end <= last:
            raise RuntimeError(f"stamps {start}, {end} outside the markers "
                               f"{first}, {last}")
        row["window_us"] = (end - start) / 1e3
    return row


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.tools.stamp_variants",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stamp_variants: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(card(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    libs = {name: sha256_cuda.bind(path) for name, path in paths.items()}
    result = {name: compiled(path) for name, path in paths.items()}
    ext = extend_midstate(*core.header_midstate(bytes(range(80))))
    rows = {(name, stamped): [] for name in VARIANTS
            for stamped in (False, True)}
    for name in VARIANTS:                               # warm each build
        one_launch(libs[name], ext, True, device)
    for r in range(max(1, args.rounds)):
        order = list(VARIANTS) if r % 2 == 0 else list(VARIANTS)[::-1]
        for name in order:
            for _ in range(LAUNCHES_A_ROUND):
                for stamped in (False, True):
                    rows[name, stamped].append(
                        one_launch(libs[name], ext, stamped, device))
    for name in VARIANTS:
        for stamped in (False, True):
            got = rows[name, stamped]
            result[name]["stamped" if stamped else "plain"] = {
                key: statistics.median(row[key] for row in got)
                for key in got[0]}
        print(f"{name}: {json.dumps(result[name])}", flush=True)
    result["card"] = card()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
