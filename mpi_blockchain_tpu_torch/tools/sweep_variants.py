"""Rebuilds the CUDA sweep kernel with other pipe-balance, occupancy and
block-size choices and measures each against the shipped build, on one
NVIDIA GPU.

    python -m mpi_blockchain_tpu_torch.tools.sweep_variants

Each variant is ``ops/csrc/sha256d_sweep.cu`` with a few lines replaced
(``VARIANTS``):

* ``shipped``: the source as it is, every add of the rounds and the
  schedule written as ``x * one + y`` (IMAD on the FMA pipe);
* ``off_path_adds_on_fma``: only the adds off a round's critical path
  (h + K + w, the schedule word's last add) written so, the others as
  plain adds;
* ``adds_on_alu``: ``add_on_fma`` written as a plain add, so the compiler
  chooses every add's pipe;
* ``five_blocks``: the shipped source with a launch bound of 5 blocks of
  256 threads per SM, which caps the registers a thread may use;
* ``blocks_of_1024``: blocks of 1024 threads, one per SM, so that every
  warp on an SM belongs to one block.

For each it prints the loop's census, the census figure and the kernel's
bound (``sha256_cuda.bound_sm_clocks_per_nonce``) and the resident blocks;
the median CUDA-event time of a full sweep of 2^24 nonces, and the median,
mean and largest time of one early-exit launch over [0, 2^32) beside a
full sweep of exactly the nonces it needs, both at dbits 24, all variants
launched in turns; and, from a second build whose measuring counter is
kept per warp (``PER_WARP``), the slices each warp takes in a full sweep
and the nonces early-exit launches hash past the winner. Every variant
must find what the shipped one finds. The last line is one JSON object
with every number.
"""
from __future__ import annotations

import concurrent.futures
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from .. import core
from ..core.build import BUILD_DIR, build_shared
from ..ops import sha256_cuda
from ..ops.sha256_sched import extend_midstate

DBITS = 24
FULL_NONCES = 1 << 24
NONCE_SPACE = 1 << 32

#: Variant name -> (text in the source, its replacement), each text found
#: exactly once.
VARIANTS: dict[str, list[tuple[str, str]]] = {
    "shipped": [],
    "off_path_adds_on_fma": [
        ("add_on_fma(add_on_fma(w[r - 16], w[r - 7], one),\n"
         "                   small_sigma0(w[r - 15]), one)",
         "w[r - 16] + w[r - 7] + small_sigma0(w[r - 15])"),
        ("add_on_fma(\n"
         "        add_on_fma(add_on_fma(h, kK[r] + w[r], one), big_sigma1(e), "
         "one),\n        ch(e, f, g), one)",
         "add_on_fma(h, kK[r] + w[r], one) + big_sigma1(e) + ch(e, f, g)"),
        ("add_on_fma(big_sigma0(a), maj(a, b, c), one)",
         "big_sigma0(a) + maj(a, b, c)"),
        ("e = add_on_fma(d, t1, one);", "e = d + t1;"),
        ("a = add_on_fma(t1, t2, one);", "a = t1 + t2;"),
    ],
    "adds_on_alu": [("return x * one + y;", "(void)one;\n  return x + y;")],
    "five_blocks": [("__launch_bounds__(kBlock)",
                     "__launch_bounds__(kBlock, 5)")],
    "blocks_of_1024": [("constexpr int kBlock = 256;",
                        "constexpr int kBlock = 1024;")],
}
#: Makes the measuring build count the nonces of each warp in its own slot
#: of ``hashed`` (the warp's index in the grid).
PER_WARP = ("atomicAdd(hashed, left < kSlice ? left : kSlice);",
            "atomicAdd(hashed + blockIdx.x * (kBlock / 32) + threadIdx.x / 32,"
            "\n                left < kSlice ? left : kSlice);")
OVERSHOOT_LAUNCHES = 51


def variant_source(name: str, per_warp: bool = False) -> str:
    """The kernel's source with ``name``'s replacements made (and
    ``PER_WARP``'s). Raises ValueError when a text to replace is not in
    the source exactly once."""
    text = sha256_cuda.SOURCE.read_text()
    for old, new in VARIANTS[name] + ([PER_WARP] if per_warp else []):
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is in the kernel's "
                             f"source {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def build_variant(name: str, per_warp: bool = False) -> pathlib.Path:
    """Writes and compiles one variant into the git-ignored build tree."""
    nvcc = sha256_cuda.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    stem = f"{name}_per_warp" if per_warp else name
    src = BUILD_DIR / "variants" / f"sha256d_sweep_{stem}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(variant_source(name, per_warp))
    return build_shared([nvcc, *sha256_cuda.NVCC_FLAGS], [src], [],
                        src.with_name(f"libsha256d_sweep_{stem}.so"))


def _launch(lib, ext: np.ndarray, count: int, early_exit: bool,
            out: torch.Tensor, hashed: torch.Tensor | None = None) -> None:
    err = lib.sha256d_sweep_launch(
        ext.ctypes.data, 0, count, DBITS, int(early_exit), out.data_ptr(),
        None if hashed is None else hashed.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def time_in_turns(libs: dict, ext: np.ndarray, shapes: dict, reps: int,
                  device: torch.device) -> tuple[dict, dict]:
    """CUDA-event ms of every launch of each library at each shape
    (name -> (count, early_exit), from nonce 0, at DBITS): per round one
    of each, libraries in reverse order every other round. Returns the
    times by (library, shape) and each pair's last result."""
    fresh = sha256_cuda.new_result(device)
    keys = [(lib, shape) for lib in libs for shape in shapes]
    outs = {key: fresh.clone() for key in keys}
    events = {key: [] for key in keys}
    for rep in range(reps):
        for key in (keys if rep % 2 == 0 else keys[::-1]):
            outs[key].copy_(fresh)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            _launch(libs[key[0]], ext, *shapes[key[1]], outs[key])
            ev[1].record()
            events[key].append(ev)
    torch.cuda.synchronize()
    times = {key: [a.elapsed_time(b) for a, b in events[key]]
             for key in keys}
    return times, {key: sha256_cuda.read_result(outs[key]) for key in keys}


def per_warp_counts(lib, ext: np.ndarray, count: int, early_exit: bool,
                    launches: int, sms: int, device: torch.device
                    ) -> np.ndarray:
    """(launches, warps) nonces each warp of the grid took, from a
    ``PER_WARP`` build; slots past the grid must stay 0."""
    warps = lib.sha256d_sweep_resident_blocks(DBITS) \
        * lib.sha256d_sweep_block_threads() // 32
    slots = sms * 64                    # the most warps an SM holds
    hashed = torch.zeros(launches, slots, dtype=torch.int64, device=device)
    fresh = sha256_cuda.new_result(device)
    for i in range(launches):
        _launch(lib, ext, count, early_exit, fresh.clone(), hashed[i])
    counts = hashed.cpu().numpy()
    if counts[:, warps:].any():
        raise RuntimeError("a warp past the resident grid counted nonces")
    return counts[:, :warps]


def _nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           f"--format={fmt}"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_variants: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = _nvidia_smi("name,power.limit")
    clock_mhz = float(_nvidia_smi("clocks.max.sm", units=False))
    print(card, flush=True)
    jobs = [(name, per_warp) for name in VARIANTS for per_warp in (0, 1)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build_variant(*j), jobs)))
    torch.cuda.set_device(device)
    paths = {name: built[name, 0] for name in VARIANTS}
    libs = {name: sha256_cuda.bind(path) for name, path in paths.items()}
    per_warp = {name: sha256_cuda.bind(built[name, 1]) for name in VARIANTS}

    # A seeded header whose dbits-24 winner lies in [2^23, 2^25).
    rng = np.random.default_rng(20261018)
    for _ in range(64):
        hdr = rng.integers(0, 256, size=80, dtype=np.uint8).tobytes()
        ext = extend_midstate(*core.header_midstate(hdr))
        found, winner = sha256_cuda.sweep(ext, 0, NONCE_SPACE, DBITS,
                                          device=device, early_exit=True)
        if found and (1 << 23) <= winner < (1 << 25):
            break
    else:
        raise RuntimeError("no header in 64 draws fits")
    need = winner + 1
    full_t, full = time_in_turns(libs, ext, {"full": (FULL_NONCES, False)},
                                 50, device)
    path_t, path = time_in_turns(
        libs, ext, {"main": (NONCE_SPACE, True), "exact": (need, False)}, 60,
        device)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    adds = sha256_cuda.source_adds(DBITS)
    per_ms = FULL_NONCES / (sms * clock_mhz * 1e6) * 1e3
    report = {}
    for name, path_lib in paths.items():
        census = sha256_cuda.loop_census(sha256_cuda.disassemble(path_lib),
                                         DBITS)
        alu, fma, total = sha256_cuda.pipe_counts(census)
        bound = sha256_cuda.bound_sm_clocks_per_nonce(census, adds)
        by_census = sha256_cuda.sm_clocks_per_nonce(census)
        ok = full[name, "full"] == full["shipped", "full"] \
            and path[name, "main"][1] == winner \
            and path[name, "exact"] == (1, winner)
        main_t, exact_t = path_t[name, "main"], path_t[name, "exact"]
        ratio = [m / e for m, e in zip(main_t, exact_t)]
        slices = np.sort(per_warp_counts(per_warp[name], ext, FULL_NONCES,
                                         False, 1, sms, device)[0] // 32)
        counts = per_warp_counts(per_warp[name], ext, NONCE_SPACE, True,
                                 OVERSHOOT_LAUNCHES, sms, device)
        over = np.sort(counts.sum(axis=1) - need)
        warps = counts.shape[1]
        row = report[name] = {
            "ms_per_2^24": float(np.median(full_t[name, "full"])),
            "main_path_ms": float(np.median(main_t)),
            "main_path_mean_ms": float(np.mean(main_t)),
            "main_path_max_ms": float(np.max(main_t)),
            "exact_sweep_ms": float(np.median(exact_t)),
            "main_over_exact_mean": float(np.mean(ratio)),
            "main_over_exact_max": float(np.max(ratio)),
            "resident_blocks": libs[name].sha256d_sweep_resident_blocks(
                DBITS), "resident_warps": warps,
            "slices_per_warp_min": int(slices[0]),
            "slices_per_warp_median": int(slices[len(slices) // 2]),
            "slices_per_warp_max": int(slices[-1]),
            "overshoot_median": int(over[len(over) // 2]),
            "overshoot_p90": int(over[len(over) * 9 // 10]),
            "overshoot_max": int(over[-1]),
            "overshoot_past_one_slice_per_warp": int((over > warps * 32)
                                                     .sum()),
            "loop_instructions": total, "loop_alu_ops": alu,
            "loop_fma_ops": fma,
            "loop_alu_only_ops": sha256_cuda.alu_only_count(census),
            "census_sm_clocks_per_nonce": by_census,
            "census_bound_ms_per_2^24": by_census * per_ms,
            "bound_sm_clocks_per_nonce": bound,
            "bound_ms_per_2^24": bound * per_ms, "agrees": ok,
            "census": census}
        print(f"{name}: 2^24 sweep {row['ms_per_2^24']:.4f} ms; main-path "
              f"launch median {row['main_path_ms']:.4f} ms, mean "
              f"{row['main_path_mean_ms']:.4f}, max "
              f"{row['main_path_max_ms']:.4f}, against its exact sweep "
              f"{row['exact_sweep_ms']:.4f} (ratio mean "
              f"{row['main_over_exact_mean']:.4f}, max "
              f"{row['main_over_exact_max']:.4f}); {row['resident_blocks']} "
              f"blocks, {warps} warps; slices a warp takes in a 2^24 sweep "
              f"{row['slices_per_warp_min']} to {row['slices_per_warp_max']}"
              f" (median {row['slices_per_warp_median']}); overshoot over "
              f"{OVERSHOOT_LAUNCHES} launches median "
              f"{row['overshoot_median']}, 90th percentile "
              f"{row['overshoot_p90']}, max {row['overshoot_max']}, "
              f"{row['overshoot_past_one_slice_per_warp']} past "
              f"{warps * 32}; loop {total} instructions, {alu} ALU-pipe, "
              f"{fma} FMA-pipe, {row['loop_alu_only_ops']} ALU-only; census "
              f"{by_census:.4f} clocks a nonce ({by_census * per_ms:.4f} ms "
              f"per 2^24), bound {bound:.4f} ({bound * per_ms:.4f} ms); "
              f"agrees {ok}", flush=True)
    print(json.dumps({"card": card, "sm_clock_mhz": clock_mhz, "sms": sms,
                      "winner": winner, "source_adds_per_nonce": adds,
                      "variants": report}))
    return 0 if all(r["agrees"] for r in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
