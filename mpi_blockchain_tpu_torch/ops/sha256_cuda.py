"""The hand-written CUDA double-SHA-256 sweep: build, binding and wrapper.

``csrc/sha256d_sweep.cu`` is compiled by ``nvcc`` for ``sm_90a`` into the
package's git-ignored ``build/`` directory at first use and bound with
ctypes through its plain C interface. ``sweep`` is the entry point: on a
CUDA device it launches the kernel or raises; only for the CPU device does
it run the plain PyTorch version (``sha256_torch.sweep_core_ext``).
``loop_census`` and ``sm_clocks_per_nonce`` give the kernel's bound from
the instructions the compiler emitted.
"""
from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import re
import shutil
import subprocess

import numpy as np
import torch

from ..config import ConfigError
from ..core.build import BUILD_DIR, build_shared
from . import sha256_torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "sha256d_sweep.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: Kernel launches so far. ``launch`` adds one per launch and nothing else
#: touches it, so a caller can zero it, run a path and read it back.
launches = 0


def find_nvcc() -> str | None:
    """``nvcc`` under ``CUDA_HOME`` (or PyTorch's idea of it), else on
    ``PATH``; None when there is none."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc")


def build() -> pathlib.Path:
    """Compiles the kernel library if it is missing or out of date."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PyTorch's CUDA_HOME "
            "and PATH): the CUDA sweep kernel cannot be built")
    return build_shared([nvcc, *NVCC_FLAGS], [SOURCE], [],
                        BUILD_DIR / "libsha256d_sweep.so")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.sha256d_sweep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.sha256d_sweep_launch.restype = ctypes.c_int
    lib.sha256d_sweep_resident_blocks.argtypes = [ctypes.c_int]
    lib.sha256d_sweep_resident_blocks.restype = ctypes.c_longlong
    lib.sha256d_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sha256d_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_error(what: str, err: int) -> RuntimeError:
    return RuntimeError(f"{what} failed: CUDA error {err} "
                        f"({_lib().sha256d_sweep_error_string(err).decode()})")


def new_result(device: torch.device) -> torch.Tensor:
    """A result buffer {count, min} reset to {0, 0xFFFFFFFF}, as int32
    words (the kernel reads them as uint32)."""
    return torch.tensor([0, -1], dtype=torch.int32, device=device)


def launch(ext_host: np.ndarray, base: int, count: int,
           difficulty_bits: int, out: torch.Tensor, *,
           early_exit: bool = False,
           hashed: torch.Tensor | None = None) -> None:
    """Enqueues one sweep of [base, base + count) on the current stream of
    ``out``'s device, accumulating into ``out`` (see ``new_result``).
    ``ext_host`` is the (20,) uint32 extended midstate in host memory; it
    travels by value in the kernel's arguments. Does not synchronise.

    ``hashed``, a (1,) int64 tensor on the same device, selects the
    measuring build of the kernel, which adds to it the number of nonces it
    hashed (with ``early_exit``, how far the sweep ran past the winner)."""
    global launches
    if out.device.type != "cuda" or out.dtype != torch.int32 \
            or out.shape != (2,) or not out.is_contiguous():
        raise ValueError("out must be a contiguous (2,) int32 CUDA tensor")
    if hashed is not None and (hashed.device != out.device
                               or hashed.dtype != torch.int64
                               or hashed.shape != (1,)):
        raise ValueError("hashed must be a (1,) int64 tensor on out's "
                         "device")
    ext = np.ascontiguousarray(ext_host, dtype=np.uint32)
    if ext.shape != (20,):
        raise ValueError(f"ext must have shape (20,), got {ext.shape}")
    sha256_torch.check_range(base, count)
    if count == 0:
        return
    if difficulty_bits > 64:
        raise ConfigError(f"difficulty_bits {difficulty_bits} > 64 "
                          f"unsupported")
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.sha256d_sweep_launch(
            ext.ctypes.data, base, count, int(difficulty_bits),
            int(early_exit), out.data_ptr(),
            None if hashed is None else hashed.data_ptr(), stream)
    if err != 0:
        raise _cuda_error("sha256d_sweep launch", err)
    launches += 1


def resident_blocks(difficulty_bits: int, device: torch.device) -> int:
    """Thread blocks of the kernel's persistent grid on ``device`` for
    ``difficulty_bits`` (SMs times the blocks each SM holds at once)."""
    with torch.cuda.device(device):
        blocks = _lib().sha256d_sweep_resident_blocks(int(difficulty_bits))
    if blocks <= 0:
        raise _cuda_error("the occupancy query", -blocks)
    return blocks


def read_result(out: torch.Tensor) -> tuple[int, int]:
    """(count, min_nonce) from a result buffer; synchronises on it."""
    count, best = (int(v) & 0xFFFFFFFF for v in out.tolist())
    return count, best


def sweep(ext, base: int, count: int, difficulty_bits: int, *,
          device: torch.device | str, early_exit: bool = False
          ) -> tuple[int, int]:
    """(count, min_nonce) over nonces [base, base + count).

    On a CUDA ``device`` this launches the hand-written kernel (one launch,
    one 8-byte read-back) or raises; on the CPU it runs the plain PyTorch
    version. ``ext`` is the 20-word extended midstate (numpy, or a tensor,
    which is copied to the host). Same contract as
    ``sha256_torch.sweep_core_ext``: min_nonce is 0xFFFFFFFF when count is
    0, and with ``early_exit`` count is only a found-flag.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return sha256_torch.sweep_core_ext(
            np.asarray(sha256_torch.ext_words(ext), dtype=np.uint32), base,
            count, difficulty_bits, early_exit=early_exit)
    if device.type != "cuda":
        raise ConfigError(f"the sweep runs on a CUDA device or the CPU, "
                          f"not {device}")
    if not torch.cuda.is_available():
        raise ConfigError(f"no CUDA device is available for {device}")
    ext_host = np.asarray(sha256_torch.ext_words(ext), dtype=np.uint32)
    out = new_result(device)
    launch(ext_host, base, count, difficulty_bits, out,
           early_exit=early_exit)
    return read_result(out)


#: What one Hopper SM retires per clock, in thread-instructions: four
#: schedulers each issue one 32-thread instruction, and the integer ALU
#: pipe and the FMA pipe each take 64 (CUDA C++ Programming Guide,
#: arithmetic instruction throughput, compute capability 9.0). The pipe of
#: each opcode follows the Nsight Compute profiling guide: the ALU runs bit
#: manipulation, logic and the integer instructions other than IMAD/IMUL,
#: which run on the FMA pipe. An opcode in neither set (VIADD, uniform and
#: memory instructions) counts toward issue only, so the bound stays a floor.
ISSUE_PER_SM_CLOCK = 128
PIPE_PER_SM_CLOCK = 64
ALU_OPCODES = frozenset({"SHF", "LOP3", "IADD3", "PRMT", "ISETP", "SEL",
                         "LEA", "IMNMX", "BMSK", "SGXT"})
FMA_OPCODES = frozenset({"IMAD", "IMUL", "FFMA", "FADD", "FMUL"})

_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)([^;]*);")


def difficulty_class(difficulty_bits: int) -> int:
    """The kernel template (``Mode`` in the source) serving a difficulty."""
    d = int(difficulty_bits)
    return 0 if d <= 0 else 1 if d < 32 else 2 if d == 32 else \
        3 if d < 64 else 4


def disassemble() -> str:
    """``cuobjdump -sass`` of the built kernel library."""
    nvcc = find_nvcc()
    tool = pathlib.Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.is_file():
        raise RuntimeError("cuobjdump not found beside nvcc")
    return subprocess.run([str(tool), "-sass", str(build())],
                          capture_output=True, text=True, check=True).stdout


def loop_census(sass: str, difficulty_bits: int) -> dict[str, int]:
    """Instructions by opcode in the main loop of the production kernel
    serving ``difficulty_bits``, from ``cuobjdump -sass`` text. One trip of
    that loop hashes one nonce per thread; the loop is the span of the
    longest backward branch."""
    name = f"sha256d_sweep_kernelILi{difficulty_class(difficulty_bits)}ELb0E"
    for part in sass.split("Function : ")[1:]:
        if name not in part.splitlines()[0]:
            continue
        insts = [(int(addr, 16), op, operands)
                 for addr, op, operands in _SASS_LINE.findall(part)]
        back = []
        for addr, op, operands in insts:
            target = re.findall(r"0x([0-9a-f]+)", operands)
            if op == "BRA" and target and int(target[-1], 16) < addr:
                back.append((int(target[-1], 16), addr))
        if not back:
            raise ValueError(f"no loop found in {name}")
        lo, hi = max(back, key=lambda span: span[1] - span[0])
        counts: dict[str, int] = {}
        for addr, op, _ in insts:
            if lo <= addr <= hi:
                counts[op] = counts.get(op, 0) + 1
        return dict(sorted(counts.items(), key=lambda kv: -kv[1]))
    raise ValueError(f"{name} is not in the disassembly")


def sm_clocks_per_nonce(census: dict[str, int]) -> float:
    """The fewest SM clocks a nonce can cost, given the loop's census: the
    busiest of the ALU pipe, the FMA pipe and instruction issue."""
    alu = sum(n for op, n in census.items() if op in ALU_OPCODES)
    fma = sum(n for op, n in census.items() if op in FMA_OPCODES)
    return max(alu / PIPE_PER_SM_CLOCK, fma / PIPE_PER_SM_CLOCK,
               sum(census.values()) / ISSUE_PER_SM_CLOCK)
