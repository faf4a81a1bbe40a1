"""The hand-written CUDA double-SHA-256 sweep: build, binding and wrapper.

``csrc/sha256d_sweep.cu`` is compiled by ``nvcc`` for ``sm_90a`` into the
package's git-ignored ``build/`` directory at first use and bound with
ctypes through its plain C interface. ``sweep`` is the entry point: on a
CUDA device it launches the kernel or raises; only for the CPU device does
it run the plain PyTorch version (``sha256_torch.sweep_core_ext``).
``launch`` also takes the extended midstate as a CUDA tensor, for the
instantiation that reads it from the library's ``__constant__`` symbol, as
the fused miner's loop does (``ext_symbol_user``). Inside
``timed_launches`` a sweep runs the stamped build, which writes its own
span on the card (``%globaltimer``) into its result buffer, read back with
its winner (``LaunchedSweep.timing``).
``bound_sm_clocks_per_nonce`` gives the kernel's bound from the
function's work: the ALU-only instructions of the compiled loop
(``loop_census``) and the adds of the source (``source_adds``);
``function_census`` and ``ptxas_report`` give a kernel's compiled size and
its registers, stack and spills. A build that fails (no ``nvcc``, a
compiler error), a launch that fails and a CUDA error reported at the
result's read-back raise ``KernelError``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ..config import ConfigError, KernelError
from ..core.build import BUILD_DIR, build_log, build_shared
from ..dispatchwatch import record_compile
from . import sha256_sched, sha256_torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "sha256d_sweep.cu"
#: ``-Xptxas -v`` makes ptxas report each kernel's registers, stack and
#: spills; ``build_shared`` keeps that beside the library (``ptxas_report``).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: Nonces in one slice of the kernel's work queue (``kSlice``): a warp takes
#: that many consecutive nonces, one a lane, per atomic on the cursor.
SLICE_NONCES = 32
#: One trip of the kernel's main loop hashes this many nonces per thread.
NONCES_PER_TRIP = 1
#: int32 words of a result buffer: {count, min, cursor_lo, cursor_hi}.
RESULT_WORDS = 4
#: int32 words of a stamped result buffer: the result, then the stamped
#: build's {start, end} on ``%globaltimer``, two little-endian uint64 (ns).
STAMPED_RESULT_WORDS = RESULT_WORDS + 4

#: The compile census's site of the library's builds and loads.
COMPILE_SITE = "ops.sha256_cuda"

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
    """Compiles the kernel library if it is missing or out of date; a
    compile that ran is one ``nvcc`` stage in the compile census
    (``dispatchwatch``)."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelError(
            "nvcc not found (looked in $CUDA_HOME/bin, PyTorch's CUDA_HOME "
            "and PATH): the CUDA sweep kernel cannot be built")
    return build_shared([nvcc, *NVCC_FLAGS], [SOURCE], [],
                        BUILD_DIR / "libsha256d_sweep.so",
                        on_build=lambda s: record_compile(
                            site=COMPILE_SITE, stage="nvcc", duration_s=s))


def bind(library: pathlib.Path) -> ctypes.CDLL:
    """Loads a library built from ``SOURCE`` and declares its C interface."""
    lib = ctypes.CDLL(str(library))
    lib.sha256d_sweep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.sha256d_sweep_launch.restype = ctypes.c_int
    lib.sha256d_sweep_launch_stamped.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.sha256d_sweep_launch_stamped.restype = ctypes.c_int
    lib.sha256d_globaltimer_tick.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.sha256d_globaltimer_tick.restype = ctypes.c_int
    lib.sha256d_sweep_launch_ext_symbol.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.sha256d_sweep_launch_ext_symbol.restype = ctypes.c_int
    lib.sha256d_block_step_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    lib.sha256d_block_step_launch.restype = ctypes.c_int
    lib.sha256d_fused_enqueue.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.sha256d_fused_enqueue.restype = ctypes.c_int
    lib.sha256d_block_step_repeat.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.sha256d_block_step_repeat.restype = ctypes.c_int
    lib.sha256d_sweep_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.sha256d_sweep_occupancy.restype = ctypes.c_int
    lib.sha256d_sweep_resident_blocks.argtypes = [ctypes.c_int]
    lib.sha256d_sweep_resident_blocks.restype = ctypes.c_longlong
    lib.sha256d_sweep_block_threads.argtypes = []
    lib.sha256d_sweep_block_threads.restype = ctypes.c_int
    lib.sha256d_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sha256d_sweep_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    path = build()
    t0 = time.perf_counter()
    lib = bind(path)
    record_compile(site=COMPILE_SITE, stage="load",
                   duration_s=time.perf_counter() - t0)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built and bound at the first call; raises
    KernelError when it cannot be built."""
    return _lib()


def library_loaded() -> bool:
    """Whether this process has bound the kernel library (it is bound
    once a process, at the first ``library()``)."""
    return _lib.cache_info().currsize > 0


def cuda_error(what: str, err: int) -> KernelError:
    return KernelError(f"{what} failed: CUDA error {err} "
                        f"({_lib().sha256d_sweep_error_string(err).decode()})")


def _is_cuda_error(e: BaseException) -> bool:
    """A CUDA error as PyTorch reports it: ``torch.AcceleratorError`` where
    the build has it, else a RuntimeError whose text names one."""
    accelerator = getattr(torch, "AcceleratorError", None)
    return (accelerator is not None and isinstance(e, accelerator)) or \
        "CUDA error" in str(e)


@contextlib.contextmanager
def kernel_errors(what: str):
    """Raises ``KernelError`` for a CUDA error that PyTorch reports inside
    the block. A kernel that faults while it runs (an illegal address, a
    trap) is reported at the next call that synchronises with the device,
    the result's read-back, and leaves the context broken, so the next
    call on the device (a fresh buffer's copy) fails the same way: both
    are the kernel's failure, not a transient one."""
    try:
        yield
    except RuntimeError as e:
        if isinstance(e, KernelError) or not _is_cuda_error(e):
            raise
        raise KernelError(f"{what} failed: {e}") from e


def new_result(device: torch.device, stamped: bool = False
               ) -> torch.Tensor:
    """A fresh result buffer: four int32 words, which the kernel reads as
    uint32.

    * word 0: the number of qualifying nonces (0);
    * word 1: the lowest qualifying nonce (0xFFFFFFFF, stored as -1);
    * words 2-3: the work queue's cursor, the next slice to hand out, a
      little-endian uint64 (0), so the buffer must be 8-byte aligned.

    ``stamped`` adds the stamped build's four words: its start stamp (all
    ones, the identity of the blocks' minimum) and its end stamp (0, of
    their maximum), each a little-endian uint64.

    A buffer is reset to these values before every launch (``copy_`` from
    a fresh one), the cursor and the stamps included."""
    words = [0, -1, 0, 0] + ([-1, -1, 0, 0] if stamped else [])
    return torch.tensor(words, dtype=torch.int32, device=device)


def check_result_buffer(out: torch.Tensor) -> None:
    """Raises ValueError unless ``out`` is laid out as ``new_result``
    (plain or stamped)."""
    if out.dtype != torch.int32 or out.shape not in (
            (RESULT_WORDS,), (STAMPED_RESULT_WORDS,)) \
            or not out.is_contiguous() or out.data_ptr() % 8:
        raise ValueError(f"out must be a contiguous, 8-byte aligned "
                         f"({RESULT_WORDS},) or ({STAMPED_RESULT_WORDS},) "
                         f"int32 tensor (new_result), got "
                         f"{tuple(out.shape)} {out.dtype}")


_ext_symbol_lock = threading.Lock()
_ext_symbol_last: dict[torch.device, torch.cuda.Event] = {}


@contextlib.contextmanager
def ext_symbol_user(device: torch.device, stream: torch.cuda.Stream):
    """Scope for enqueueing work that writes or reads the library's
    ``__constant__`` ext symbol on ``device``, of which there is one per
    device. The lock lets one caller at a time enqueue such work, and its
    stream waits (on the device, without a host sync) for the previous
    user's work, on whatever stream that ran: so one fused run at a time
    uses the symbol, and runs on two streams take turns. The per-block path
    (ext by value) does not touch it."""
    with _ext_symbol_lock:
        last = _ext_symbol_last.get(device)
        if last is not None:
            stream.wait_event(last)
        yield
        done = torch.cuda.Event()
        done.record(stream)
        _ext_symbol_last[device] = done


def check_device_words(t: torch.Tensor, shape: tuple, device: torch.device,
                        name: str) -> None:
    """Raises ValueError unless ``t`` is a contiguous uint32 or int32 tensor
    of ``shape`` on ``device`` (the kernels read its words as uint32)."""
    if t.device != device or t.dtype not in (torch.uint32, torch.int32) \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} uint32 "
                         f"tensor on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def launch(ext, base: int, count: int,
           difficulty_bits: int, out: torch.Tensor, *,
           early_exit: bool = False,
           hashed: torch.Tensor | None = None) -> None:
    """Enqueues one sweep of [base, base + count) on the current stream of
    ``out``'s device, accumulating into ``out`` (see ``new_result``; the
    caller resets it). Does not synchronise.

    ``ext`` is the (20,) uint32 extended midstate. In host memory (numpy)
    it travels by value in the kernel's arguments. A (20,) uint32 or int32
    tensor on ``out``'s device is copied, on the stream, into the library's
    ``__constant__`` symbol, and the instantiation that reads it there
    runs (``ext_symbol_user``).

    ``hashed``, a (1,) int64 tensor on the same device, selects the
    measuring build of the kernel, which adds to it the number of nonces it
    hashed (with ``early_exit``, how far the sweep ran past the winner);
    only with ``ext`` in host memory. A stamped ``out``
    (``new_result(device, stamped=True)``) selects the stamped build, which
    writes the sweep's span on the card after its result; only with
    ``ext`` in host memory and without ``hashed``."""
    global launches
    if out.device.type != "cuda":
        raise ValueError("out must be a CUDA tensor")
    check_result_buffer(out)
    if hashed is not None and (hashed.device != out.device
                               or hashed.dtype != torch.int64
                               or hashed.shape != (1,)):
        raise ValueError("hashed must be a (1,) int64 tensor on out's "
                         "device")
    on_device = isinstance(ext, torch.Tensor)
    stamped = out.shape[0] == STAMPED_RESULT_WORDS
    if stamped and (on_device or hashed is not None):
        raise ValueError("the stamped build takes ext in host memory, and "
                         "is not the measuring build")
    if on_device:
        check_device_words(ext, (sha256_sched.EXT_WORDS,), out.device,
                            "ext")
        if hashed is not None:
            raise ValueError("the measuring build takes ext in host memory")
    else:
        ext = np.ascontiguousarray(ext, dtype=np.uint32)
        if ext.shape != (sha256_sched.EXT_WORDS,):
            raise ValueError(f"ext must have shape (20,), got {ext.shape}")
    sha256_torch.check_range(base, count)
    if count == 0:
        return
    if difficulty_bits > 64:
        raise ConfigError(f"difficulty_bits {difficulty_bits} > 64 "
                          f"unsupported")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device)
        if on_device:
            with ext_symbol_user(out.device, stream):
                err = _lib().sha256d_sweep_launch_ext_symbol(
                    ext.data_ptr(), base, count, int(difficulty_bits),
                    int(early_exit), out.data_ptr(), stream.cuda_stream)
        else:
            args = (ext.ctypes.data, base, count, int(difficulty_bits),
                    int(early_exit), out.data_ptr())
            if stamped:
                err = _lib().sha256d_sweep_launch_stamped(
                    *args, stream.cuda_stream)
            else:
                err = _lib().sha256d_sweep_launch(
                    *args, None if hashed is None else hashed.data_ptr(),
                    stream.cuda_stream)
    if err != 0:
        raise cuda_error("sha256d_sweep launch", err)
    launches += 1


def resident_blocks(difficulty_bits: int, device: torch.device) -> int:
    """Thread blocks of the kernel's persistent grid on ``device`` for
    ``difficulty_bits`` (SMs times the blocks each SM holds at once)."""
    with torch.cuda.device(device):
        blocks = _lib().sha256d_sweep_resident_blocks(int(difficulty_bits))
    if blocks <= 0:
        raise cuda_error("the occupancy query", -blocks)
    return blocks


def occupancy(difficulty_bits: int, device: torch.device,
              ext_from_symbol: bool = False) -> tuple[int, int]:
    """(registers a thread, blocks an SM holds at once) of the production
    sweep serving ``difficulty_bits`` on ``device``, with ext by value or
    from the ``__constant__`` symbol. Also caches that instantiation's
    resident grid, so its first launch makes no occupancy query."""
    regs, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().sha256d_sweep_occupancy(
            int(difficulty_bits), int(ext_from_symbol), ctypes.byref(regs),
            ctypes.byref(per_sm))
    if err != 0:
        raise cuda_error("the occupancy query", err)
    return regs.value, per_sm.value


def resident_warps(difficulty_bits: int, device: torch.device) -> int:
    """Warps of the kernel's persistent grid on ``device``: the most slices
    the work queue can have in flight at once."""
    threads = _lib().sha256d_sweep_block_threads()
    return resident_blocks(difficulty_bits, device) * threads // 32


def read_result(out: torch.Tensor, words: int = 2) -> tuple[int, ...]:
    """(count, min_nonce) from a result buffer; synchronises on it and
    reads back its first ``words`` words in one copy (the wait releases
    the interpreter lock): 2, 8 bytes. ``STAMPED_RESULT_WORDS`` of a
    stamped buffer, 32 bytes, give (count, min_nonce, start_ns, end_ns).
    A CUDA error reported there raises ``KernelError``."""
    with kernel_errors("sha256d_sweep read-back"):
        got = out[:words].tolist()
    w = [int(v) & 0xFFFFFFFF for v in got]
    if words == STAMPED_RESULT_WORDS:
        return w[0], w[1], w[4] | w[5] << 32, w[6] | w[7] << 32
    return w[0], w[1]


class _FreshBuffers(threading.local):
    """Per thread, by device and form: a fresh result buffer
    (``new_result``, plain or stamped) that each launch's own buffer is
    cloned from, so that starting a sweep is a copy on the stream and not
    an upload from the host."""

    def __init__(self):
        self.by_key: dict[tuple, torch.Tensor] = {}

    def get(self, device: torch.device, stamped: bool) -> torch.Tensor:
        fresh = self.by_key.get((device, stamped))
        if fresh is None:
            fresh = self.by_key[device, stamped] = new_result(device,
                                                              stamped)
        return fresh


_fresh_buffers = _FreshBuffers()


def fresh_result(device: torch.device, stamped: bool = False
                 ) -> torch.Tensor:
    """A reset result buffer, plain or stamped, on a CUDA ``device``: a
    copy, on the current stream, of this thread's fresh one (no upload
    from the host)."""
    return _fresh_buffers.get(device, stamped).clone()


class _Timing(threading.local):
    """Per thread: whether ``sweep_launch`` launches the stamped build
    (``timed_launches``)."""
    on = False


_timing = _Timing()


class timed_launches:
    """``with timed_launches():`` on this thread, ``sweep_launch``
    launches the stamped build, so ``LaunchedSweep.timing`` gives the
    sweep's time on the card from the stamps its read-back brings; outside
    it a sweep writes and reads back its result alone. Either carries one
    plain completion event. Only a caller that reads the timing asks for
    it (the pipelined ``Miner`` with its telemetry on). ``on=False`` turns
    it off inside."""

    __slots__ = ("on", "prev")

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self) -> None:
        self.prev, _timing.on = _timing.on, self.on

    def __exit__(self, *exc) -> None:
        _timing.on = self.prev


def timing_requested() -> bool:
    """True inside ``timed_launches`` on this thread."""
    return _timing.on


_read_streams: dict[torch.device, torch.cuda.Stream] = {}


def _read_stream(device: torch.device) -> torch.cuda.Stream:
    """A stream of its own on ``device`` for reading back a sweep that is
    done: a copy there does not queue behind sweeps launched after it."""
    stream = _read_streams.get(device)
    if stream is None:
        stream = _read_streams.setdefault(device, torch.cuda.Stream(device))
    return stream


class LaunchedSweep:
    """A sweep on the card: its result buffer, the event recorded on its
    stream right after it and, when it was launched inside
    ``timed_launches`` (``timed``), the host's ``time.perf_counter()`` when
    it was launched, its buffer stamped. ``ready`` says, without blocking,
    whether the sweep is done; ``result`` waits for it and gives (count,
    min_nonce), reading back the stamps of a timed sweep in the same copy;
    ``timing`` gives (launched, its seconds on the card) of a timed sweep
    that is done. A CUDA error reported at any of them raises
    ``KernelError``."""

    __slots__ = ("out", "event", "launched", "device", "timed", "words")

    def __init__(self, out: torch.Tensor, event: torch.cuda.Event,
                 launched: float = 0.0):
        self.out, self.event, self.launched = out, event, launched
        self.device = out.device
        self.timed = out.shape[0] == STAMPED_RESULT_WORDS
        self.words: tuple[int, ...] | None = None

    def ready(self) -> bool:
        with kernel_errors("sha256d_sweep completion query"):
            return self.event.query()

    def _read(self) -> tuple[int, ...]:
        if self.words is None:
            self.words = read_result(
                self.out, STAMPED_RESULT_WORDS if self.timed else 2)
        return self.words

    def result(self) -> tuple[int, int]:
        return self._read()[:2]

    def timing(self) -> tuple[float, float]:
        """Only once ``ready`` said True or ``result`` returned. After
        ``result`` the stamps are on the host already; before it (a
        discarded sweep) they are read back here, on a stream of their
        own, so the copy waits for nothing launched after the sweep."""
        if not self.timed:
            raise ValueError("the sweep was launched without its stamps "
                             "(see timed_launches)")
        if self.words is None and self.out.is_cuda:
            with torch.cuda.stream(_read_stream(self.device)):
                self._read()
        _, _, start, end = self._read()
        if start > end:
            raise KernelError(f"sha256d_sweep stamps not written: start "
                              f"{start:#x}, end {end:#x}")
        return self.launched, (end - start) / 1e9


def sweep_launch(ext, base: int, count: int, difficulty_bits: int, *,
                 device: torch.device | str, early_exit: bool = False
                 ) -> LaunchedSweep:
    """Enqueues one sweep of [base, base + count) on a CUDA ``device`` into
    a result buffer of its own and returns it as a ``LaunchedSweep``,
    without waiting: a sweep on the device while the host goes on;
    ``sweep`` is both at once. Inside ``timed_launches`` a sweep of at
    least one nonce runs the stamped build, so its time on the card comes
    back with its result (the pipelined ``Miner``'s device window)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ConfigError(f"sweep_launch runs on a CUDA device, not "
                          f"{device}")
    if not torch.cuda.is_available():
        raise ConfigError(f"no CUDA device is available for {device}")
    ext_host = np.asarray(sha256_torch.ext_words(ext), dtype=np.uint32)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stamped = _timing.on and count > 0
    with kernel_errors("sha256d_sweep launch"):
        out = fresh_result(device, stamped)
        launched = time.perf_counter() if stamped else 0.0
        launch(ext_host, base, count, difficulty_bits, out,
               early_exit=early_exit)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return LaunchedSweep(out, event, launched)


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
    return sweep_launch(ext, base, count, difficulty_bits, device=device,
                        early_exit=early_exit).result()


#: What one Hopper SM retires per clock, in thread-instructions: four
#: schedulers each issue one 32-thread instruction, and the integer ALU
#: pipe and the FMA pipe each take 64 (CUDA C++ Programming Guide,
#: arithmetic instruction throughput, compute capability 9.0). The pipe of
#: each opcode follows the Nsight Compute profiling guide: the ALU runs bit
#: manipulation, logic and the integer instructions other than IMAD/IMUL,
#: which run on the FMA pipe. An opcode in neither set (VIADD, uniform and
#: memory instructions) counts toward issue only. Of the ALU opcodes, the
#: adds (IADD3, LEA) could run as IMAD on the FMA pipe instead; the others
#: run on the ALU pipe or nowhere (``ALU_ONLY_OPCODES``).
ISSUE_PER_SM_CLOCK = 128
PIPE_PER_SM_CLOCK = 64
ALU_OPCODES = frozenset({"SHF", "LOP3", "IADD3", "PRMT", "ISETP", "SEL",
                         "LEA", "IMNMX", "BMSK", "SGXT"})
ALU_ONLY_OPCODES = ALU_OPCODES - {"IADD3", "LEA"}
FMA_OPCODES = frozenset({"IMAD", "IMUL", "FFMA", "FADD", "FMUL"})

_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)([^;]*);")


def difficulty_class(difficulty_bits: int) -> int:
    """The kernel template (``Mode`` in the source) serving a difficulty."""
    d = int(difficulty_bits)
    return 0 if d <= 0 else 1 if d < 32 else 2 if d == 32 else \
        3 if d < 64 else 4


def kernel_symbol(difficulty_bits: int, count_hashed: bool = False,
                  stamped: bool = False) -> str:
    """The mangled-name stem of ``sha256d_sweep_kernel<kMode, kCountHashed,
    false, kStamp>`` (ext by value) serving ``difficulty_bits``, built from
    the template's parameters."""
    return (f"sha256d_sweep_kernelILi{difficulty_class(difficulty_bits)}"
            f"ELb{int(count_hashed)}ELb0ELb{int(stamped)}E")


def disassemble(library: pathlib.Path | None = None) -> str:
    """``cuobjdump -sass`` of a kernel library, the built one by default."""
    nvcc = find_nvcc()
    tool = pathlib.Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.is_file():
        raise RuntimeError("cuobjdump not found beside nvcc")
    return subprocess.run([str(tool), "-sass", str(library or build())],
                          capture_output=True, text=True, check=True).stdout


#: The mangled-name stem of the fused miner's step kernel, the production
#: instantiation (``block_step_kernel<false>``; ``<true>`` writes clock
#: stamps).
STEP_KERNEL_SYMBOL = "block_step_kernelILb0E"

_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str, name: str) -> dict[str, int]:
    """Registers, stack frame and spill bytes of the first kernel whose
    mangled name contains ``name``, from ``nvcc -Xptxas -v`` output."""
    parts = _PTXAS_ENTRY.split(log)
    for entry, body in zip(parts[1::2], parts[2::2]):
        if name not in entry:
            continue
        frame, regs = _PTXAS_FRAME.search(body), _PTXAS_REGS.search(body)
        if frame is None or regs is None:
            break
        stack, stores, loads = (int(v) for v in frame.groups())
        return {"registers": int(regs.group(1)), "stack_bytes": stack,
                "spill_store_bytes": stores, "spill_load_bytes": loads}
    raise ValueError(f"ptxas reported nothing for {name}")


def build_report(library: pathlib.Path | None = None) -> str:
    """The compiler's output of a kernel library's build, the built one by
    default (``-Xptxas -v`` in ``NVCC_FLAGS``)."""
    return build_log(library or build()).read_text()


def _instructions(sass: str, name: str) -> list[tuple[int, str, str]]:
    """(address, opcode, operands) of the first function of ``cuobjdump
    -sass`` text whose mangled name contains ``name``."""
    for part in sass.split("Function : ")[1:]:
        if name in part.splitlines()[0]:
            return [(int(addr, 16), op, operands)
                    for addr, op, operands in _SASS_LINE.findall(part)]
    raise ValueError(f"{name} is not in the disassembly")


def _by_opcode(ops) -> dict[str, int]:
    counts: dict[str, int] = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def function_census(sass: str, name: str) -> dict[str, int]:
    """Instructions by opcode in the whole of the function named ``name``
    (a stem of its mangled name), from ``cuobjdump -sass`` text."""
    return _by_opcode(op for _, op, _ in _instructions(sass, name))


def loop_census(sass: str, difficulty_bits: int,
                stamped: bool = False) -> dict[str, int]:
    """Instructions by opcode in the main loop of the production kernel
    (or its stamped build) serving ``difficulty_bits``, from ``cuobjdump
    -sass`` text. The loop is the span of the longest backward branch; one
    trip of it hashes ``NONCES_PER_TRIP`` nonces per thread, and takes one
    slice from the work queue."""
    name = kernel_symbol(difficulty_bits, stamped=stamped)
    insts = _instructions(sass, name)
    back = []
    for addr, op, operands in insts:
        target = re.findall(r"0x([0-9a-f]+)", operands)
        if op == "BRA" and target and int(target[-1], 16) < addr:
            back.append((int(target[-1], 16), addr))
    if not back:
        raise ValueError(f"no loop found in {name}")
    lo, hi = max(back, key=lambda span: span[1] - span[0])
    return _by_opcode(op for addr, op, _ in insts if lo <= addr <= hi)


def pipe_counts(census: dict[str, int]) -> tuple[int, int, int]:
    """(ALU-pipe, FMA-pipe, all) instructions of a census."""
    alu = sum(n for op, n in census.items() if op in ALU_OPCODES)
    fma = sum(n for op, n in census.items() if op in FMA_OPCODES)
    return alu, fma, sum(census.values())


def alu_only_count(census: dict[str, int]) -> int:
    """Instructions of a census that only the ALU pipe can run."""
    return sum(n for op, n in census.items() if op in ALU_ONLY_OPCODES)


def sm_clocks_per_nonce(census: dict[str, int],
                        nonces_per_trip: int = NONCES_PER_TRIP) -> float:
    """SM clocks a nonce takes if the compiled loop ran with its busiest
    pipe full: the busiest of the ALU pipe, the FMA pipe and instruction
    issue, per nonce, for a loop whose trip hashes ``nonces_per_trip``
    nonces per thread. It follows the compiler's split of the adds between
    the pipes, so it is a diagnostic of the build, not the kernel's bound
    (``bound_sm_clocks_per_nonce``)."""
    if nonces_per_trip < 1:
        raise ValueError(f"nonces_per_trip must be >= 1, got "
                         f"{nonces_per_trip}")
    alu, fma, total = pipe_counts(census)
    return max(alu / PIPE_PER_SM_CLOCK, fma / PIPE_PER_SM_CLOCK,
               total / ISSUE_PER_SM_CLOCK) / nonces_per_trip


def bound_sm_clocks_per_nonce(census: dict[str, int], adds: int,
                              nonces_per_trip: int = NONCES_PER_TRIP
                              ) -> float:
    """The fewest SM clocks a nonce can take, from the function's work:
    the loop's ALU-only instructions (``alu_only_count``) and ``adds``, the
    source's two-input adds a nonce needs (``source_adds``), however the
    compiler splits them between the pipes.

    The ALU-only instructions fill the ALU pipe for L / 64 clocks. An add
    runs either as IMAD on the FMA pipe, one add an instruction, or as
    IADD3 on the ALU pipe, up to two adds an instruction; the best split of
    A adds gives max(L / 64, (2L + A) / 192) clocks. Issue never binds
    tighter: the two pipes together take the 128 instructions a clock that
    the schedulers issue."""
    if nonces_per_trip < 1:
        raise ValueError(f"nonces_per_trip must be >= 1, got "
                         f"{nonces_per_trip}")
    only = alu_only_count(census) / nonces_per_trip
    return max(only / PIPE_PER_SM_CLOCK,
               (2 * only + adds) / (3 * PIPE_PER_SM_CLOCK))


_M32 = 0xFFFFFFFF
# The loop-invariant value of the replay in ``source_adds``: what depends
# on the kernel's arguments only is hoisted out of the loop.
_INVARIANT = "invariant"


class _PerNonce:
    """A value of the replay that depends on the nonce: the adds forming it
    takes and the per-nonce values it reads."""

    __slots__ = ("adds", "reads")

    def __init__(self, adds: int, reads: list):
        self.adds, self.reads = adds, reads


def _op(fn, *xs):
    """A replay value made by an operation other than an add: folded when
    every input is a constant, free when none depends on the nonce."""
    if all(isinstance(x, int) for x in xs):
        return fn(*xs) & _M32
    nonce = [x for x in xs if isinstance(x, _PerNonce)]
    return _PerNonce(0, nonce) if nonce else _INVARIANT


def _sum(*xs):
    """A replay sum. Additions are associative mod 2^32, so the constant
    and the loop-invariant terms fold into one term (none if it is 0) and
    the sum takes one two-input add per term past the first."""
    const = sum(x for x in xs if isinstance(x, int)) & _M32
    invariant = any(x is _INVARIANT for x in xs)
    nonce = [x for x in xs if isinstance(x, _PerNonce)]
    if not nonce:
        return _INVARIANT if invariant else const
    return _PerNonce(len(nonce) - 1 + int(invariant or const != 0), nonce)


def _rot(x: int, n: int) -> int:
    return (x >> n) | (x << (32 - n))


def _big_sigma0(a):
    return _rot(a, 2) ^ _rot(a, 13) ^ _rot(a, 22)


def _big_sigma1(e):
    return _rot(e, 6) ^ _rot(e, 11) ^ _rot(e, 25)


def _small_sigma0(x):
    return _rot(x, 7) ^ _rot(x, 18) ^ (x >> 3)


def _small_sigma1(x):
    return _rot(x, 17) ^ _rot(x, 19) ^ (x >> 10)


def _ch(e, f, g):
    return g ^ (e & (f ^ g))


def _maj(a, b, c):
    return b ^ ((a ^ b) & (b ^ c))


def _replay_expand(w: list, first: int) -> None:
    for r in range(first, 64):
        w[r] = _sum(_op(_small_sigma1, w[r - 2]), w[r - 16], w[r - 7],
                    _op(_small_sigma0, w[r - 15]))


def _replay_rounds(s: list, w: list, first: int) -> list:
    a, b, c, d, e, f, g, h = s
    for r in range(first, 64):
        t1 = _sum(h, int(sha256_sched.K[r]), w[r], _op(_big_sigma1, e),
                  _op(_ch, e, f, g))
        t2 = _sum(_op(_big_sigma0, a), _op(_maj, a, b, c))
        h, g, f, e = g, f, e, _sum(d, t1)
        d, c, b, a = c, b, a, _sum(t1, t2)
    return [a, b, c, d, e, f, g, h]


def _replay_h01(ext: list, w3) -> tuple:
    """The kernel's ``sha256d_h01`` on replay values: ``ext`` the 20
    extended-midstate words, ``w3`` the byte-swapped nonce. On integers it
    computes the digest words h0, h1."""
    S = sha256_sched
    w = [0] * 64
    w[4], w[15] = 0x80000000, 80 * 8          # words 5..14 are 0
    w[16], w[17] = ext[S.EXT_W16], ext[S.EXT_W17]
    w[18] = _sum(ext[S.EXT_RC18], _op(_small_sigma0, w3))
    w[19] = _sum(w3, ext[S.EXT_RC19])
    _replay_expand(w, 20)
    s = _replay_rounds(
        [_sum(ext[S.EXT_RC_A], w3), ext[S.EXT_A2], ext[S.EXT_A1],
         ext[S.EXT_A0], _sum(ext[S.EXT_RC_E], w3), ext[S.EXT_E2],
         ext[S.EXT_E1], ext[S.EXT_E0]], w, 4)
    w2 = [0] * 64
    w2[:8] = [_sum(x, ext[S.EXT_MS + i]) for i, x in enumerate(s)]
    w2[8], w2[15] = 0x80000000, 32 * 8        # words 9..14 are 0
    _replay_expand(w2, 16)
    s2 = _replay_rounds([int(v) for v in S.IV], w2, 0)
    return _sum(s2[0], int(S.IV[0])), _sum(s2[1], int(S.IV[1]))


def source_adds(difficulty_bits: int) -> int:
    """Two-input 32-bit adds a nonce needs in the kernel's source
    (``sha256d_h01`` and the class's test), replayed on symbols: constants
    fold, terms that depend on the arguments only are hoisted out of the
    loop, and an add whose result the test never reads is dropped. The
    count is the function's, whatever pipe the compiler gives each add."""
    h0, h1 = _replay_h01([_INVARIANT] * sha256_sched.EXT_WORDS,
                         _PerNonce(0, []))
    mode = difficulty_class(difficulty_bits)
    read = [] if mode == 0 else [h0] if mode <= 2 else [h0, h1]
    seen, adds = set(), 0
    stack = [v for v in read if isinstance(v, _PerNonce)]
    while stack:
        v = stack.pop()
        if id(v) in seen:
            continue
        seen.add(id(v))
        adds += v.adds
        stack.extend(v.reads)
    return adds
