"""CUDA miner_backend: one kernel launch per search on one card.

Twin of the reference's ``TpuBackend`` with its device round loop
(``make_multiround_search_fn`` + ``make_round_search``). The reference runs
a ``lax.while_loop`` of fixed-size rounds on the device, stops at the
first round that holds a qualifier, and hands any tail that would cross
2^32 to the C++ ``cpu_search``. Here one early-exit launch sweeps the
whole requested range [start, min(start + max_count, 2^32)): the kernel
bounds the range exactly, so no round loop runs on the host and no tail
goes to the CPU. The only host sync is the 8-byte result read-back.

``hashes_tried`` is not what the kernel did but what the reference counts
for the same search and round size (``reference_hashes_tried``), so a
``SearchResult`` equals ``TpuBackend``'s field for field.

The ``backend.cuda.dispatch`` fault site sits before the launch:
``raise`` / ``hang`` fire before any device work, ``corrupt`` / ``partial``
damage the finished result (``backend._faulted_result``). With the CUDA
kernel the library is built and bound when the backend is constructed, so
a kernel that does not build raises ``KernelError`` there, while the
resilience ladder builds its top rung.
"""
from __future__ import annotations

import functools

import torch

from .. import core
from ..config import ConfigError
from ..ops import extend_midstate, select_kernel
from ..resilience import injection
from . import MinerBackend, SearchResult, _faulted_result, register

NONCE_SPACE = 1 << 32


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device a run uses. A CUDA device must exist: with no card
    the caller has to ask for the CPU explicitly. ``"cuda"`` resolves to
    the calling thread's current device by index, so a search that runs on
    another thread (whose current device is its own) still uses this
    one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def reference_hashes_tried(start: int, end: int, round_size: int,
                           winner: int | None) -> int:
    """Nonces the reference ``TpuBackend`` counts for a search of
    [start, end) at ``round_size`` whose lowest qualifier is ``winner``.

    The reference sweeps whole rounds on the device from ``start``, but
    only rounds that end at or below 2^32; every executed round counts in
    full except that the last one is clipped at ``end``. The part of the
    range past the last such round goes to ``cpu_search``, which counts up
    to and including its winner, or the whole tail when there is none.
    """
    if start >= end:
        return 0
    n_rounds = 0
    if start + round_size <= NONCE_SPACE:
        n_rounds = min(-(-(end - start) // round_size),
                       (NONCE_SPACE - start) // round_size, 0xFFFFFFFF)
    device_end = start + n_rounds * round_size
    if winner is not None and winner < device_end:
        r = (winner - start) // round_size
        return r * round_size + min(round_size, end - (start + r * round_size))
    tried = min(device_end, end) - start
    if device_end < end:
        tried += (winner - device_end + 1 if winner is not None
                  else end - device_end)
    return tried


@register("cuda")
class CudaBackend(MinerBackend):
    def __init__(self, batch_pow2: int = 20, kernel: str = "auto",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.batch_size = 1 << batch_pow2
        self.kernel = kernel
        self.effective_kernel: str | None = None
        self._searchers: dict[int, object] = {}   # difficulty -> sweep fn
        # Resolve the kernel now, so a bad kernel/device pair fails here
        # and not at the first block, and build the kernel library, so a
        # kernel that does not build fails here too (KernelError).
        self._searcher(0)
        if self.effective_kernel == "cuda":
            from ..ops import sha256_cuda
            sha256_cuda.library()

    @property
    def hand_written_kernel(self) -> bool:     # type: ignore[override]
        return self.effective_kernel == "cuda"

    def _searcher(self, difficulty_bits: int):
        fn = self._searchers.get(difficulty_bits)
        if fn is None:
            fn, self.effective_kernel = select_kernel(
                self.kernel, self.device, difficulty_bits)
            self._searchers[difficulty_bits] = fn
        return fn

    def launch(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = NONCE_SPACE):
        """Starts the search and returns the function that finishes it.
        With the CUDA kernel the sweep is on the device when this returns
        and the finish waits for its 8-byte result; with the plain version
        the finish does all the work."""
        # Fault-injection hook: raise/hang fire before any device work,
        # corrupt/partial damage the finished result.
        fault = injection.check("backend.cuda.dispatch",
                                difficulty=difficulty_bits)
        end = min(start_nonce + max_count, NONCE_SPACE)
        if start_nonce >= end:
            read = None
        else:
            # Per-template precompute on the host, once per search.
            ext = extend_midstate(*core.header_midstate(header80))
            if self.effective_kernel == "cuda":
                from ..ops import sha256_cuda
                out = sha256_cuda.sweep_launch(
                    ext, start_nonce, end - start_nonce, difficulty_bits,
                    device=self.device, early_exit=True)
                read = functools.partial(sha256_cuda.read_result, out)
            else:
                read = functools.partial(
                    self._searcher(difficulty_bits), ext, start_nonce,
                    end - start_nonce, early_exit=True)

        def finish() -> SearchResult:
            res = (SearchResult(None, None, 0) if read is None
                   else self._result(header80, start_nonce, end, *read()))
            return res if fault is None else \
                _faulted_result(fault, res, start_nonce)
        return finish

    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = NONCE_SPACE
               ) -> SearchResult:
        return self.launch(header80, difficulty_bits, start_nonce,
                           max_count)()

    def _result(self, header80: bytes, start: int, end: int, count: int,
                best: int) -> SearchResult:
        winner = best if count > 0 else None
        tried = reference_hashes_tried(start, end, self.batch_size, winner)
        if winner is None:
            return SearchResult(None, None, tried)
        return SearchResult(winner,
                            core.header_hash(core.set_nonce(header80, winner)),
                            tried)
