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

More than one miner (the reference's ``('miners',)`` mesh), in two forms:

* **N logical miners in one process** (``n_miners=N``, no ``group``): a
  round covers N x B nonces, miner i sweeping its B-slice of it. The
  lowest qualifier of the first round that holds one is the lowest
  qualifier of the whole range, which is what the one early-exit launch
  already returns; so the search stays one launch, and only the
  accounting counts rounds of N x B (``reference_hashes_tried``), as the
  reference's mesh does.
* **One miner per process** (``group``, a ``torch.distributed`` process
  group of N ranks): rank i sweeps its B-slice of each round,
  [base + i*B, + B), with the early-exit kernel, then ``winner_select``
  sums the counts and takes the least nonce over gloo, and the search
  stops at the first round whose summed count is above 0, round by round
  as the reference's ``make_round_search``. Past the last whole round
  below 2^32 every rank sweeps the tail alone, as every reference process
  runs the C++ tail. The launch starts the first round's slice; the
  collectives run only in the finish, on the thread that consumes the
  search, so no rank enters a collective that another skipped. Each
  round is a ``skew_span(site="mesh.sweep")`` (``meshprof``), as the
  reference's sharded round is.

Spans: ``backend.cuda.dispatch`` covers putting the search on the card, the
counterpart of ``backend.tpu.dispatch`` (which there also covers the wait
for the device's value; here the wait is the consumer's, ``miner.sweep``),
split in two spans of the port's own: ``backend.cuda.midstate``, the host's
per-template precompute, and ``backend.cuda.launch``.
``backend.cuda.host_tail`` covers the host's share once the device's result
is back (the reference's accounting and the winner's digest), the
counterpart of ``backend.tpu.host_tail`` (there the C++ tail past the last
whole round, which the one launch here leaves to the kernel).

The ``backend.cuda.dispatch`` fault site sits before the launch:
``raise`` / ``hang`` fire before any device work, ``corrupt`` / ``partial``
damage the finished result (``backend._faulted_result``). With the CUDA
kernel the library is built and bound when the backend is constructed, so
a kernel that does not build raises ``KernelError`` there, while the
resilience ladder builds its top rung.
"""
from __future__ import annotations

import functools
import time

import torch

from .. import core
from ..config import ConfigError
from ..meshprof.spans import skew_span
from ..ops import extend_midstate, select_kernel
from ..parallel.mesh import NONCE_SPACE, winner_select
from ..resilience import injection
from ..telemetry.spans import span
from . import MinerBackend, SearchResult, _faulted_result, register

_NOT_FOUND = (0, 0xFFFFFFFF)


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


def device_rounds(start: int, end: int, round_size: int) -> int:
    """Whole rounds of ``round_size`` the reference sweeps on the device
    for a search of [start, end): those that end at or below 2^32, the
    last one possibly past ``end`` (a round of exactly 2^32 is legal)."""
    if start >= end or start + round_size > NONCE_SPACE:
        return 0
    return min(-(-(end - start) // round_size),
               (NONCE_SPACE - start) // round_size, 0xFFFFFFFF)


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
    device_end = start + device_rounds(start, end, round_size) * round_size
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
                 device: str | torch.device = "cuda", n_miners: int = 1,
                 group=None):
        if n_miners < 1:
            raise ConfigError(f"n_miners must be >= 1, got {n_miners}")
        self.device = resolve_device(device)
        self.batch_size = 1 << batch_pow2
        self.n_miners = n_miners
        self.group = group
        self.rank = 0
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            world = dist.get_world_size(group)
            if world != n_miners:
                raise ConfigError(
                    f"the process group has {world} ranks but n_miners="
                    f"{n_miners}: the round split must match the world")
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

    @property
    def round_size(self) -> int:
        """Nonces of one round: every miner's B-slice."""
        return self.batch_size * self.n_miners

    def _searcher(self, difficulty_bits: int):
        fn = self._searchers.get(difficulty_bits)
        if fn is None:
            fn, self.effective_kernel = select_kernel(
                self.kernel, self.device, difficulty_bits)
            self._searchers[difficulty_bits] = fn
        return fn

    def _start(self, ext, base: int, count: int, difficulty_bits: int):
        """Starts one early-exit sweep of [base, base + count) and returns
        the function that gives its (count, min_nonce). With the CUDA
        kernel the sweep is on the device when this returns, and the
        function carries ``ready``, which says without blocking whether
        the device is done, and ``sweep``, the ``LaunchedSweep`` (its time
        on the card); with the plain version the function does all the
        work."""
        if count <= 0:
            return lambda: _NOT_FOUND
        if self.effective_kernel == "cuda":
            from ..ops import sha256_cuda
            launched = sha256_cuda.sweep_launch(
                ext, base, count, difficulty_bits, device=self.device,
                early_exit=True)

            def read() -> tuple[int, int]:
                return launched.result()
            read.ready = launched.ready
            read.sweep = launched
            return read
        return functools.partial(self._searcher(difficulty_bits), ext, base,
                                 count, early_exit=True)

    def launch(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = NONCE_SPACE):
        """Starts the search and returns the function that finishes it. With
        the CUDA kernel the sweep (in a world of processes, this rank's slice
        of the first round) is on the device when this returns, the finish
        waits for its 8-byte result and carries ``ready`` (see ``_start``) and,
        when the search is that one sweep, ``sweep``; with the plain version
        the finish does all the work."""
        # Fault-injection hook: raise/hang fire before any device work,
        # corrupt/partial damage the finished result.
        fault = injection.check("backend.cuda.dispatch",
                                difficulty=difficulty_bits)
        end = min(start_nonce + max_count, NONCE_SPACE)
        with span("backend.cuda.dispatch", difficulty=difficulty_bits):
            with span("backend.cuda.midstate"):
                ext = (extend_midstate(*core.header_midstate(header80))
                       if start_nonce < end else None)
            with span("backend.cuda.launch"):
                if self.group is None:
                    read = self._start(ext, start_nonce, end - start_nonce,
                                       difficulty_bits)
                else:
                    read = self._start_world(ext, start_nonce, end,
                                             difficulty_bits)

        def finish() -> SearchResult:
            count, best = read()
            with span("backend.cuda.host_tail"):
                res = self._result(header80, start_nonce, end, count, best)
            return res if fault is None else \
                _faulted_result(fault, res, start_nonce)
        if hasattr(read, "ready"):
            finish.ready = read.ready
        if hasattr(read, "sweep"):
            finish.sweep = read.sweep
        if hasattr(read, "opened"):
            finish.opened = read.opened
        return finish

    def _start_world(self, ext, start: int, end: int, difficulty_bits: int):
        """The search of one rank in a world of processes: this rank's
        slice of each round, a winner-select over the group after each,
        until a round's summed count is above 0; then the tail past the
        last whole round, swept whole by every rank. Starts the first
        round's slice; returns the function that runs the rest and gives
        the (count, min_nonce) of the whole search. On the card it carries
        ``ready`` and ``opened``, the ``time.perf_counter()`` at which the
        first slice was launched (the search's device window opens
        there)."""
        size, b = self.round_size, self.batch_size
        n_rounds = device_rounds(start, end, size)
        device_end = start + n_rounds * size

        def rank_slice(r: int):
            lo = start + r * size + self.rank * b
            return self._start(ext, lo, min(lo + b, end) - lo,
                               difficulty_bits)

        opened = time.perf_counter()
        first = rank_slice(0) if n_rounds else None

        def run() -> tuple[int, int]:
            read = first
            for r in range(n_rounds):
                # The skew span stamps this rank's arrival at the round
                # whose epilogue is the winner-select rendezvous.
                with skew_span(site="mesh.sweep"):
                    if read is None:
                        read = rank_slice(r)
                    count, best = winner_select(*read(), self.group)
                read = None
                if count > 0:
                    return count, best
            return self._start(ext, device_end, end - device_end,
                               difficulty_bits)()
        if first is not None and hasattr(first, "ready"):
            run.ready, run.opened = first.ready, opened
        return run

    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = NONCE_SPACE
               ) -> SearchResult:
        return self.launch(header80, difficulty_bits, start_nonce,
                           max_count)()

    def _result(self, header80: bytes, start: int, end: int, count: int,
                best: int) -> SearchResult:
        winner = best if count > 0 else None
        tried = reference_hashes_tried(start, end, self.round_size, winner)
        if winner is None:
            return SearchResult(None, None, tried)
        return SearchResult(winner,
                            core.header_hash(core.set_nonce(header80, winner)),
                            tried)
