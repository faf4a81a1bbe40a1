"""CPU miner_backend: the C++ scalar sweep (the correctness oracle).

With n_ranks > 1 it splits the search space the way ``mpirun -np N`` ranks
did, in interleaved contiguous rounds, which keeps the lowest-nonce winner
rule exact. The ``backend.cpu.search`` fault site sits before the sweep:
``raise`` / ``hang`` fire there, ``corrupt`` / ``partial`` damage the
result. The sweep runs inside the reference's ``backend.cpu.search``
span.

``launch``, the start of a search that the pipelined driver issues, hands
it to the backend's one search thread, as the reference hands every
dispatch to its one dispatch worker: the C++ sweep releases the
interpreter lock, so it runs from the issue while the driver validates
and appends the previous block, and its time on that thread
(``HostSweep``) is the length of the dispatch's device window.
``search`` runs on the calling thread.
"""
from __future__ import annotations

import concurrent.futures
import time

from .. import core
from ..resilience import injection
from ..telemetry.spans import span
from . import MinerBackend, SearchResult, _faulted_result, register


class HostSweep:
    """A search on a backend's search thread, the C++ sweep's counterpart
    of a sweep on the card (``ops.sha256_cuda.LaunchedSweep``): ``ready``
    says without blocking whether it is done, ``wait`` waits for it up to
    a timeout (True once done), and ``timing`` gives, once it is done,
    (when it was handed to the thread, on ``time.perf_counter()``; the
    seconds the thread spent in it), as a sweep on the card gives its
    launch and its time there."""

    timed = True
    __slots__ = ("future", "launched", "started", "ended")

    def __init__(self):
        self.future: concurrent.futures.Future | None = None
        self.launched = time.perf_counter()
        self.started = self.ended = 0.0

    def run(self, search, *args, **kwargs):
        self.started = time.perf_counter()
        try:
            return search(*args, **kwargs)
        finally:
            self.ended = time.perf_counter()

    def ready(self) -> bool:
        return self.future.done()

    def wait(self, timeout: float | None) -> bool:
        done, _ = concurrent.futures.wait((self.future,), timeout)
        return bool(done)

    def timing(self) -> tuple[float, float]:
        return self.launched, self.ended - self.started


@register("cpu")
class CpuBackend(MinerBackend):
    def __init__(self, n_ranks: int = 1, batch_size: int = 1 << 20):
        self.n_ranks = n_ranks
        self.batch_size = batch_size
        self._pool = (concurrent.futures.ThreadPoolExecutor(n_ranks)
                      if n_ranks > 1 else None)
        self._thread: concurrent.futures.ThreadPoolExecutor | None = None

    def launch(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = 1 << 32):
        """Starts the search on this backend's one search thread (searches
        run there one at a time, in issue order) and returns the function
        that waits for its result. The finish carries ``ready``, ``wait``
        and ``sweep``, the ``HostSweep``."""
        if self._thread is None:
            self._thread = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="cpu-search")
        sweep = HostSweep()
        sweep.future = self._thread.submit(
            sweep.run, self.search, header80, difficulty_bits,
            start_nonce=start_nonce, max_count=max_count)

        def finish() -> SearchResult:
            return sweep.future.result()
        finish.ready, finish.wait, finish.sweep = \
            sweep.ready, sweep.wait, sweep
        return finish

    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = 1 << 32) -> SearchResult:
        fault = injection.check("backend.cpu.search",
                                difficulty=difficulty_bits)
        with span("backend.cpu.search", n_ranks=self.n_ranks):
            if self.n_ranks == 1:
                nonce, tried = core.cpu_search(header80, start_nonce,
                                               max_count, difficulty_bits)
                digest = (core.header_hash(core.set_nonce(header80, nonce))
                          if nonce is not None else None)
                res = SearchResult(nonce, digest, tried)
            else:
                res = self._search_ranks(header80, difficulty_bits,
                                         start_nonce, max_count)
        if fault is not None:
            res = _faulted_result(fault, res, start_nonce)
        return res

    def _search_ranks(self, header80: bytes, difficulty_bits: int,
                      start_nonce: int, max_count: int) -> SearchResult:
        # Round r covers the contiguous range [base, base + n_ranks*B); rank
        # i sweeps its B-sized slice. The first round with any qualifier
        # holds the exact global lowest nonce, since every smaller nonce was
        # already swept (the C++ side releases the GIL during cc_search, so
        # ranks run in parallel).
        B = self.batch_size
        end = min(start_nonce + max_count, 1 << 32)
        base = start_nonce
        total_tried = 0
        while base < end:
            spans = []
            for i in range(self.n_ranks):
                lo = base + i * B
                hi = min(lo + B, end)
                if lo < hi:
                    spans.append((lo, hi - lo))
            results = list(self._pool.map(
                lambda s: core.cpu_search(header80, s[0], s[1],
                                          difficulty_bits), spans))
            total_tried += sum(t for _, t in results)
            found = [n for n, _ in results if n is not None]
            if found:
                nonce = min(found)
                digest = core.header_hash(core.set_nonce(header80, nonce))
                return SearchResult(nonce, digest, total_tried)
            base += self.n_ranks * B
        return SearchResult(None, None, total_tried)
