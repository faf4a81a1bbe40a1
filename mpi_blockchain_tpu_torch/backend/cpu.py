"""CPU miner_backend: the C++ scalar sweep (the correctness oracle).

With n_ranks > 1 it splits the search space the way ``mpirun -np N`` ranks
did, in interleaved contiguous rounds, which keeps the lowest-nonce winner
rule exact.
"""
from __future__ import annotations

import concurrent.futures

from .. import core
from . import MinerBackend, SearchResult, register


@register("cpu")
class CpuBackend(MinerBackend):
    def __init__(self, n_ranks: int = 1, batch_size: int = 1 << 20):
        self.n_ranks = n_ranks
        self.batch_size = batch_size
        self._pool = (concurrent.futures.ThreadPoolExecutor(n_ranks)
                      if n_ranks > 1 else None)

    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = 1 << 32) -> SearchResult:
        if self.n_ranks == 1:
            nonce, tried = core.cpu_search(header80, start_nonce,
                                           max_count, difficulty_bits)
            digest = (core.header_hash(core.set_nonce(header80, nonce))
                      if nonce is not None else None)
            return SearchResult(nonce, digest, tried)
        return self._search_ranks(header80, difficulty_bits, start_nonce,
                                  max_count)

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
