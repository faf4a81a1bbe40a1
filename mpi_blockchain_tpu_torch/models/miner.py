"""The Miner: builds candidates, drives the backend search, appends blocks.

Chain state is canonical in the C++ Node; the search runs behind the
miner_backend plugin boundary. Two chain drivers share the per-sweep
semantics:

* ``mine_block``, the sequential oracle: one sweep at a time, host work
  strictly between sweeps. Every other driver must match it byte for
  byte.
* ``mine_chain`` (pipeline on, the default), the double-buffered driver:
  sweep N+1 is issued through the backend's ``search_async`` seam on the
  assumption that sweep N has no winner, and on a winner the next block's
  first sweep is issued from the winner's digest before the C++ append
  lands.

The pipeline keeps the determinism contract: results are consumed strictly
in issue order (ascending windows, then ascending templates), a winner
discards every still-queued speculative dispatch, and each block boundary
re-validates the speculated candidate and window set against the C++ node
(a mismatch discards and re-issues). ``MPIBT_PIPELINE=0`` (or
``pipeline=False``) selects the sequential oracle.

The reference's telemetry, block tracing, pipeline profiler and heartbeat
calls are not ported in this slice.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import logging
import os
import time
from typing import Callable

from .. import core
from ..backend import MinerBackend, backend_from_config
from ..config import MAX_EXTRA_NONCE, MinerConfig, extend_payload

_LOGGER = logging.getLogger("mpi_blockchain_tpu_torch")

#: Budget (seconds) for ONE in-flight dispatch at the pipelined consume
#: point: "the dispatch is gone", not "the sweep is slow".
DISPATCH_TIMEOUT_S = 900.0


@dataclasses.dataclass(frozen=True)
class BlockRecord:
    """Structured per-block mining record."""
    height: int
    nonce: int
    hash: str
    wall_ms: float
    hashes_tried: int


class _WindowSet:
    """Lazy, index-addressable view of one block's ``search_windows()``:
    windows are pulled from the generator only as far as the sweep cursor
    reaches. ``get(i)`` returns the i-th ``(start, end)`` window or None
    past the end."""

    __slots__ = ("_it", "_cache", "_done")

    def __init__(self, it):
        self._it = iter(it)
        self._cache: list[tuple] = []
        self._done = False

    def get(self, i: int):
        while not self._done and len(self._cache) <= i:
            try:
                self._cache.append(tuple(next(self._it)))
            except StopIteration:
                self._done = True
        return self._cache[i] if i < len(self._cache) else None

    def striped(self) -> bool:
        """More than one window: the striped shape whose cross-template
        speculation discard costs at most one slice."""
        return self.get(1) is not None


@dataclasses.dataclass
class _SweepDispatch:
    """One issued sweep of the pipelined driver: its place in the sweep
    order (height, template, window index), the exact candidate it
    searched, and its future."""
    height: int
    template: int
    window_index: int
    window: tuple
    cand: bytes
    future: concurrent.futures.Future | None = None


def _drain_discarded(fut: concurrent.futures.Future) -> None:
    """Done-callback for a discarded dispatch that had already reached the
    backend: its result is dropped, but a failure is still logged."""
    if fut.cancelled():
        return
    exc = fut.exception()
    if exc is not None:
        _LOGGER.warning("discarded speculative dispatch failed: %s: %s",
                     type(exc).__name__, exc)


class Miner:
    """One mining node: a C++ Node + a search backend."""

    #: Max dispatches in flight in the pipelined driver: the one being
    #: waited on plus one speculative successor.
    PIPELINE_DEPTH = 2

    def __init__(self, config: MinerConfig,
                 backend: MinerBackend | None = None,
                 pipeline: bool | None = None):
        self.config = config
        self.node = core.Node(config.difficulty_bits)
        self.backend = (backend if backend is not None
                        else backend_from_config(config))
        self.records: list[BlockRecord] = []
        if pipeline is None:
            pipeline = os.environ.get("MPIBT_PIPELINE", "1") != "0"
        self.pipeline = pipeline

    def search_windows(self):
        """The ascending ``(start, end)`` nonce windows each candidate
        sweep covers, searched in order until one holds a qualifier. The
        default miner owns the whole uint32 space in one window."""
        return ((0, 1 << 32),)

    @staticmethod
    def _log(event: dict) -> None:
        _LOGGER.debug("%s", json.dumps(event, sort_keys=True))

    def payload_for(self, height: int) -> bytes:
        """The payload the candidate at ``height`` embeds. Both drivers
        route every payload through this one hook; the pipelined driver
        re-validates a speculative candidate against a fresh read at the
        next block boundary."""
        return self.config.payload(height)

    # ---- the sequential oracle --------------------------------------------

    def mine_block(self) -> BlockRecord:
        """Mines and appends exactly one block on the current tip.

        If the full 2^32 nonce space holds no qualifier, rolls over to a
        fresh space via the shared extra-nonce rule
        (``config.extend_payload``).
        """
        height = self.node.height + 1
        data = self.payload_for(height)
        t0 = time.perf_counter()
        tried = 0
        for extra_nonce in range(MAX_EXTRA_NONCE + 1):
            cand = self.node.make_candidate(extend_payload(data, extra_nonce))
            res = None
            # Windows ascend, so the first one holding a qualifier yields
            # the lowest nonce in this miner's space.
            for w_start, w_end in self.search_windows():
                res = self.backend.search(cand, self.config.difficulty_bits,
                                          start_nonce=w_start,
                                          max_count=w_end - w_start)
                tried += res.hashes_tried
                if res.nonce is not None:
                    break
            if res is None:
                raise RuntimeError("search_windows yielded no nonce windows")
            if res.nonce is not None:
                break
            self._log({"event": "nonce_space_exhausted", "height": height,
                       "extra_nonce": extra_nonce + 1})
        else:
            raise RuntimeError(
                f"{MAX_EXTRA_NONCE} consecutive empty nonce spaces at "
                f"height {height} — difficulty "
                f"{self.config.difficulty_bits} is unsatisfiably high")
        wall_ms = (time.perf_counter() - t0) * 1e3
        res = dataclasses.replace(res, hashes_tried=tried)
        if not self.node.submit(core.set_nonce(cand, res.nonce)):
            raise RuntimeError(f"backend returned invalid block at {height}")
        rec = BlockRecord(height=height, nonce=res.nonce,
                          hash=res.hash.hex(), wall_ms=wall_ms,
                          hashes_tried=res.hashes_tried)
        self._finalize_block(rec)
        return rec

    def _finalize_block(self, rec: BlockRecord) -> None:
        """Post-append accounting shared by both drivers."""
        self.records.append(rec)
        self._log({"event": "block_mined", "backend": self.backend.name,
                   **dataclasses.asdict(rec)})

    def mine_chain(self, n_blocks: int | None = None,
                   on_block: Callable[[BlockRecord], None] | None = None
                   ) -> list[BlockRecord]:
        """Mines n_blocks on top of the current tip. ``on_block`` runs
        after each append (in the pipelined driver, while the next block's
        sweep is already issued)."""
        n = n_blocks if n_blocks is not None else self.config.n_blocks
        if self.pipeline and n > 0:
            return self._mine_chain_pipelined(n, on_block)
        records = []
        for _ in range(n):
            rec = self.mine_block()
            records.append(rec)
            if on_block is not None:
                on_block(rec)
        return records

    # ---- the double-buffered pipeline -------------------------------------

    def _issue_sweep(self, height: int, template: int,
                     windows: _WindowSet, w_idx: int,
                     cand_fn: Callable[[], bytes]) -> _SweepDispatch:
        """Issues one sweep through the backend's ``search_async`` seam."""
        w_start, w_end = windows.get(w_idx)
        d = _SweepDispatch(height, template, w_idx, (w_start, w_end),
                           cand_fn())
        d.future = self.backend.search_async(
            d.cand, self.config.difficulty_bits, start_nonce=w_start,
            max_count=w_end - w_start)
        return d

    def _consume(self, d: _SweepDispatch):
        """Blocks on one dispatch's result (strictly in issue order, the
        lowest-nonce rule), bounded by ``MPIBT_DISPATCH_TIMEOUT``."""
        try:
            return d.future.result(timeout=DISPATCH_TIMEOUT_S)
        except concurrent.futures.TimeoutError:
            if d.future.done():
                raise           # the sweep itself raised a TimeoutError
            raise RuntimeError(
                f"dispatch wedged: sweep for height {d.height} (template "
                f"{d.template}, window {d.window_index}) returned nothing "
                f"within {DISPATCH_TIMEOUT_S}s (MPIBT_DISPATCH_TIMEOUT)"
            ) from None

    @staticmethod
    def _discard_speculative(pending) -> None:
        """Discards every still-queued speculative dispatch: a winner (or
        a changed window set, or an error) falsified the assumption they
        were issued under."""
        while pending:
            d = pending.popleft()
            if not d.future.cancel():
                d.future.add_done_callback(_drain_discarded)

    def _candidate(self, cands: dict, data: bytes, template: int) -> bytes:
        cand = cands.get(template)
        if cand is None:
            cand = cands[template] = self.node.make_candidate(
                extend_payload(data, template))
        return cand

    def _speculation_valid(self, pending, windows: _WindowSet,
                           cands: dict, data: bytes) -> bool:
        """True when every pending speculative dispatch still matches the
        block boundary's state: same sweep order from (template 0, window
        0), same windows, and a candidate byte-identical to what the C++
        node builds on the real tip."""
        expect = (0, 0)
        for d in pending:
            if (d.template, d.window_index) != expect:
                return False
            if d.window != windows.get(d.window_index):
                return False
            if d.cand != self._candidate(cands, data, d.template):
                return False
            expect = ((d.template, d.window_index + 1)
                      if windows.get(d.window_index + 1) is not None
                      else (d.template + 1, 0))
        return True

    def _mine_chain_pipelined(self, n: int, on_block) -> list[BlockRecord]:
        """The double-buffered chain driver: at most ``PIPELINE_DEPTH``
        sweeps in flight, consumed strictly in issue order."""
        records: list[BlockRecord] = []
        pending: collections.deque[_SweepDispatch] = collections.deque()
        t_prev = time.perf_counter()
        try:
            while len(records) < n:
                rec, pending = self._pipeline_block(n - len(records),
                                                    pending)
                now = time.perf_counter()
                rec = dataclasses.replace(rec, wall_ms=(now - t_prev) * 1e3)
                t_prev = now
                self._finalize_block(rec)
                records.append(rec)
                if on_block is not None:
                    on_block(rec)
        except BaseException:
            self._discard_speculative(pending)
            raise
        return records

    def _pipeline_block(self, blocks_left: int, pending):
        """Mines ONE block through the pipeline; returns ``(record,
        pending)`` where ``pending`` holds the speculative first sweep of
        the next block, issued from this winner's digest before the
        append. ``wall_ms`` is a placeholder the chain driver replaces."""
        height = self.node.height + 1
        data = self.payload_for(height)
        windows = _WindowSet(self.search_windows())
        if windows.get(0) is None:
            self._discard_speculative(pending)
            raise RuntimeError("search_windows yielded no nonce windows")
        cands: dict[int, bytes] = {}
        if pending and not self._speculation_valid(pending, windows,
                                                   cands, data):
            self._discard_speculative(pending)

        # The sweep cursor: the (template, window) the next issued dispatch
        # covers. None = blocked at a template boundary that a 1-window
        # world crosses only once the no-winner is confirmed.
        def advance(template: int, w_idx: int):
            if windows.get(w_idx + 1) is not None:
                return (template, w_idx + 1)
            if windows.striped() and template < MAX_EXTRA_NONCE:
                return (template + 1, 0)
            return None

        cursor = ((0, 0) if not pending
                  else advance(pending[-1].template,
                               pending[-1].window_index))
        tried = 0
        while True:
            while cursor is not None and len(pending) < self.PIPELINE_DEPTH:
                e, w = cursor
                pending.append(self._issue_sweep(
                    height, e, windows, w,
                    lambda e=e: self._candidate(cands, data, e)))
                cursor = advance(e, w)
            d = pending.popleft()
            r = self._consume(d)
            tried += r.hashes_tried
            if r.nonce is not None:
                res, win_d = r, d
                break
            if windows.get(d.window_index + 1) is None:
                # This template's whole window set came back empty: the
                # shared rollover rule (config.extend_payload).
                self._log({"event": "nonce_space_exhausted",
                           "height": height, "extra_nonce": d.template + 1})
                if d.template >= MAX_EXTRA_NONCE:
                    self._discard_speculative(pending)
                    raise RuntimeError(
                        f"{MAX_EXTRA_NONCE} consecutive empty nonce spaces "
                        f"at height {height} — difficulty "
                        f"{self.config.difficulty_bits} is unsatisfiably "
                        f"high")
                if cursor is None and not pending:
                    # The no-winner is confirmed now, so the next template
                    # is no longer a speculation.
                    cursor = (d.template + 1, 0)
        res = dataclasses.replace(res, hashes_tried=tried)
        # A winner falsifies every queued no-winner speculation.
        self._discard_speculative(pending)
        if blocks_left > 1:
            # Issue the next block's first sweep from the winner's digest,
            # the prev_hash the C++ append is about to install; it is
            # re-validated at the next block boundary.
            nh, ndata = height + 1, self.payload_for(height + 1)
            pending.append(self._issue_sweep(
                nh, 0, windows, 0,
                lambda: core.make_candidate_header(
                    res.hash, ndata, nh, self.config.difficulty_bits)))
        if not self.node.submit(core.set_nonce(win_d.cand, res.nonce)):
            self._discard_speculative(pending)
            raise RuntimeError(f"backend returned invalid block at {height}")
        rec = BlockRecord(height=height, nonce=res.nonce,
                          hash=res.hash.hex(), wall_ms=0.0,
                          hashes_tried=res.hashes_tried)
        return rec, pending

    # ---- aggregate metrics -------------------------------------------------

    def total_hashes(self) -> int:
        return sum(r.hashes_tried for r in self.records)

    def total_wall_s(self) -> float:
        return sum(r.wall_ms for r in self.records) / 1e3

    def hashes_per_sec(self) -> float:
        return self.total_hashes() / max(self.total_wall_s(), 1e-9)
