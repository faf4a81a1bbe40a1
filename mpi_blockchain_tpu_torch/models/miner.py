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

The default backend is ``backend_from_config``'s ``ResilientBackend``,
whose ``search_async`` puts each sweep on the card before it returns and
reads it back when the driver consumes it, so the host's validation and
append of block N overlap the sweep for block N + 1. The wait for a
consumed sweep is bounded by ``MPIBT_DISPATCH_TIMEOUT``, as in the
reference: a sweep wedged on the card fails the run loudly.

Both drivers keep the reference's telemetry at the reference's points:
``mining_rounds_total`` and ``hashes_tried_total`` per consumed sweep,
the ``miner_heartbeat`` gauge stamped after every sweep and every append
(so a long block does not read as a stalled miner), and per block
``blocks_mined_total`` and the ``block_latency_ms`` histogram; the
pipelined driver counts ``speculative_discards_total{reason}``. Both
carry the reference's spans: ``miner.block`` around a block,
``miner.sweep`` around each search (in the pipelined driver, around the
consume of a dispatch), ``miner.append`` around the C++ append. Three
seams are the reference's: ``payload_for`` (the template feed),
``_begin_block`` (runs before a block's first sweep; the elastic world
supervises and re-stripes there) and ``_block_mined`` (runs after every
append; the serving front door marks transactions included there, the
elastic world writes its causal record).

Both drivers trace every block as the reference does: a
``blocktrace.trace_block`` frame around the block (and one per template),
one ``meshwatch.pipeline`` dispatch record per sweep with ``enqueue``,
``device``, ``validate`` and ``append`` segments (the ``on_block``
checkpoint seam runs in the block's frame, so its ``checkpoint`` segment
joins the block), discarded speculative dispatches stripped of their
block identity, and ``observe_block_metrics`` after each block, which
feeds ``block_critical_path_ms{stage}`` and ``block_trace_gap_pct`` and
evaluates the ``chainwatch`` watchdog.

The ``device`` window. The sequential driver's is the search call, as in
the reference. The reference's pipelined driver closes the window when a
worker thread's future completes; the port has no worker, so a window
closed at the consume would count every microsecond of host work done
while the card sat idle as device time, and the bubble fraction would read
near 0 whatever the card did. So on the card the window comes from the
card: with its telemetry on, the driver issues each sweep inside
``sha256_cuda.timed_launches``, so ``sweep_launch`` records timing events
around it, and at the consume ``start.elapsed_time(end)`` is the sweep's
device time (with the telemetry off, or on any other path, a sweep
carries one plain event, which costs the host less). Sweeps on one stream
run in order, so on the host's clock the window is ``[max(launched,
previous window's end), + device time]``, no extra synchronization and no
thread (``_card_window``). A discarded speculative sweep that reached the
card is drained the same way once it is done, at a later consume, as
unattributed work; one still on the card when the chain ends stays
unrecorded, and one that failed is a ``speculative_dispatch_failed``
event. The C++ sweep behind ``ResilientBackend`` runs on its backend's
search thread from the issue (``backend.cpu.HostSweep``), as the
reference's runs on its dispatch worker, and its window is taken as on
the card: it opens at the hand-off to the thread (or the previous
window's end) and lasts the time the thread spent in the search; the
thread's own start, which waits for the interpreter lock, falls to the
chained ``validate`` as the card's launch latency does. A discarded one
is drained as on the card. A search in a world of processes on the card
puts its first slice on the card at the issue and runs its
winner-selects in the consume, so its window opens when that slice went
on the card (or at the previous window's end) and closes with the
consume (``_world_window``). Where the search has none of these (the
plain sweep, a retried search) the window is the call that did the
work: the issue call of a synchronous ``search_async``, else the
consume. The ``enqueue`` segment covers the
candidate build and the issue call (on the card, the host's midstate
precompute and the launch).
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import os
import time
from typing import Callable

from .. import core
from ..backend import MinerBackend, backend_from_config
from ..blocktrace import trace_block
from ..blocktrace.critical_path import observe_block_metrics
from ..config import MAX_EXTRA_NONCE, KernelError, MinerConfig, \
    extend_payload
from ..meshwatch.pipeline import profiler, strip_block_identity
from ..ops.sha256_cuda import timed_launches
from ..telemetry import counter, heartbeat, histogram
from ..telemetry.events import emit_event, env_number
from ..telemetry.registry import telemetry_disabled
from ..telemetry.spans import span
from ..utils.logging import block_logger

#: Budget (seconds) for one in-flight dispatch at the pipelined consume
#: point: a sweep that has not completed by then is taken as wedged and
#: fails the run. 900 s is "the dispatch is gone", not "the sweep is
#: slow". The reference's knob, read as the reference reads it.
DISPATCH_TIMEOUT_S = env_number("MPIBT_DISPATCH_TIMEOUT", 900.0,
                                cast=float, minimum=1e-3)


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
    searched, its future and its pipeline record. ``t_issue`` and
    ``t_issued`` bracket the issue call on the profiler's clock; ``sync``
    says the future was already done when the call returned (a
    synchronous ``search_async``: the search ran inside it)."""
    height: int
    template: int
    window_index: int
    window: tuple
    cand: bytes
    prec: object
    future: concurrent.futures.Future | None = None
    t_issue: float = 0.0
    t_issued: float = 0.0
    sync: bool = False


def _drain_discarded(d: _SweepDispatch, fut) -> None:
    """Done-callback for a discarded dispatch that had already run (a
    synchronous ``search_async``): its search ran in the issue call, so
    that window stays visible in the pipeline record as unattributed work
    (identity stripped); a failure is an event a post-mortem can see."""
    if fut.cancelled():
        return
    exc = fut.exception()
    if exc is not None:
        emit_event({"event": "speculative_dispatch_failed",
                    "error": f"{type(exc).__name__}: {exc}"})
        return
    d.prec.add_segment("device", d.t_issue, d.t_issued)
    strip_block_identity(d.prec.record, segments=True)


class Miner:
    """One mining node: a C++ Node + a search backend."""

    #: Max dispatches in flight in the pipelined driver: the one being
    #: waited on plus one speculative successor.
    PIPELINE_DEPTH = 2

    def __init__(self, config: MinerConfig,
                 backend: MinerBackend | None = None,
                 pipeline: bool | None = None,
                 log_fn: Callable[[dict], None] | None = None):
        self.config = config
        self.node = core.Node(config.difficulty_bits)
        self.backend = (backend if backend is not None
                        else backend_from_config(config))
        self.records: list[BlockRecord] = []
        # Where the block_mined and nonce_space_exhausted records go: by
        # default the event stream (INFO on stderr, and ringed).
        self._log = log_fn if log_fn is not None else block_logger()
        if pipeline is None:
            pipeline = os.environ.get("MPIBT_PIPELINE", "1") != "0"
        self.pipeline = pipeline
        # The block's own pipeline records, handed to the critical-path
        # observation after the block (no scan of the profiler's ring).
        self._trace_records: list[dict] = []
        # Discarded sweeps that reached the card, drained once done at a
        # later consume (``_drain_card``), and the end of the newest card
        # window on the host's perf_counter clock (``_card_window``).
        self._draining: list[_SweepDispatch] = []
        self._card_end = 0.0

    def search_windows(self):
        """The ascending ``(start, end)`` nonce windows each candidate
        sweep covers, searched in order until one holds a qualifier. The
        default miner owns the whole uint32 space in one window."""
        return ((0, 1 << 32),)

    def payload_for(self, height: int) -> bytes:
        """The payload the candidate at ``height`` embeds. Both drivers
        route every payload through this one hook, so a template service
        can bind a live template per instance; the pipelined driver
        re-validates a speculative candidate against a fresh read at the
        next block boundary, so a template rebuilt between blocks turns
        the stale speculation into a ``restripe`` discard."""
        return self.config.payload(height)

    def _begin_block(self, height: int) -> None:
        """Runs before a block's first sweep, in both drivers: the elastic
        supervision seam (fault site, staleness oracle, re-stripe). The
        pipelined driver re-validates any speculative dispatch against
        the window set and candidate read after it, so a hook that
        re-stripes turns the speculation into a ``restripe`` discard."""

    def _block_mined(self, rec: BlockRecord) -> None:
        """Runs right after a block's append, in both drivers."""

    # ---- the sequential oracle --------------------------------------------

    def mine_block(self, data: bytes | None = None) -> BlockRecord:
        """Mines and appends exactly one block on the current tip, with
        ``data`` as its payload (by default ``payload_for``).

        If the full 2^32 nonce space holds no qualifier, rolls over to a
        fresh space via the shared extra-nonce rule
        (``config.extend_payload``).
        """
        height = self.node.height + 1
        self._begin_block(height)
        if data is None:
            data = self.payload_for(height)
        backend = self.backend.name
        t0 = time.perf_counter()
        tried = 0
        # The block's own dispatch records, for the observation in
        # mine_chain (the checkpoint seam's segment_on_last lands in the
        # newest of these same dicts).
        self._trace_records = trace_records = []
        with trace_block(height), span("miner.block", height=height):
            for extra_nonce in range(MAX_EXTRA_NONCE + 1):
                # One dispatch record per sweep: in this synchronous loop
                # the device window is the search call. The frame is
                # re-entered per template so rollover candidates stay
                # apart in the per-block join.
                with trace_block(height, template=extra_nonce):
                    prec = profiler().dispatch(kind="sweep", height=height,
                                               backend=backend)
                    trace_records.append(prec.record)
                    with prec.segment("enqueue"):
                        cand = self.node.make_candidate(
                            extend_payload(data, extra_nonce))
                    res = None
                    with span("miner.sweep", height=height,
                              extra_nonce=extra_nonce), \
                            prec.segment("device"):
                        # Windows ascend, so the first one holding a
                        # qualifier yields the lowest nonce in this
                        # miner's space.
                        for w_start, w_end in self.search_windows():
                            res = self.backend.search(
                                cand, self.config.difficulty_bits,
                                start_nonce=w_start,
                                max_count=w_end - w_start)
                            self._count_sweep(backend, res.hashes_tried)
                            tried += res.hashes_tried
                            if res.nonce is not None:
                                break
                if res is None:
                    raise RuntimeError(
                        "search_windows yielded no nonce windows")
                if res.nonce is not None:
                    break
                self._log({"event": "nonce_space_exhausted",
                           "height": height, "extra_nonce": extra_nonce + 1})
            else:
                raise RuntimeError(
                    f"{MAX_EXTRA_NONCE} consecutive empty nonce spaces at "
                    f"height {height} — difficulty "
                    f"{self.config.difficulty_bits} is unsatisfiably high")
            wall_ms = (time.perf_counter() - t0) * 1e3
            res = dataclasses.replace(res, hashes_tried=tried)
            with prec.segment("validate"):
                winner = core.set_nonce(cand, res.nonce)
            with span("miner.append", height=height), \
                    prec.segment("append"):
                accepted = self.node.submit(winner)
        if not accepted:
            raise RuntimeError(f"backend returned invalid block at {height}")
        rec = BlockRecord(height=height, nonce=res.nonce,
                          hash=res.hash.hex(), wall_ms=wall_ms,
                          hashes_tried=res.hashes_tried)
        self._finalize_block(rec, backend)
        return rec

    def _count_sweep(self, backend: str, hashes_tried: int) -> None:
        """Per consumed sweep, shared by both drivers: the round and hash
        counters, and a heartbeat stamp, so that a backend wedged inside
        a long block stalls the ``/healthz`` watchdog."""
        counter("mining_rounds_total", help="backend sweep rounds issued",
                backend=backend).inc()
        counter("hashes_tried_total",
                help="nonces evaluated across all sweeps",
                backend=backend).inc(hashes_tried)
        heartbeat("miner_heartbeat").set(self.node.height)

    def _finalize_block(self, rec: BlockRecord, backend: str) -> None:
        """Post-append accounting shared by both drivers: counters,
        heartbeat, latency histogram, the records list, the block_mined
        log line and the ``_block_mined`` hook. ``backend`` is the label
        taken when the block's sweeps were issued (the ladder may have
        stepped down since)."""
        counter("blocks_mined_total", help="blocks mined and appended",
                backend=backend).inc()
        heartbeat("miner_heartbeat").set(self.node.height)
        histogram("block_latency_ms",
                  help="wall-clock per mined block (winner latency, ms)",
                  backend=backend).observe(rec.wall_ms)
        self.records.append(rec)
        self._log({"event": "block_mined", "backend": self.backend.name,
                   **dataclasses.asdict(rec)})
        self._block_mined(rec)

    def mine_chain(self, n_blocks: int | None = None,
                   on_block: Callable[[BlockRecord], None] | None = None
                   ) -> list[BlockRecord]:
        """Mines n_blocks on top of the current tip. ``on_block`` runs
        after each append, inside the block's trace frame (in the
        pipelined driver, while the next block's sweep is already issued);
        the block's critical path is observed after it, so a checkpoint
        segment it times counts toward the block."""
        n = n_blocks if n_blocks is not None else self.config.n_blocks
        if self.pipeline and n > 0:
            return self._mine_chain_pipelined(n, on_block)
        records = []
        for _ in range(n):
            rec = self.mine_block()
            records.append(rec)
            if on_block is not None:
                with trace_block(rec.height):
                    on_block(rec)
            observe_block_metrics(rec.height, records=self._trace_records)
        return records

    # ---- the double-buffered pipeline -------------------------------------

    def _issue_sweep(self, height: int, template: int,
                     windows: _WindowSet, w_idx: int,
                     cand_fn: Callable[[], bytes],
                     backend_name: str) -> _SweepDispatch:
        """Issues one sweep through the backend's ``search_async`` seam.
        The candidate build and the issue call are the ``enqueue``
        segment; the device window is recorded at the consume, from the
        sweep's timing events, which only a traced issue asks for."""
        w_start, w_end = windows.get(w_idx)
        with trace_block(height, template=template):
            prec = profiler().dispatch(kind="sweep", height=height,
                                       backend=backend_name)
            with prec.segment("enqueue"), \
                    timed_launches(not telemetry_disabled()):
                d = _SweepDispatch(height, template, w_idx,
                                   (w_start, w_end), cand_fn(), prec)
                d.t_issue = prec.now()
                d.future = self.backend.search_async(
                    d.cand, self.config.difficulty_bits,
                    start_nonce=w_start, max_count=w_end - w_start)
                d.t_issued = prec.now()
                d.sync = d.future.done()
        return d

    def _consume(self, d: _SweepDispatch):
        """Blocks on one dispatch's result, strictly in issue order (the
        lowest-nonce rule), bounded by ``MPIBT_DISPATCH_TIMEOUT`` so that a
        wedged sweep surfaces as a loud failure instead of a silent hang.
        The resilient backend's future polls the sweep on the card against
        the deadline, then reads it back on this thread. Records the
        dispatch's device window with its own block identity."""
        with span("miner.sweep", height=d.height, extra_nonce=d.template):
            t_wait = d.prec.now()
            try:
                res = d.future.result(timeout=DISPATCH_TIMEOUT_S)
            except concurrent.futures.TimeoutError:
                if d.future.done():
                    # The sweep itself raised a TimeoutError (the classes
                    # alias): a backend failure, not a wedged wait; it
                    # surfaces with its own traceback.
                    raise
                raise RuntimeError(
                    f"dispatch wedged: sweep for height {d.height} "
                    f"(template {d.template}, window {d.window_index}) "
                    f"returned nothing within {DISPATCH_TIMEOUT_S}s "
                    f"(MPIBT_DISPATCH_TIMEOUT) — treating the backend as "
                    f"hung") from None
            t_done = d.prec.now()
        if telemetry_disabled():
            return res
        # Sweeps on the card finish in issue order: every discarded one
        # issued before this one is done now too.
        self._drain_card()
        t0, t1 = self._device_window(d, t_wait, t_done)
        with trace_block(d.height, template=d.template):
            d.prec.add_segment("device", t0, t1)
        return res

    def _device_window(self, d: _SweepDispatch, t_wait: float,
                       t_done: float) -> tuple[float, float]:
        """A consumed dispatch's device window on the profiler's clock:
        from its started sweep's launch and time (on the card, its
        events; on a search thread, its stamps) when its result is that
        sweep's, from its first slice on the card to the consume for a
        search in a world of processes, else the call that did the work
        (the issue call of a synchronous ``search_async``, else the
        consume)."""
        if d.sync:
            return d.t_issue, d.t_issued
        sweep = getattr(d.future, "sweep", None)
        if sweep is not None and sweep.timed and d.future.from_launch:
            return self._card_window(d.prec, *sweep.timing())
        opened = getattr(d.future, "opened", None)
        if opened is not None and d.future.from_launch:
            return self._world_window(d.prec, opened, t_done)
        return t_wait, t_done

    def _world_window(self, prec, opened: float,
                      t_done: float) -> tuple[float, float]:
        """The window of a search in a world of processes: its first
        slice went on the card at ``opened`` (perf_counter), after the
        card's earlier work, and its winner-selects ran in the consume,
        which ended at ``t_done`` (the profiler's clock). The consume
        alone would leave the slice's time on the card, while the host
        finished the block before, out of every segment of its block."""
        start = max(opened, self._card_end)
        self._card_end = max(self._card_end, t_done - prec.at(0.0))
        return prec.at(start), t_done

    def _card_window(self, prec, launched: float,
                     device_s: float) -> tuple[float, float]:
        """The window of a sweep launched at ``launched`` (perf_counter)
        that ran ``device_s`` on the card (or on a search thread), on the
        profiler's clock. Sweeps on one stream (one thread) run in order,
        so it opens when it was launched or when the previous window
        closed, whichever is later. Windows are taken in launch order."""
        start = max(launched, self._card_end)
        self._card_end = start + device_s
        return prec.at(start), prec.at(self._card_end)

    def _drain_card(self) -> None:
        """Records the device windows of discarded sweeps that ran on the
        card and are done, identity stripped: their work stays visible as
        unattributed, never merged into a block a live dispatch mines. One
        not done yet waits for a later drain (nothing here waits for the
        card); one whose sweep failed is an event a post-mortem can see,
        as for any discarded dispatch."""
        keep = []
        for d in sorted(self._draining, key=lambda d: d.t_issue):
            sweep = d.future.sweep
            try:
                if not sweep.ready():
                    keep.append(d)
                    continue
                window = self._card_window(d.prec, *sweep.timing())
            except KernelError as e:
                emit_event({"event": "speculative_dispatch_failed",
                            "error": f"{type(e).__name__}: {e}"})
                continue
            d.prec.add_segment("device", *window)
            strip_block_identity(d.prec.record, segments=True)
        self._draining = keep

    @staticmethod
    def _discard_speculative(pending, reason: str) -> list:
        """Discards every still-queued speculative dispatch, counted by
        ``reason``: a ``winner``, a ``restripe`` (the block boundary's
        template or window set changed) or an ``error`` falsified the
        assumption they were issued under. Their records lose their block
        identity; one that already ran in its issue call keeps that
        window as unattributed work. Returns those whose sweep is on the
        card with its timing events, which the caller drains at a later
        consume (``_drain_card``), unattributed too."""
        on_card = []
        while pending:
            d = pending.popleft()
            counter("speculative_discards_total",
                    help="speculative pipeline dispatches discarded "
                         "before consumption, by reason",
                    reason=reason).inc()
            strip_block_identity(d.prec.record, segments=True)
            sweep = getattr(d.future, "sweep", None)
            if not d.future.cancel():
                d.future.add_done_callback(
                    functools.partial(_drain_discarded, d))
            elif sweep is not None and sweep.timed and \
                    not telemetry_disabled():
                on_card.append(d)
        return on_card

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
        backend = self.backend.name
        records: list[BlockRecord] = []
        pending: collections.deque[_SweepDispatch] = collections.deque()
        t_prev = time.perf_counter()
        try:
            while len(records) < n:
                rec, pending = self._pipeline_block(n - len(records),
                                                    pending, backend)
                now = time.perf_counter()
                rec = dataclasses.replace(rec, wall_ms=(now - t_prev) * 1e3)
                t_prev = now
                self._finalize_block(rec, backend)
                records.append(rec)
                if on_block is not None:
                    # In the block's frame: a checkpoint segment joins the
                    # block that paid it, while the next block's sweep is
                    # already on the card.
                    with trace_block(rec.height):
                        on_block(rec)
                observe_block_metrics(rec.height,
                                      records=self._trace_records)
        except BaseException:
            # The still-queued speculation must not leave block
            # identities on records of work that will be re-issued.
            self._discard_speculative(pending, "error")
            self._draining = []
            raise
        # Discarded sweeps still on the card stay unrecorded: waiting for
        # them would add their card time to the chain's wall.
        self._drain_card()
        self._draining = []
        return records

    def _pipeline_block(self, blocks_left: int, pending, backend: str):
        """Mines ONE block through the pipeline; returns ``(record,
        pending)`` where ``pending`` holds the speculative first sweep of
        the next block, issued from this winner's digest before the
        append. ``wall_ms`` is a placeholder the chain driver replaces."""
        height = self.node.height + 1
        # Before search_windows(): a re-stripe here fails the speculation
        # check below, whose windows were the world's before the hook.
        self._begin_block(height)
        data = self.payload_for(height)
        windows = _WindowSet(self.search_windows())
        if windows.get(0) is None:
            self._discard_speculative(pending, "error")
            raise RuntimeError("search_windows yielded no nonce windows")
        cands: dict[int, bytes] = {}
        if pending and not self._speculation_valid(pending, windows,
                                                   cands, data):
            self._draining += self._discard_speculative(pending,
                                                        "restripe")

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
        self._trace_records = trace_records = [d.prec.record
                                               for d in pending]
        tried = 0
        with trace_block(height), span("miner.block", height=height):
            while True:
                while cursor is not None and \
                        len(pending) < self.PIPELINE_DEPTH:
                    e, w = cursor
                    d = self._issue_sweep(
                        height, e, windows, w,
                        lambda e=e: self._candidate(cands, data, e),
                        backend)
                    pending.append(d)
                    trace_records.append(d.prec.record)
                    cursor = advance(e, w)
                d = pending.popleft()
                r = self._consume(d)
                self._count_sweep(backend, r.hashes_tried)
                tried += r.hashes_tried
                if r.nonce is not None:
                    res, win_d = r, d
                    break
                if windows.get(d.window_index + 1) is None:
                    # This template's whole window set came back empty:
                    # the shared rollover rule (config.extend_payload).
                    self._log({"event": "nonce_space_exhausted",
                               "height": height,
                               "extra_nonce": d.template + 1})
                    if d.template >= MAX_EXTRA_NONCE:
                        self._discard_speculative(pending, "error")
                        raise RuntimeError(
                            f"{MAX_EXTRA_NONCE} consecutive empty nonce "
                            f"spaces at height {height} — difficulty "
                            f"{self.config.difficulty_bits} is "
                            f"unsatisfiably high")
                    if cursor is None and not pending:
                        # The no-winner is confirmed now, so the next
                        # template is no longer a speculation.
                        cursor = (d.template + 1, 0)
            res = dataclasses.replace(res, hashes_tried=tried)
            # A winner falsifies every queued no-winner speculation.
            self._draining += self._discard_speculative(pending, "winner")
            if blocks_left > 1:
                # Issue the next block's first sweep from the winner's
                # digest, the prev_hash the C++ append is about to
                # install; it is re-validated at the next block boundary.
                nh, ndata = height + 1, self.payload_for(height + 1)
                nd = self._issue_sweep(
                    nh, 0, windows, 0,
                    lambda: core.make_candidate_header(
                        res.hash, ndata, nh, self.config.difficulty_bits),
                    backend)
                pending.append(nd)
                trace_records.append(nd.prec.record)
            with win_d.prec.segment("validate"):
                winner = core.set_nonce(win_d.cand, res.nonce)
            with span("miner.append", height=height), \
                    win_d.prec.segment("append"):
                accepted = self.node.submit(winner)
        if not accepted:
            self._discard_speculative(pending, "error")
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

    def chain_hashes(self) -> list[str]:
        return [self.node.block_hash(i).hex()
                for i in range(self.node.height + 1)]
