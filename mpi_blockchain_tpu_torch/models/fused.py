"""The fused k-block miner: k blocks per host call, each next header built
on the card.

Twin of the reference's ``models/fused.py``. The per-block path
(``models/miner.py``) pays a host round trip for every block: midstate,
launch, read-back, append. Here one host call mines k blocks on the device:

    for each of the k blocks (all enqueued on one stream, one host call):
      step kernel: finalize the block before (its lowest winner from the
        sweep's result buffer, its header's double hash, the new prev_hash),
        build this block's header template and extended midstate, reset
        the result buffer
      copy the extended midstate into the sweep's __constant__ symbol
      early-exit sweep of [0, cap): the lowest qualifying nonce
    final step kernel: finalize the last block into the tip words

The C++ Node then re-validates and appends each block (proof of work,
linkage, timestamp), so the chain state and the trust boundary stay in C++
as in the per-block path. Calls are pipelined: call i + 1 takes call i's
tip tensor as its prev_hash, on the same stream, and call i's nonces come
back through a pinned host buffer and a CUDA event, so the host validates
batch i while later calls run. A k-block call synchronizes nothing; the
host waits once per call, for its nonces.

With ``n_miners`` N > 1 in one process (the reference's mesh of N
devices), a round covers N x B nonces and each block's sweep range ends
at the last whole round below 2^32, as the reference's round loop does;
the lowest-nonce winner does not depend on N, so the launches do not
change.

In a world of N processes (``group``, a ``torch.distributed`` group of N
ranks: ``mine --fused --coordinator``) the reference's collective inside
the k-block loop is gloo's, on the host, so the host drives each call a
round at a time (``_WorldCall``): the step kernel builds each header on
the card as above; rank i sweeps its slice [r N B + i B, + B) of round r
with the constant-ext sweep into a result buffer of its own (or, with
no slice in the round, launches nothing: ``world_slices``), reads back
its (count, min) and runs ``winner_select`` over the group; the first
round whose summed count is above 0 ends the block, and the selected
(count, min), the same on every rank, is copied into the step's result
buffer, from which the next step finalizes the block. A block with no
qualifier below the cap keeps the reset 0xFFFFFFFF. Every branch (next
round, next block, recovery, rollover) is taken on selected values only,
so every rank takes it. Call i + 1 needs call i's tip, which needs call
i's last winner-select, so one call is in flight: call i + 1's first
step and slice go on the card before the host validates and appends
call i, and its rounds run when it is waited for. The recovery search is
the world's (``backend_from_config(..., group=)``), as the reference's
is its mesh's.

Tracing, as in the reference: one ``meshwatch.pipeline`` dispatch record
per k-block call (``kind="fused"``, its height and k). Its ``enqueue``
segment covers the input build and the call; its ``device`` window opens
when the call returns (in a world, when its first slice was launched)
and closes when the call's nonces are on the host (``wait``), the
reference's own definition (its window closes when the call's value
materializes). In a world each round's winner-select is a
``skew_span(site="mesh.sweep")``, as in the per-block world. Each block's
``validate`` and ``append`` segments, and its records (``block_mined``
through ``log_fn``, by default the event stream), are made in that
block's ``trace_block`` frame, so each block of a call keeps its own
and its records carry its trace stamp; a recovery bail-out strips the
block identity of the calls it abandons (``strip_block_identity``); and
``observe_batch_metrics`` observes the span's blocks after the
``on_progress`` seam. The first use of each k-block program is a compile
in the ``dispatchwatch`` census (site ``fused``). The spans are:
``fused.dispatch`` around the enqueue of a k-block call, ``miner.append``
around each C++ append. The recovery search goes through
``backend_from_config``, the resilient backend: retries, host
re-validation and the step-down ladder, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import core
from ..backend import backend_from_config
from ..backend.cuda import resolve_device
from ..blocktrace import trace_block
from ..blocktrace.critical_path import observe_batch_metrics
from ..config import MAX_EXTRA_NONCE, ConfigError, MinerConfig, \
    extend_payload
from ..dispatchwatch import compile_scope, current_site, note_cache, \
    record_compile
from ..meshprof.spans import skew_span
from ..meshwatch.pipeline import profiler, strip_block_identity
from ..ops import resolve_kernel, sha256_block, sha256_cuda
from ..parallel.mesh import winner_select
from ..telemetry.spans import span
from ..utils.logging import block_logger

NONCE_SPACE = 1 << 32
_NOT_FOUND = 0xFFFFFFFF


def _words_be(digest32: bytes) -> np.ndarray:
    """Digest bytes -> the 8 big-endian uint32 words (SHA state words)."""
    return np.frombuffer(digest32, ">u4").astype(np.uint32)


def sweep_cap(batch_pow2: int, max_rounds: int | None = None,
              n_miners: int = 1) -> int:
    """End of each block's sweep range [0, cap): the reference's round
    loop covers ``max_rounds`` rounds of n_miners x 2^batch_pow2 nonces,
    or every whole round below 2^32, and never past 2^32."""
    round_size = n_miners << batch_pow2
    if max_rounds is None:
        max_rounds = NONCE_SPACE // round_size
    elif max_rounds < 1:
        raise ConfigError(f"max_rounds must be >= 1, got {max_rounds}")
    return min(min(max_rounds, 0xFFFFFFFF) * round_size, NONCE_SPACE)


@dataclasses.dataclass(frozen=True)
class WorldSlices:
    """One rank's slices of a block's sweep of [0, cap) in a world of
    ``n_miners`` ranks: round r covers [r N B, (r + 1) N B), and rank i's
    slice of it is [r N B + i B, + B). Every rank has the same number of
    rounds, ceil(cap / N B), so every rank enters every winner-select of a
    block; where a rank's slice of the last round starts at or past
    ``cap`` (``sweep_cap`` clamps ``cap`` to 2^32, which a round need not
    divide), ``start`` is None: the rank launches nothing and brings
    (0, 0xFFFFFFFF) to the select. Together the ranks' slices tile
    [0, cap): ``sweep_cap`` gives a multiple of B."""

    rank: int
    n_miners: int
    batch: int
    cap: int

    def __len__(self) -> int:
        return -(-self.cap // (self.n_miners * self.batch))

    def start(self, r: int) -> int | None:
        """The first nonce of this rank's slice of round r, or None."""
        base = (r * self.n_miners + self.rank) * self.batch
        return base if base < self.cap else None


def world_slices(rank: int, n_miners: int, batch_pow2: int,
                 cap: int) -> WorldSlices:
    """The round plan of rank ``rank`` of a fused world (``WorldSlices``)."""
    return WorldSlices(rank, n_miners, 1 << batch_pow2, cap)


def make_fused_miner(k_blocks: int, batch_pow2: int, difficulty_bits: int,
                     *, kernel: str = "auto",
                     device: str | torch.device = "cuda",
                     max_rounds: int | None = None, n_miners: int = 1,
                     group=None):
    """The k-block miner on ``device``.

    Returns ``fn(prev_words (8,), data_words (k, 8), start_height) ->
    (nonces (k,), tip_words (8,))``, uint32 tensors on ``device``; block j
    is mined at height start_height + j + 1. A block whose sweep range
    holds no qualifier gets the nonce 0xFFFFFFFF and the chain carries on
    from that header's digest, as in the reference; the host's validation
    rejects it (``FusedMiner._recover_block``). With the CUDA kernels
    ("auto" on a CUDA device) a call enqueues everything and synchronizes
    nothing; "torch" runs the plain step and sweep on ``device``.

    With ``group``, a process group of ``n_miners`` ranks, this process is
    one rank of a world: ``fn`` starts a ``_WorldCall`` and returns it in
    place of the nonces (its ``wait`` gives them) beside the tip tensor,
    which holds the tip once the call was waited for. On a card the world
    runs the CUDA kernels; "torch" there is refused.
    """
    device = resolve_device(device)
    kernel = resolve_kernel(kernel, device)
    cap = sweep_cap(batch_pow2, max_rounds, n_miners)

    def check(data_words) -> None:
        if tuple(data_words.shape) != (k_blocks, 8):
            raise ValueError(f"data_words must have shape ({k_blocks}, 8), "
                             f"got {tuple(data_words.shape)}")

    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
        if world != n_miners:
            raise ConfigError(
                f"the process group has {world} ranks but n_miners="
                f"{n_miners}: the round split must match the world")
        if device.type == "cuda" and kernel != "cuda":
            raise ConfigError(
                f"a fused world on a card runs the CUDA kernels, not "
                f"kernel={kernel!r}")
        slices = world_slices(dist.get_rank(group), n_miners, batch_pow2,
                              cap)

        def world_fn(prev_words, data_words, start_height: int):
            check(data_words)
            call = _WorldCall(prev_words, data_words, int(start_height),
                              difficulty_bits, slices, group)
            return call, call.tip

        return world_fn

    def fn(prev_words, data_words, start_height: int):
        check(data_words)
        mine = (sha256_block.mine_k if kernel == "cuda"
                else sha256_block.mine_k_plain)
        return mine(prev_words, data_words, int(start_height),
                    difficulty_bits, cap)

    return fn


class _WorldCall:
    """One rank's k-block call in a world of processes, driven from the
    host a round at a time (see the module's docstring). Made, it has put
    the first block's step and this rank's slice of its first round on
    the card (``opened``: when that slice was launched, on
    ``time.perf_counter``); ``wait`` runs the rounds and winner-selects of
    every block and the final step, and gives the selected nonces, the
    same on every rank. ``waits`` counts the slices' read-backs from a
    card; ``event`` is None (nothing is left to wait for after
    ``wait``)."""

    event = None

    def __init__(self, prev: torch.Tensor, data: torch.Tensor,
                 start_height: int, difficulty_bits: int,
                 slices: WorldSlices, group):
        device = prev.device
        k = data.shape[0]
        self.data, self.height, self.bits = data, start_height, \
            difficulty_bits
        self.slices, self.group = slices, group
        self.on_card = device.type == "cuda"
        self.waits = 0
        # The first step builds a block, which resets the result buffer.
        self.scratch = torch.empty(sha256_block.SCRATCH_WORDS,
                                   dtype=torch.int32, device=device)
        self.nonces = torch.empty(k, dtype=torch.uint32, device=device)
        self.tip = torch.empty(8, dtype=torch.uint32, device=device)
        sha256_block.step(self.scratch, prev=prev, data=data[0],
                          height=start_height + 1,
                          difficulty_bits=difficulty_bits)
        self.opened = time.perf_counter()
        self._first = self._slice(0)

    def _slice(self, r: int):
        """Starts this rank's slice of round r of the block at hand; None
        when the rank has no slice in it (or the block no round)."""
        start = self.slices.start(r)
        if start is None:
            return None
        return sha256_block.slice_launch(self.scratch, start,
                                         self.slices.batch, self.bits)

    def _select(self, read) -> tuple[int, int]:
        """Waits for this rank's slice (``read``; None: no slice this
        round, (0, 0xFFFFFFFF)) and selects the round's winner over the
        group."""
        # The skew span stamps this rank's arrival at the round whose
        # epilogue is the winner-select rendezvous.
        with skew_span(site="mesh.sweep"):
            local = (0, _NOT_FOUND)
            if read is not None:
                local = read()
                self.waits += self.on_card
            return winner_select(*local, self.group)

    def wait(self) -> list[int]:
        k = self.data.shape[0]
        read = self._first
        nonces = []
        for j in range(k):
            best = _NOT_FOUND
            for r in range(len(self.slices)):
                count, best = self._select(read if r == 0
                                           else self._slice(r))
                if count > 0:
                    sha256_block.put_result(self.scratch, count, best)
                    break
            nonces.append(best)
            last = j + 1 == k
            sha256_block.step(
                self.scratch, data=None if last else self.data[j + 1],
                height=self.height + j + 2, difficulty_bits=self.bits,
                nonce_out=self.nonces[j:j + 1],
                tip_out=self.tip if last else None)
            if not last:
                read = self._slice(0)
        return nonces


class _Readback:
    """A call's nonces on their way to the host: a pinned buffer filled by
    a copy on the call's stream, and an event recorded after it."""

    def __init__(self, nonces: torch.Tensor):
        if nonces.device.type == "cpu":
            self.host, self.event, self.waits = nonces, None, 0
            return
        self.waits = 1
        self.host = torch.empty(nonces.shape, dtype=nonces.dtype,
                                pin_memory=True)
        self.host.copy_(nonces, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(nonces.device))

    def wait(self) -> list[int]:
        """The nonces; a CUDA error reported at the wait (a kernel of the
        call that faulted) raises ``KernelError``."""
        if self.event is not None:
            with sha256_cuda.kernel_errors("the fused call's read-back"):
                self.event.synchronize()
        return self.host.tolist()


@dataclasses.dataclass
class _Batch:
    height: int              # chain height the call started from
    payloads: list[bytes]
    nonces: _Readback | _WorldCall
    prec: object             # the call's pipeline record
    t_issue: float           # when the call returned (profiler clock)


class FusedMiner:
    """Chain driver over the fused k-block loop: the same chain as
    ``Miner`` (the lowest-nonce rule is unchanged), one host call per k
    blocks. With ``group`` this process is one rank of a world of
    ``config.n_miners`` processes (``_WorldCall``)."""

    #: Most calls in flight: enough that the device never drains while the
    #: host validates, few enough that a validation failure wastes at most
    #: a few stale calls of device work.
    PIPELINE_DEPTH = 4

    def __init__(self, config: MinerConfig, blocks_per_call: int = 16,
                 recovery_backend=None, group=None,
                 log_fn: Callable[[dict], None] | None = None):
        if blocks_per_call < 1:
            raise ConfigError(
                f"blocks_per_call must be >= 1, got {blocks_per_call}")
        if config.backend != "cuda":
            raise ConfigError(
                f"the fused miner runs the cuda backend, not "
                f"backend={config.backend!r}")
        if config.n_miners < 1:
            raise ConfigError(
                f"n_miners must be >= 1, got {config.n_miners}")
        self.config = config
        self.device = resolve_device(config.device)
        self.effective_kernel = resolve_kernel(config.kernel, self.device)
        self.node = core.Node(config.difficulty_bits)
        self.blocks_per_call = blocks_per_call
        self._group = group
        # A world's call i + 1 starts from call i's selected winners.
        self.pipeline_depth = self.PIPELINE_DEPTH if group is None else 1
        # Where the block_mined and nonce_space_exhausted records go: by
        # default the event stream (INFO on stderr, and ringed).
        self._log = log_fn if log_fn is not None else block_logger()
        self._fns: dict[int, Callable] = {}
        # Per-block backend for the nonce-exhaustion rollover; built lazily
        # (the path is all but unreachable below difficulty ~34). Tests
        # inject one to stage an exhaustion.
        self._recovery = recovery_backend
        #: Host waits for the device so far: one per call on a CUDA
        #: device, one per round's read-back in a world on a card.
        self.host_waits = 0

    def _fn(self, k: int):
        """The cached k-block program. Its first use is one compile in
        the census (site ``fused``), and the cache's size is noted, so
        ``compiles == cache_entries`` holds while no k is built twice."""
        fn = self._fns.get(k)
        if fn is None:
            with compile_scope(site="fused"):
                t0 = time.perf_counter()
                fn = self._fns[k] = make_fused_miner(
                    k, self.config.effective_batch_pow2,
                    self.config.difficulty_bits,
                    kernel=self.effective_kernel, device=self.device,
                    n_miners=self.config.n_miners, group=self._group)
                record_compile(site=current_site(), stage="program",
                               duration_s=time.perf_counter() - t0)
            note_cache(site="fused", entries=len(self._fns))
        return fn

    def warmup(self, k: int | None = None) -> None:
        """Makes the k-block program ready before a timed run: builds the
        kernel library and resolves the constant-ext sweep's occupancy
        (its resident grid), so the first call compiles and queries
        nothing."""
        self._fn(k if k is not None else self.blocks_per_call)
        if self.effective_kernel == "cuda":
            sha256_cuda.occupancy(self.config.difficulty_bits, self.device,
                                  ext_from_symbol=True)

    def mine_chain(self, n_blocks: int | None = None,
                   on_progress: Callable[[int], None] | None = None) -> None:
        """Mines n_blocks; validates and appends every block in C++.
        ``on_progress(height)`` runs after each appended span, in the
        newest block's trace frame (its checkpoint segment joins that
        block); the span's blocks are observed after it."""
        n = n_blocks if n_blocks is not None else self.config.n_blocks
        while n > 0:
            start = self.node.height
            mined = self._mine_span(n)
            n -= mined
            if on_progress is not None and mined:
                with trace_block(self.node.height):
                    on_progress(self.node.height)
            if mined:
                # One grouping pass over the span's own records: a record
                # a call, at most one more for a recovery, plus the
                # checkpoint's.
                observe_batch_metrics(
                    [start + j + 1 for j in range(mined)],
                    profiler().records(tail=mined + 8))

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        """uint32 words as a tensor on the run's device; to a card through a
        pinned buffer, without a host sync."""
        t = torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _mine_span(self, n: int) -> int:
        """Enqueues ceil(n / blocks_per_call) calls back to back, at most
        ``pipeline_depth`` in flight, and validates and appends batch by
        batch. Call i + 1's prev_hash is call i's tip tensor, so calls
        queue with no host round trip between them (in a world, call i + 1
        starts after call i was waited for, before its validation).

        Returns the number of blocks appended: short only when a block
        fails C++ validation. That height is then re-mined through the
        extra-nonce rollover (or diagnosed as a kernel bug), the calls
        still in flight are dropped, and the caller's loop starts again
        from the new tip."""
        start = self.node.height
        prev = self._to_device(_words_be(self.node.tip_hash))
        batches: collections.deque[_Batch] = collections.deque()
        height, remaining = start, n

        def dispatch_one() -> None:
            nonlocal prev, height, remaining
            k = min(remaining, self.blocks_per_call)
            prec = profiler().dispatch(kind="fused", height=height, k=k)
            with prec.segment("enqueue"):
                payloads = [self.config.payload(height + j + 1)
                            for j in range(k)]
                data = np.stack([_words_be(core.sha256d(p))
                                 for p in payloads])
                with span("fused.dispatch", k=k, height=height):
                    nonces, prev = self._fn(k)(prev, self._to_device(data),
                                               height)
            if isinstance(nonces, _WorldCall):
                readback, t_issue = nonces, prec.at(nonces.opened)
            else:
                readback, t_issue = _Readback(nonces), prec.now()
            batches.append(_Batch(height, payloads, readback, prec,
                                  t_issue))
            height += k
            remaining -= k

        while remaining > 0 and len(batches) < self.pipeline_depth:
            dispatch_one()
        while batches:
            batch = batches.popleft()
            prec = batch.prec
            nonces = batch.nonces.wait()
            self.host_waits += batch.nonces.waits
            prec.add_segment("device", batch.t_issue, prec.now())
            if remaining > 0:
                dispatch_one()
            for j, payload in enumerate(batch.payloads):
                # Each block's frame: its validate and append segments in
                # the call's record stay its own in the critical path, and
                # its records carry its trace stamp.
                with trace_block(batch.height + j + 1):
                    with prec.segment("validate"):
                        cand = self.node.make_candidate(payload)
                        winner = core.set_nonce(cand, nonces[j])
                    with span("miner.append", height=batch.height + j + 1), \
                            prec.segment("append"):
                        accepted = self.node.submit(winner)
                    if not accepted:
                        # The calls still in flight mined on a tip that is
                        # now wrong; their results are dropped. Their
                        # heights will be mined again, so their records
                        # lose the block identity (this call keeps the j
                        # blocks it appended, and its exact per-block
                        # segments).
                        strip_block_identity(prec.record, keep_k=j)
                        for stale in batches:
                            strip_block_identity(stale.prec.record)
                        self._recover_block(batch.height + j + 1, nonces[j])
                        return self.node.height - start
                    self._log({"event": "block_mined",
                               "backend": "cuda-fused",
                               "height": batch.height + j + 1,
                               "nonce": nonces[j],
                               "hash": self.node.tip_hash.hex()})
        return self.node.height - start

    def _recover_block(self, height: int, device_nonce: int) -> None:
        """A device block failed C++ validation. Either the sweep range
        holds no qualifier (the device cannot say "not found" in band: its
        sentinel nonce just fails proof of work here), or the kernel is
        wrong. The per-block re-search tells them apart: a winner in the
        extra_nonce=0 space means the device missed it (a kernel bug:
        raise); otherwise roll over through fresh spaces as
        ``Miner.mine_block`` does, so the chain stays identical."""
        data = self.config.payload(height)
        for extra_nonce in range(MAX_EXTRA_NONCE + 1):
            cand = self.node.make_candidate(extend_payload(data, extra_nonce))
            res = self._recovery_backend().search(
                cand, self.config.difficulty_bits)
            if res.nonce is None:
                self._log({"event": "nonce_space_exhausted",
                           "height": height, "extra_nonce": extra_nonce + 1})
                continue
            if extra_nonce == 0:
                raise RuntimeError(
                    f"fused device loop missed a qualifying nonce at height "
                    f"{height}: device returned {device_nonce:#010x}, "
                    f"re-search found {res.nonce:#010x} — kernel bug, not "
                    f"exhaustion")
            if not self.node.submit(core.set_nonce(cand, res.nonce)):
                raise RuntimeError(
                    f"rollover block failed validation at height {height} "
                    f"(extra_nonce {extra_nonce}, nonce {res.nonce:#010x})")
            self._log({"event": "block_mined",
                       "backend": "cuda-fused/rollover", "height": height,
                       "extra_nonce": extra_nonce, "nonce": res.nonce,
                       "hash": self.node.tip_hash.hex()})
            return
        raise RuntimeError(
            f"{MAX_EXTRA_NONCE} consecutive empty nonce spaces at height "
            f"{height} — difficulty {self.config.difficulty_bits} is "
            f"unsatisfiably high")

    def _recovery_backend(self):
        if self._recovery is None:
            self._recovery = backend_from_config(self.config,
                                                 group=self._group)
        return self._recovery

    @property
    def recovery(self):
        """The rollover search's backend, or None if no block has needed
        it yet."""
        return self._recovery

    def chain_hashes(self) -> list[str]:
        return [self.node.block_hash(i).hex()
                for i in range(self.node.height + 1)]
