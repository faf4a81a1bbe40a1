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

The reference's block tracing and profiler calls are not ported, as in
``models/miner.py``, nor its mesh (one device here). The recovery search
goes through ``backend_from_config``, the resilient backend: retries,
host re-validation and the step-down ladder, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import logging
from typing import Callable

import numpy as np
import torch

from .. import core
from ..backend import backend_from_config
from ..backend.cuda import resolve_device
from ..config import MAX_EXTRA_NONCE, ConfigError, MinerConfig, \
    extend_payload
from ..ops import resolve_kernel, sha256_block, sha256_cuda

_LOGGER = logging.getLogger("mpi_blockchain_tpu_torch")
NONCE_SPACE = 1 << 32


def _words_be(digest32: bytes) -> np.ndarray:
    """Digest bytes -> the 8 big-endian uint32 words (SHA state words)."""
    return np.frombuffer(digest32, ">u4").astype(np.uint32)


def sweep_cap(batch_pow2: int, max_rounds: int | None = None) -> int:
    """End of each block's sweep range [0, cap): the reference's round
    loop covers ``max_rounds`` rounds of 2^batch_pow2 nonces, or the whole
    nonce space, and never past 2^32."""
    if max_rounds is None:
        return NONCE_SPACE
    if max_rounds < 1:
        raise ConfigError(f"max_rounds must be >= 1, got {max_rounds}")
    return min(max_rounds << batch_pow2, NONCE_SPACE)


def make_fused_miner(k_blocks: int, batch_pow2: int, difficulty_bits: int,
                     *, kernel: str = "auto",
                     device: str | torch.device = "cuda",
                     max_rounds: int | None = None):
    """The k-block miner on ``device``.

    Returns ``fn(prev_words (8,), data_words (k, 8), start_height) ->
    (nonces (k,), tip_words (8,))``, uint32 tensors on ``device``; block j
    is mined at height start_height + j + 1. A block whose sweep range
    holds no qualifier gets the nonce 0xFFFFFFFF and the chain carries on
    from that header's digest, as in the reference; the host's validation
    rejects it (``FusedMiner._recover_block``). With the CUDA kernels
    ("auto" on a CUDA device) a call enqueues everything and synchronizes
    nothing; "torch" runs the plain step and sweep on ``device``.
    """
    device = resolve_device(device)
    kernel = resolve_kernel(kernel, device)
    cap = sweep_cap(batch_pow2, max_rounds)

    def fn(prev_words, data_words, start_height: int):
        if tuple(data_words.shape) != (k_blocks, 8):
            raise ValueError(f"data_words must have shape ({k_blocks}, 8), "
                             f"got {tuple(data_words.shape)}")
        mine = (sha256_block.mine_k if kernel == "cuda"
                else sha256_block.mine_k_plain)
        return mine(prev_words, data_words, int(start_height),
                    difficulty_bits, cap)

    return fn


class _Readback:
    """A call's nonces on their way to the host: a pinned buffer filled by
    a copy on the call's stream, and an event recorded after it."""

    def __init__(self, nonces: torch.Tensor):
        if nonces.device.type == "cpu":
            self.host, self.event = nonces, None
            return
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
    nonces: _Readback


class FusedMiner:
    """Chain driver over the fused k-block loop: the same chain as
    ``Miner`` (the lowest-nonce rule is unchanged), one host call per k
    blocks."""

    #: Most calls in flight: enough that the device never drains while the
    #: host validates, few enough that a validation failure wastes at most
    #: a few stale calls of device work.
    PIPELINE_DEPTH = 4

    def __init__(self, config: MinerConfig, blocks_per_call: int = 16,
                 recovery_backend=None):
        if blocks_per_call < 1:
            raise ConfigError(
                f"blocks_per_call must be >= 1, got {blocks_per_call}")
        if config.backend != "cuda" or config.n_miners != 1:
            raise ConfigError(
                f"the fused miner runs the cuda backend on one device, not "
                f"backend={config.backend!r} with n_miners="
                f"{config.n_miners}")
        self.config = config
        self.device = resolve_device(config.device)
        self.effective_kernel = resolve_kernel(config.kernel, self.device)
        self.node = core.Node(config.difficulty_bits)
        self.blocks_per_call = blocks_per_call
        self._fns: dict[int, Callable] = {}
        # Per-block backend for the nonce-exhaustion rollover; built lazily
        # (the path is all but unreachable below difficulty ~34). Tests
        # inject one to stage an exhaustion.
        self._recovery = recovery_backend
        #: Host waits for the device so far: one per call on a CUDA device.
        self.host_waits = 0

    @staticmethod
    def _log(event: dict) -> None:
        _LOGGER.debug("%s", json.dumps(event, sort_keys=True))

    def _fn(self, k: int):
        fn = self._fns.get(k)
        if fn is None:
            fn = self._fns[k] = make_fused_miner(
                k, self.config.effective_batch_pow2,
                self.config.difficulty_bits, kernel=self.effective_kernel,
                device=self.device)
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
        ``on_progress(height)`` runs after each appended span."""
        n = n_blocks if n_blocks is not None else self.config.n_blocks
        while n > 0:
            mined = self._mine_span(n)
            n -= mined
            if on_progress is not None and mined:
                on_progress(self.node.height)

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        """uint32 words as a tensor on the run's device; to a card through a
        pinned buffer, without a host sync."""
        t = torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _mine_span(self, n: int) -> int:
        """Enqueues ceil(n / blocks_per_call) calls back to back, at most
        ``PIPELINE_DEPTH`` in flight, and validates and appends batch by
        batch. Call i + 1's prev_hash is call i's tip tensor, so calls
        queue with no host round trip between them.

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
            payloads = [self.config.payload(height + j + 1)
                        for j in range(k)]
            data = np.stack([_words_be(core.sha256d(p)) for p in payloads])
            nonces, prev = self._fn(k)(prev, self._to_device(data), height)
            batches.append(_Batch(height, payloads, _Readback(nonces)))
            height += k
            remaining -= k

        while remaining > 0 and len(batches) < self.PIPELINE_DEPTH:
            dispatch_one()
        while batches:
            batch = batches.popleft()
            self.host_waits += batch.nonces.event is not None
            nonces = batch.nonces.wait()
            if remaining > 0:
                dispatch_one()
            for j, payload in enumerate(batch.payloads):
                cand = self.node.make_candidate(payload)
                if not self.node.submit(core.set_nonce(cand, nonces[j])):
                    # The calls still in flight mined on a tip that is now
                    # wrong; their results are dropped.
                    self._recover_block(batch.height + j + 1, nonces[j])
                    return self.node.height - start
                self._log({"event": "block_mined", "backend": "cuda-fused",
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
            self._recovery = backend_from_config(self.config)
        return self._recovery

    @property
    def recovery(self):
        """The rollover search's backend, or None if no block has needed
        it yet."""
        return self._recovery

    def chain_hashes(self) -> list[str]:
        return [self.node.block_hash(i).hex()
                for i in range(self.node.height + 1)]
