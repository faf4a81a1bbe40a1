"""What every driver shares: the program's miner configured from the cell,
the blocks it logs, and its chain read back from the node.

A driver (``drivers/<name>.py``) has ``make(ctx)`` and gives an object
with ``span_blocks`` and ``trace_blocks`` (blocks a span of the window
and of the traced sub-window), ``device``, and ``warmup()``,
``mine(n) -> [Block]``, ``agree(go) -> bool`` (rank 0's go-ahead in a
world), ``memory_peak()``, ``chain()``, ``block_hashes()``,
``finish(rank) -> [Rank]`` (every rank's, rank 0's first) and
``close()``.
"""
from __future__ import annotations

import time

from .harness import Block, Ctx


class SingleDriver:
    """A driver of one process on one device."""

    def __init__(self, ctx: Ctx):
        import torch

        self.ctx = ctx
        self.device = torch.device("cpu")
        if ctx.device == "cuda":
            # A rank's card (``cuda:<rank % count>``, as ``mine`` takes it).
            self.device = torch.device(
                "cuda", ctx.rank % torch.cuda.device_count())
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.blocks: list[Block] = []
        self._extra: dict[int, int] = {}
        self.miner = None

    def config(self, **over):
        """The program's ``MinerConfig`` for this cell and seed."""
        from mpi_blockchain_tpu_torch.config import MinerConfig

        conf = self.ctx.cell.config
        fields = dict(difficulty_bits=int(conf["difficulty_bits"]),
                      batch_pow2=int(conf["batch_pow2"]), backend="cuda",
                      kernel="auto", device=self.ctx.device,
                      data_prefix=self.ctx.prefix)
        fields.update(over)
        return MinerConfig(**fields)

    def log(self, rec: dict) -> None:
        """The program's ``log_fn`` seam: one record per appended block
        (``block_mined``) and per empty nonce space."""
        event = rec.get("event")
        if event == "nonce_space_exhausted":
            self._extra[rec["height"]] = rec["extra_nonce"]
        elif event == "block_mined":
            h = rec["height"]
            extra = rec.get("extra_nonce", self._extra.pop(h, 0))
            self.blocks.append(Block(h, rec["nonce"], extra,
                                     time.perf_counter()))

    def mine(self, n: int) -> list[Block]:
        mark = len(self.blocks)
        self.miner.mine_chain(n)
        return self.blocks[mark:]

    def agree(self, go: bool) -> bool:
        return go

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def chain(self) -> bytes:
        return self.miner.node.save()

    def block_hashes(self) -> list[bytes]:
        node = self.miner.node
        return [node.block_hash(i) for i in range(node.height + 1)]

    def finish(self, rank) -> list:
        return [rank]

    def close(self) -> None:
        pass
