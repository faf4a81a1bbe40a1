"""``Miner.mine_chain`` behind the program's default backend
(``ResilientBackend``): one early-exit launch a block, the next block's
sweep issued speculatively from the winner's digest (``mine``)."""
from __future__ import annotations

from benchmark.mining import SingleDriver


class Pipelined(SingleDriver):
    def __init__(self, ctx):
        super().__init__(ctx)
        from mpi_blockchain_tpu_torch.models.miner import Miner

        self.miner = Miner(self.config(), log_fn=self.log)
        self.warm = int(ctx.cell.traffic["warmup_blocks"])
        self.span_blocks = ctx.blocks_for("span_nonces_pow2")
        self.trace_blocks = ctx.blocks_for("trace_nonces_pow2")

    def warmup(self) -> None:
        self.mine(self.warm)


def make(ctx):
    return Pipelined(ctx)
