"""``FusedMiner.mine_chain``: k blocks a host call, each next header built
on the card (``mine --fused``)."""
from __future__ import annotations

from benchmark.mining import SingleDriver


class Fused(SingleDriver):
    def __init__(self, ctx):
        super().__init__(ctx)
        from mpi_blockchain_tpu_torch.models.fused import FusedMiner

        self.k = int(ctx.cell.traffic["blocks_per_call"])
        self.miner = FusedMiner(self.config(), blocks_per_call=self.k,
                                log_fn=self.log)
        self.span_blocks = ctx.blocks_for("span_nonces_pow2", self.k)
        self.trace_blocks = ctx.blocks_for("trace_nonces_pow2", self.k)

    def warmup(self) -> None:
        # The library built or loaded, the k-block program and the sweep's
        # occupancy resolved, then one k-block call of the cell's own.
        self.miner.warmup()
        self.mine(self.k)


def make(ctx):
    return Fused(ctx)
