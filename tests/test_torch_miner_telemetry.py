"""The port's ``Miner`` keeps the reference's telemetry and seams.

The same d12/n6 chain, mined on the C++ sweep by the reference's ``Miner``
and by the port's, sequential and pipelined, must leave the same values in
both registries: ``mining_rounds_total`` and ``hashes_tried_total`` by
backend, ``blocks_mined_total``, the ``block_latency_ms`` count, the
``miner_heartbeat`` height and ``speculative_discards_total`` by reason.
A payload hook that answers the speculative read of each height with a
stale template makes the pipelined driver discard (``restripe``) at every
block boundary, in both packages. Exact: these are counts.
"""
import collections

import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.backend.cpu import CpuBackend as RefCpuBackend
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner

torch.set_num_threads(1)

DIFFICULTY, BLOCKS = 12, 6
COUNTERS = ("mining_rounds_total", "hashes_tried_total",
            "blocks_mined_total", "speculative_discards_total")


def _quiet(_event):
    return None


def _snapshot(registry) -> dict:
    """The compared metrics: counters by labels, the latency histogram's
    count, the heartbeat's value."""
    out: dict = collections.defaultdict(dict)
    for m in registry.metrics():
        labels = tuple(sorted(dict(m.labels).items()))
        if m.name in COUNTERS:
            out[m.name][labels] = m.value
        elif m.name == "block_latency_ms":
            out[m.name][labels] = m.count
        elif m.name == "miner_heartbeat":
            out[m.name][labels] = m.value
    return dict(out)


def _stale_first_read(miner_cls):
    """``miner_cls`` whose first read of each height's payload is stale:
    the pipelined driver's speculative issue at the previous winner sees
    it, and the block boundary's fresh read discards that dispatch."""

    class Stale(miner_cls):
        def payload_for(self, height):
            self.reads = getattr(self, "reads", collections.Counter())
            self.reads[height] += 1
            if self.reads[height] == 1:
                return b"stale:%d" % height
            return super().payload_for(height)
    return Stale


@pytest.mark.parametrize("mode", ["sequential", "pipelined",
                                  "pipelined_restripe"])
def test_registry_after_a_chain_equals_the_references(mode):
    pipeline = mode != "sequential"
    ref_cls, port_cls = RefMiner, Miner
    if mode == "pipelined_restripe":
        ref_cls, port_cls = _stale_first_read(RefMiner), \
            _stale_first_read(Miner)
    ref_telemetry.reset()
    ref = ref_cls(RefConfig(difficulty_bits=DIFFICULTY, n_blocks=BLOCKS,
                            backend="cpu"),
                  backend=RefCpuBackend(), log_fn=_quiet, pipeline=pipeline)
    ref.mine_chain()
    want = _snapshot(ref_telemetry.default_registry())

    telemetry.reset()
    port = port_cls(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=BLOCKS,
                                backend="cpu"),
                    backend=CpuBackend(), pipeline=pipeline)
    port.mine_chain()
    got = _snapshot(telemetry.default_registry())

    assert port.chain_hashes() == ref.chain_hashes()
    assert got == want
    assert sum(want["blocks_mined_total"].values()) == BLOCKS
    assert sum(want["block_latency_ms"].values()) == BLOCKS
    if mode == "pipelined_restripe":
        # Every block after the first discards its stale speculation.
        assert want["speculative_discards_total"] == {
            (("reason", "restripe"),): BLOCKS - 1}
    else:
        assert "speculative_discards_total" not in want


def test_block_mined_hook_and_data_seam_match_the_reference():
    """``_block_mined`` runs after every append in both drivers, and
    ``mine_block(data=...)`` mines the given payload, as the
    reference's."""
    seen = {}
    for name, miner_cls, cfg_cls, kw in (
            ("ref", RefMiner, RefConfig, {"log_fn": _quiet}),
            ("port", Miner, MinerConfig, {})):
        backend = RefCpuBackend() if name == "ref" else CpuBackend()
        heights = []

        class Hooked(miner_cls):
            def _block_mined(self, rec):
                heights.append(rec.height)

        for pipeline in (False, True):
            miner = Hooked(cfg_cls(difficulty_bits=10, n_blocks=3,
                                   backend="cpu"),
                           backend=backend, pipeline=pipeline, **kw)
            miner.mine_chain()
            miner.mine_block(data=b"given payload")
            seen[(name, pipeline)] = (list(heights), miner.chain_hashes())
            heights.clear()
    for pipeline in (False, True):
        assert seen[("port", pipeline)] == seen[("ref", pipeline)]
        assert seen[("port", pipeline)][0] == [1, 2, 3, 4]
