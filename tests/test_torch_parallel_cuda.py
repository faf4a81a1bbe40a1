"""Winner-select and the wedged-dispatch bound on the card: a
``tpu-mesh8``-shaped chain (8 logical miners) at d16 against the C++
oracle, through both drivers, with the reference's round accounting; and a
sweep wedged on the card failing the pipelined ``Miner`` within its budget
while a later search still returns the right winner.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_parallel_cuda.py
"""
import time

import pytest
import torch

from mpi_blockchain_tpu_torch import core
from mpi_blockchain_tpu_torch.backend import backend_from_config
from mpi_blockchain_tpu_torch.backend.cuda import reference_hashes_tried
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models import miner as miner_mod
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_cuda

pytestmark = pytest.mark.cuda

NONCE_SPACE = 1 << 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _oracle(d: int, n: int) -> Miner:
    oracle = Miner(MinerConfig(difficulty_bits=d, n_blocks=n, backend="cpu"))
    oracle.mine_chain()
    return oracle


def test_mesh8_shaped_chain_matches_the_cpu_oracle():
    _card()
    cfg = MinerConfig(difficulty_bits=16, n_blocks=20, batch_pow2=14,
                      n_miners=8)
    oracle = _oracle(16, 20)
    sha256_cuda.launches = 0
    miner = Miner(cfg)
    miner.mine_chain()
    assert sha256_cuda.launches == 20
    assert miner.node.save() == oracle.node.save()
    assert [r.hashes_tried for r in miner.records] == [
        reference_hashes_tried(0, NONCE_SPACE, 8 << 14, r.nonce)
        for r in oracle.records]
    fused = FusedMiner(cfg, blocks_per_call=7)
    fused.mine_chain()
    assert fused.node.save() == oracle.node.save()


def test_wedged_sweep_fails_the_miner_within_its_budget(monkeypatch):
    """An early-exit sweep of [0, 2^32) at dbits 64 runs its whole length
    (about half a second on an H100); consumed with a 0.05 s budget it
    raises "dispatch wedged" long before it ends, and a search started
    after it returns the C++ sweep's winner."""
    _card()
    monkeypatch.setattr(miner_mod, "DISPATCH_TIMEOUT_S", 0.05)
    miner = Miner(MinerConfig(difficulty_bits=64, n_blocks=1,
                              batch_pow2=20), pipeline=True)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="dispatch wedged"):
        miner.mine_chain()
    took = time.perf_counter() - t0
    assert 0.05 <= took < 0.3, took
    backend = backend_from_config(MinerConfig(difficulty_bits=16))
    hdr = bytes(range(80))
    got = backend.search(hdr, 16)
    nonce, tried = core.cpu_search(hdr, 0, NONCE_SPACE, 16)
    assert (got.nonce, got.hash) == (
        nonce, core.header_hash(core.set_nonce(hdr, nonce)))
    torch.cuda.synchronize()
