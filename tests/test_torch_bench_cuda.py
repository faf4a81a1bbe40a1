"""The bench library on the card: ``bench_cuda`` at 2^24 a call for one
second, its rate, its median CUDA-event time of one call and the bound
from the function's work; ``bench_chain`` at a small size against the C++
oracle.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_bench_cuda.py
"""
import pytest
import torch

from mpi_blockchain_tpu_torch import bench_lib
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n_miners", [1, 8])
def test_bench_cuda_rate_time_and_bound(n_miners):
    _card()
    out = bench_lib.bench_cuda(seconds=1.0, batch_pow2=24,
                               n_miners=n_miners)
    assert out["kernel"] == "cuda" and out["platform"] == "cuda"
    # N x 2^24 divides 2^32: every call is whole.
    assert out["hashes"] == out["calls"] * (n_miners << 24)
    assert out["hashes_per_sec"] > 0 and out["kernel_ms"] > 0
    # The bound is a floor: no call beats it.
    assert 0 < out["bound_ms"] <= out["kernel_ms"]
    if n_miners > 1:
        assert sum(r["hashes"] for r in out["per_rank"]) == out["hashes"]


def test_bench_chain_on_the_card_matches_the_cpu_oracle():
    _card()
    out = bench_lib.bench_chain(n_blocks=12, difficulty_bits=14,
                                batch_pow2=16, blocks_per_call=5)
    oracle = Miner(MinerConfig(difficulty_bits=14, n_blocks=12,
                               backend="cpu"))
    oracle.mine_chain()
    assert out["tip_hash"] == oracle.node.tip_hash.hex()
