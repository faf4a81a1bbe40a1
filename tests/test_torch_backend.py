"""The port's CUDA backend (on the CPU device) against the reference's
``TpuBackend(kernel="jnp")``: the same ``SearchResult`` (nonce, digest and
``hashes_tried``) over random headers, starts and ranges, including ranges
whose end lies past the last full round below 2^32, which the reference
hands to the C++ ``cpu_search``.
"""
import numpy as np
import pytest
import torch

from mpi_blockchain_tpu.backend.tpu import TpuBackend
from mpi_blockchain_tpu_torch import core
from mpi_blockchain_tpu_torch.backend import backend_from_config, \
    get_backend
from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
from mpi_blockchain_tpu_torch.backend.cuda import CudaBackend, \
    reference_hashes_tried
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

POW2 = 13
R = 1 << POW2
TOP = 1 << 32


@pytest.fixture(scope="module")
def backends():
    return (CudaBackend(batch_pow2=POW2, device="cpu"),
            TpuBackend(batch_pow2=POW2, kernel="jnp"))


def _fields(res):
    return res.nonce, res.hash, res.hashes_tried


_CASES = [  # (start, max_count, dbits)
    (0, TOP, 10),                 # found in a later round
    (5, 100, 16),                 # empty, range inside one round
    (123456, 3 * R + 77, 12),     # clipped last round
    (TOP - R - 100, TOP, 8),      # one device round, then a CPU tail
    (TOP - 3 * R + 17, 5 * R, 13),  # rounds then a tail, often empty
    (0xFFFFE000 + 5, TOP, 6),     # no full round fits: all tail
    (TOP - 1, 1, 0),              # the last nonce alone
    (TOP - 2 * R, 2 * R, 9),      # ends exactly at 2^32
    (77, 0, 8),                   # empty range
]


@pytest.mark.parametrize("start,max_count,dbits", _CASES)
def test_search_result_matches_tpu_backend(backends, start, max_count,
                                           dbits):
    port, ref = backends
    rng = np.random.default_rng(start % 1000 + dbits)
    for _ in range(2):
        hdr = rng.integers(0, 256, size=80, dtype=np.uint8).tobytes()
        got = port.search(hdr, dbits, start, max_count)
        assert _fields(got) == _fields(ref.search(hdr, dbits, start,
                                                  max_count))
        oracle, _ = core.cpu_search(hdr, start, max_count, dbits)
        assert got.nonce == oracle


def test_hashes_tried_accounting_by_hand():
    # Winner in round 2 of a range starting at 10: two full rounds + up to
    # the clip of the third.
    assert reference_hashes_tried(10, 10 + 5 * R, R, 10 + 2 * R + 3) == 3 * R
    # The last round is clipped at the end of the range.
    assert reference_hashes_tried(0, R + 7, R, None) == R + 7
    # No round fits below 2^32: the CPU tail counts up to the winner.
    assert reference_hashes_tried(TOP - 10, TOP, R, TOP - 4) == 7
    assert reference_hashes_tried(TOP - 10, TOP, R, None) == 10
    # One round, then a tail of 5 with its winner at its second nonce.
    start = TOP - R - 5
    assert reference_hashes_tried(start, TOP, R, TOP - 4) == R + 2
    assert reference_hashes_tried(3, 3, R, None) == 0


def test_kernel_and_device_policy(monkeypatch):
    with pytest.raises(ConfigError, match="needs a CUDA device"):
        CudaBackend(kernel="cuda", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        CudaBackend(device="cuda")
    with pytest.raises(ConfigError, match="no CUDA device"):
        backend_from_config(MinerConfig(difficulty_bits=8))


def test_backend_from_config():
    be = backend_from_config(MinerConfig(backend="cpu", n_miners=3,
                                         batch_pow2=12), resilient=False)
    assert isinstance(be, CpuBackend) and be.n_ranks == 3
    be = backend_from_config(MinerConfig(device="cpu", batch_pow2=14),
                             resilient=False)
    assert isinstance(be, CudaBackend)
    assert be.batch_size == 1 << 14 and be.effective_kernel == "torch"
    # Wrapped by default; the active rung is the same backend.
    wrapped = backend_from_config(MinerConfig(device="cpu", batch_pow2=14))
    assert isinstance(wrapped.active_backend, CudaBackend)
    assert wrapped.active_backend.effective_kernel == "torch"
    assert wrapped.rung == "cuda:torch" and not wrapped.degraded
    wrapped = backend_from_config(MinerConfig(backend="cpu", n_miners=3))
    assert isinstance(wrapped.active_backend, CpuBackend)
    assert wrapped.active_backend.n_ranks == 3 and wrapped.rung == "cpu"
    for resilient in (True, False):
        with pytest.raises(ConfigError, match="n_miners"):
            backend_from_config(MinerConfig(device="cpu", n_miners=2),
                                resilient=resilient)
    with pytest.raises(ConfigError, match="unknown miner_backend"):
        get_backend("tpu")
    with pytest.raises(ConfigError):
        MinerConfig(kernel="pallas")


def test_cpu_ranks_keep_the_lowest_nonce():
    hdr = bytes(range(80))
    ranks = CpuBackend(n_ranks=3, batch_size=1 << 10)
    single = CpuBackend()
    for dbits in (6, 11):
        a, b = ranks.search(hdr, dbits), single.search(hdr, dbits)
        assert (a.nonce, a.hash) == (b.nonce, b.hash)
