"""The port's chain core and state carry-over against the JAX package.

The port keeps its own copy of the C++ core and of the per-template
precompute; both must agree with the reference bit for bit, and a chain
the reference mined must load into the port with the same height and tip
and be mined on from there.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mpi_blockchain_tpu import core as ref_core
from mpi_blockchain_tpu.backend.cpu import CpuBackend as RefCpuBackend
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu.ops import sha256_sched as ref_sched
from mpi_blockchain_tpu_torch import convert, core
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)


def _headers(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=80, dtype=np.uint8).tobytes()
            for _ in range(n)]


def test_midstate_and_extension_match_reference():
    for hdr in _headers(1, 6):
        ms, tail = core.header_midstate(hdr)
        ref_ms, ref_tail = ref_core.header_midstate(hdr)
        np.testing.assert_array_equal(ms, ref_ms)
        np.testing.assert_array_equal(tail, ref_tail)
        ext = extend_midstate(ms, tail)
        assert ext.dtype == np.uint32
        np.testing.assert_array_equal(
            ext, ref_sched.extend_midstate(ref_ms, ref_tail))


def test_hash_primitives_match_reference():
    rng = np.random.default_rng(2)
    for n in (0, 1, 55, 56, 64, 80, 200):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert core.sha256(data) == ref_core.sha256(data)
        assert core.sha256d(data) == ref_core.sha256d(data)
    for hdr in _headers(3, 4):
        assert core.header_hash(hdr) == ref_core.header_hash(hdr)
        digest = core.header_hash(hdr)
        assert core.leading_zero_bits(digest) \
            == ref_core.leading_zero_bits(digest)


@pytest.mark.parametrize("start,count,dbits", [
    (0, 1 << 16, 8), (12345, 5000, 10), (0xFFFFE000, 1 << 20, 6),
    (0xFFFFFFFF, 10, 0), (7, 100, 20)])
def test_cpu_search_matches_reference(start, count, dbits):
    for hdr in _headers(4 + dbits, 3):
        assert core.cpu_search(hdr, start, count, dbits) \
            == ref_core.cpu_search(hdr, start, count, dbits)


def test_node_state_matches_reference_block_by_block():
    """The same mined headers give byte-identical candidates, hashes and
    saved chains in both cores."""
    node, ref = core.Node(10), ref_core.Node(10)
    for height in range(1, 5):
        data = b"block:%d" % height
        cand = node.make_candidate(data)
        assert cand == ref.make_candidate(data)
        assert cand == core.make_candidate_header(node.tip_hash, data,
                                                  height, 10)
        nonce, _ = core.cpu_search(cand, 0, 1 << 32, 10)
        winner = core.set_nonce(cand, nonce)
        assert node.submit(winner) and ref.submit(winner)
        assert node.tip_hash == ref.tip_hash
        assert node.find(node.tip_hash) == height
    assert node.save() == ref.save()
    assert node.all_headers() == ref.all_headers()
    assert core.HeaderFields.unpack(node.block_header(3)).timestamp == 3


def test_ext_from_reference_gives_the_port_tensor_form():
    ext = ref_sched.extend_midstate(*ref_core.header_midstate(
        _headers(5, 1)[0]))
    t = convert.ext_from_reference(ext, "cpu")
    assert t.dtype == torch.int64 and t.device.type == "cpu"
    assert t.tolist() == [int(v) for v in ext]
    with pytest.raises(ValueError):
        convert.ext_from_reference(ext[:19], "cpu")
    with pytest.raises(ValueError):
        convert.ext_from_reference(ext.astype(np.int64), "cpu")


def test_reference_chain_loads_and_the_port_mines_on():
    ref_cfg = RefConfig(difficulty_bits=10, n_blocks=3, backend="cpu")
    ref_miner = RefMiner(ref_cfg, backend=RefCpuBackend(), pipeline=False)
    ref_miner.mine_chain()
    blob = ref_miner.node.save()

    node = convert.node_from_reference_chain(blob, 10)
    assert node.height == ref_miner.node.height == 3
    assert node.tip_hash == ref_miner.node.tip_hash
    with pytest.raises(ConfigError):
        convert.node_from_reference_chain(blob, 11)

    cfg = MinerConfig(difficulty_bits=10, n_blocks=5, backend="cuda",
                      device="cpu")
    miner = Miner(cfg)
    miner.node = node
    miner.mine_chain(2)
    ref_miner.mine_chain(2)
    assert miner.node.height == 5
    assert miner.node.save() == ref_miner.node.save()
    assert [dataclasses.astuple(r)[:2] for r in miner.records] \
        == [dataclasses.astuple(r)[:2] for r in ref_miner.records[3:]]
