"""The fused miner's kernels on the card: the step kernel against its
plain version (seeded and edge cases), its measuring entry, the
constant-ext sweep against the by-value sweep, whole k-block calls against
the plain sequence, and a pinned chain.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_fused_cuda.py
"""
import numpy as np
import pytest
import torch

from mpi_blockchain_tpu_torch import core
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda
from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

PINNED_D16_N30 = \
    "0000920e5985e6c7571d5094847875c2fa96ee43cff93294339fc12283597371"
M32 = 0xFFFFFFFF


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)) \
        .to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_step_kernel_matches_the_plain_step(seed):
    """Build, finalize-and-build, and finalize into the tip, bit for bit,
    with the sentinel and random nonces in the result buffer."""
    device = _card()
    cpu = torch.device("cpu")
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
    data = rng.integers(0, 1 << 32, (2, 8), dtype=np.uint32)
    height = int(rng.integers(0, 1 << 32))
    nonces = [M32 if seed == 0 else int(rng.integers(0, 1 << 32)),
              int(rng.integers(0, 1 << 32))]
    runs = []
    for dev, step in ((device, sha256_block.step),
                      (cpu, sha256_block.step_plain)):
        scratch = sha256_block.new_scratch(dev)
        nonce = torch.zeros(2, dtype=torch.uint32, device=dev)
        tip = torch.zeros(8, dtype=torch.uint32, device=dev)
        step(scratch, prev=_u32(prev, dev), data=_u32(data[0], dev),
             height=height, difficulty_bits=24)
        built = scratch.cpu().clone()
        scratch.view(torch.uint32)[1] = nonces[0]
        step(scratch, data=_u32(data[1], dev), height=height + 1,
             difficulty_bits=24, nonce_out=nonce[:1])
        both = scratch.cpu().clone()
        scratch.view(torch.uint32)[1] = nonces[1]
        step(scratch, nonce_out=nonce[1:], tip_out=tip)
        runs.append([built, both, scratch.cpu(), nonce.cpu(), tip.cpu()])
    for kernel, plain in zip(*runs):
        assert torch.equal(kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("group", range(3))
def test_step_kernel_matches_the_plain_step_at_the_edges(group):
    """chip_smoke's edge cases, one difficulty (0, 24, 64) per group: every
    prev word all-zero or all-ones, height 0 or 0xFFFFFFFF, nonce 0 or
    0xFFFFFFFF; build, finalize-and-build and finalize, bit for bit."""
    from chip_smoke import step_edge_cases, step_vs_plain

    device = _card()
    case = step_edge_cases(np.random.default_rng(20261019))[group]
    assert step_vs_plain(*case, device) == (0, 0)


@pytest.mark.cuda
def test_constant_ext_sweep_matches_by_value_at_slice_edges():
    """The instantiation reading ext from the __constant__ symbol against
    the by-value one, full and early-exit, on chip_smoke's slice-edge
    cases."""
    from chip_smoke import slice_edge_cases

    device = _card()
    fresh = sha256_cuda.new_result(device)
    for hdr, dbits, base, count in slice_edge_cases(
            np.random.default_rng(20261017), sha256_cuda.SLICE_NONCES):
        ext = extend_midstate(*core.header_midstate(hdr))
        for early_exit in (False, True):
            got = []
            for e in (ext, _u32(ext, device)):
                out = fresh.clone()
                sha256_cuda.launch(e, base, count, dbits, out,
                                   early_exit=early_exit)
                got.append(sha256_cuda.read_result(out))
            assert got[0] == got[1]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1 << 12, 1 << 32])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_k_block_call_matches_the_plain_sequence(k, cap):
    """One enqueued k-block call against mine_k_plain: the same nonces
    (the sentinel where [0, cap) holds no winner) and tip. Every step after
    the first follows a sweep, so this covers its programmatic dependent
    launch."""
    device = _card()
    rng = np.random.default_rng(7)
    prev = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
    data = rng.integers(0, 1 << 32, (k, 8), dtype=np.uint32)
    launches, steps = sha256_cuda.launches, sha256_block.step_launches
    nonces, tip = sha256_block.mine_k(_u32(prev, device), _u32(data, device),
                                      41, 12, cap)
    assert sha256_cuda.launches - launches == k
    assert sha256_block.step_launches - steps == k + 1
    want = sha256_block.mine_k_plain(_u32(prev, "cpu"), _u32(data, "cpu"),
                                     41, 12, cap)
    assert nonces.cpu().tolist() == want[0].tolist()
    assert tip.cpu().tolist() == want[1].tolist()


@pytest.mark.cuda
def test_step_repeat_and_its_clock_stamps():
    """The measuring entry: n steps back to back leave what one step
    leaves, and the stamped build writes rising SM clocks per launch."""
    device = _card()
    rng = np.random.default_rng(8)
    prev = _u32(rng.integers(0, 1 << 32, 8, dtype=np.uint32), device)
    data = _u32(rng.integers(0, 1 << 32, 8, dtype=np.uint32), device)
    one, many = (sha256_block.new_scratch(device) for _ in range(2))
    sha256_block.step(one, prev=prev, data=data, height=5,
                      difficulty_bits=20)
    stamps = torch.zeros(6, dtype=torch.int64, device=device)
    steps = sha256_block.step_launches
    sha256_block.step_repeat(3, many, prev=prev, data=data, height=5,
                             difficulty_bits=20, stamps=stamps)
    assert sha256_block.step_launches - steps == 3
    assert torch.equal(one, many)
    t = stamps.tolist()
    assert all(0 < t[2 * i + 1] - t[2 * i] < 1 << 24 for i in range(3))
    with pytest.raises(ValueError, match="stamps"):
        sha256_block.step_repeat(2, many, prev=prev, stamps=stamps)


@pytest.mark.cuda
def test_fused_d16_n30_tip_matches_its_pin():
    _card()
    fm = FusedMiner(MinerConfig(difficulty_bits=16, n_blocks=30,
                                batch_pow2=20), blocks_per_call=16)
    fm.warmup()
    launches, steps = sha256_cuda.launches, sha256_block.step_launches
    fm.mine_chain()
    assert fm.node.tip_hash.hex() == PINNED_D16_N30
    assert sha256_cuda.launches - launches == 30
    assert sha256_block.step_launches - steps == 32
    assert fm.host_waits == 2
