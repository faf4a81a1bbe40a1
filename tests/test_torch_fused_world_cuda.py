"""The fused world's pieces on the card: this rank's slice of a round
(``sha256_block.slice_launch``, the constant-ext sweep into a buffer of
its own) and the winner's copy into the step's result buffer
(``put_result``) against their plain versions, and a world of one process
over gloo mining the d16/n30 pin through ``FusedMiner(group=)``.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_fused_world_cuda.py
"""
import socket

import numpy as np
import pytest
import torch

from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

PINNED_D16_N30 = \
    "0000920e5985e6c7571d5094847875c2fa96ee43cff93294339fc12283597371"
M32 = 0xFFFFFFFF


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _built(device, prev, data, bits):
    scratch = sha256_block.new_scratch(device)
    sha256_block.step(scratch, prev=torch.from_numpy(prev).to(device),
                      data=torch.from_numpy(data).to(device), height=7,
                      difficulty_bits=bits)
    return scratch


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_a_slice_and_the_winners_copy_match_the_plain_versions(bits):
    device = _card()
    rng = np.random.default_rng(bits)
    prev = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
    data = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
    card = _built(device, prev, data, bits)
    plain = _built(torch.device("cpu"), prev, data, bits)
    assert card.cpu().tolist() == plain.tolist()
    before = sha256_cuda.launches
    for base, count in ((0, 1 << 12), (5, 1000), (M32 - 4095, 4096)):
        got = sha256_block.slice_launch(card, base, count, bits)()
        want = sha256_block.slice_launch(plain, base, count, bits)()
        assert got[1] == want[1] and (got[0] > 0) == (want[0] > 0)
    assert sha256_cuda.launches == before + 3
    # The slices left the step's own result buffer as the step reset it.
    assert card.cpu().tolist() == plain.tolist()
    for scratch in (card, plain):
        sha256_block.put_result(scratch, 3, M32 - 1)
    torch.cuda.synchronize()
    assert card.cpu().tolist() == plain.tolist()
    assert card.view(torch.uint32)[:2].cpu().tolist() == [3, M32 - 1]
    nonces = []
    for scratch in (card, plain):
        out = torch.zeros(1, dtype=torch.uint32, device=scratch.device)
        tip = torch.zeros(8, dtype=torch.uint32, device=scratch.device)
        sha256_block.step(scratch, nonce_out=out, tip_out=tip)
        nonces.append((out.cpu().tolist(), tip.cpu().tolist()))
    assert nonces[0] == nonces[1] and nonces[0][0] == [M32 - 1]


@pytest.mark.cuda
def test_a_world_of_one_mines_the_d16_pin():
    """``FusedMiner(group=)`` in a gloo world of one on the card: the pin,
    one slice launch and one host wait a round, a step a block and a
    call."""
    import torch.distributed as dist

    _card()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        fm = FusedMiner(MinerConfig(difficulty_bits=16, n_blocks=30,
                                    batch_pow2=20, device="cuda"),
                        blocks_per_call=16, group=dist.group.WORLD)
        sha256_cuda.launches = sha256_block.step_launches = 0
        fm.mine_chain()
    finally:
        dist.destroy_process_group()
    assert fm.node.tip_hash.hex() == PINNED_D16_N30
    rounds = sum(int.from_bytes(fm.node.block_header(h)[76:], "little")
                 // (1 << 20) + 1 for h in range(1, 31))
    assert sha256_cuda.launches == fm.host_waits == rounds
    assert sha256_block.step_launches == 30 + 2
