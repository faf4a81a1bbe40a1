"""The CUDA sweep kernel against its plain PyTorch version on the card.

Bit for bit at every difficulty class, at the top of the nonce space, and
at the edges of the kernel's work queue: the kernel hands out slices of
``SLICE_NONCES`` consecutive nonces in ascending order, and these cases put
winners where a slice boundary matters. The early exit's overshoot is held
against one slice per resident warp. Every test needs a CUDA device
(``cuda`` marker) and skips without one.

This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_sweep_cuda.py
"""
import numpy as np
import pytest
import torch

from mpi_blockchain_tpu_torch import convert, core
from mpi_blockchain_tpu_torch.ops import sha256_cuda, sha256_torch
from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate


def _header(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=80, dtype=np.uint8).tobytes()


def _ext(hdr: bytes) -> np.ndarray:
    return extend_midstate(*core.header_midstate(hdr))


def _slice_case(name: str, g: int):
    """(ext, dbits, base, count) at an edge of the kernel's slices of ``g``
    nonces, from the first seeded header that fits (C++ cpu_search)."""
    lg = g.bit_length() - 1
    base = 0x3A5C0011
    ragged = g // 2 + 3
    top = 1 << 32
    cases = {
        # the two lowest winners lie in different slices
        "two_slices": (lg + 2, base, 64 * g),
        # a count that is not a multiple of g
        "ragged_count": (8, base, 100 * g + 13),
        # the winner lies in the first slice
        "first_slice": (lg + 1, base, 64 * g),
        # the winner lies in the last, ragged slice, ending at 2^32
        "last_slice": (lg, top - 2 * g - ragged, 2 * g + ragged),
    }
    dbits, start, count = cases[name]

    def fits(hdr):
        def search(s, n):
            return core.cpu_search(hdr, s, n, dbits)[0]
        if name == "two_slices":
            lo = search(start, count)
            hi = None if lo is None else search(lo + 1, start + count - lo - 1)
            return hi is not None and (hi - start) // g != (lo - start) // g
        if name == "first_slice":
            return search(start, g) is not None
        if name == "last_slice":
            return search(start, 2 * g) is None and \
                search(top - ragged, ragged) is not None
        return True

    for seed in range(500, 5000):
        hdr = _header(seed)
        if fits(hdr):
            return _ext(hdr), dbits, start, count
    raise AssertionError(f"no seeded header fits {name}")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dbits", [0, 1, 8, 31, 32, 33, 63, 64])
def test_cuda_kernel_matches_plain_on_the_card(dbits):
    device = _card()
    ext = _ext(_header(400 + dbits))
    ext_t = convert.ext_from_reference(ext, device)
    for base, count in ((0, 1 << 18), (0xFFFFE000, 1 << 13)):
        for early_exit in (False, True):
            k = sha256_cuda.sweep(ext, base, count, dbits, device=device,
                                  early_exit=early_exit)
            p = sha256_torch.sweep_core_ext(ext_t, base, count, dbits,
                                            early_exit=early_exit)
            assert k[1] == p[1] and (k[0] > 0) == (p[0] > 0)
            if not early_exit:
                assert k == p


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two_slices", "ragged_count",
                                  "first_slice", "last_slice"])
def test_cuda_kernel_matches_plain_at_slice_edges(name):
    device = _card()
    ext, dbits, base, count = _slice_case(name, sha256_cuda.SLICE_NONCES)
    ext_t = convert.ext_from_reference(ext, device)
    full = sha256_cuda.sweep(ext, base, count, dbits, device=device)
    assert full == sha256_torch.sweep_core_ext(ext_t, base, count, dbits)
    early = sha256_cuda.sweep(ext, base, count, dbits, device=device,
                              early_exit=True)
    assert early[1] == full[1] and early[0] > 0


@pytest.mark.cuda
def test_cuda_early_exit_overshoots_by_at_most_a_slice_per_warp():
    """Every launch hashes at least the nonces up to the winner; the median
    launch at most one slice per resident warp past it. Warps of different
    blocks on one SM progress unevenly, so one launch can pass that when
    the winner lies in a slow warp's slice."""
    device = _card()
    dbits = 20
    launches = 101
    ext = _ext(_header(600))
    found, winner = sha256_cuda.sweep(ext, 0, 1 << 32, dbits, device=device,
                                      early_exit=True)
    assert found and sha256_cuda.sweep(ext, 0, winner + 1, dbits,
                                       device=device) == (1, winner)
    hashed = torch.zeros(launches, dtype=torch.int64, device=device)
    outs = [sha256_cuda.new_result(device) for _ in range(launches)]
    for i, out in enumerate(outs):
        sha256_cuda.launch(ext, 0, 1 << 32, dbits, out, early_exit=True,
                           hashed=hashed[i:i + 1])
    assert all(sha256_cuda.read_result(out)[1] == winner for out in outs)
    over = sorted(n - (winner + 1) for n in hashed.tolist())
    warps = sha256_cuda.resident_warps(dbits, device)
    assert over[0] >= 0
    assert over[launches // 2] <= warps * sha256_cuda.SLICE_NONCES
