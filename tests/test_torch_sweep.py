"""The port's double-SHA-256 sweep against the JAX package, bit for bit.

The plain PyTorch version (``ops/sha256_torch.py``, what the port runs on
the CPU and what the CUDA kernel is held against on the card) is compared
with three oracles over the same seeded inputs:

* the reference's jitted ``sha256_jnp.sweep_core_ext``;
* the Pallas kernel body ``_tile_result`` run eagerly under
  ``jax.disable_jit()``, as the reference's own tests run it on the CPU (a
  full ``interpret=True`` compile is out of reach there);
* a hashlib double SHA-256 that shares no code with either package.

Tolerance 0: proof of work has no near-match. The CUDA kernel itself runs
only on a card (``cuda`` marker).
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_blockchain_tpu import core as ref_core
from mpi_blockchain_tpu.ops import sha256_pallas as ref_pallas
from mpi_blockchain_tpu.ops import sha256_sched as ref_sched
from mpi_blockchain_tpu.ops.sha256_jnp import sweep_core_ext as ref_sweep
from mpi_blockchain_tpu_torch import convert, core
from mpi_blockchain_tpu_torch.config import ConfigError
from mpi_blockchain_tpu_torch.ops import select_kernel, sha256_cuda, \
    sha256_torch
from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

BATCH = ref_pallas.TILE          # 8192: one Pallas tile
DBITS = [0, 1, 8, 31, 32, 33, 63, 64]
BASES = {"zero": 0, "random": 0x5A3C1000, "top": 0xFFFFE000}
_REF_SWEEP = jax.jit(ref_sweep, static_argnums=(2, 3))


def _header(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=80, dtype=np.uint8).tobytes()


def _ext(hdr: bytes) -> np.ndarray:
    return extend_midstate(*core.header_midstate(hdr))


def _port(hdr: bytes, dbits: int, base: int, count: int = BATCH,
          early_exit: bool = False):
    ext_t = convert.ext_from_reference(_ext(hdr), "cpu")
    return sha256_torch.sweep_core_ext(ext_t, base, count, dbits,
                                       early_exit=early_exit)


def _hashlib(hdr: bytes, dbits: int, base: int, count: int = BATCH):
    buf = bytearray(hdr)
    n, best = 0, 0xFFFFFFFF
    for nonce in range(base, base + count):
        buf[76:80] = nonce.to_bytes(4, "little")
        top = int.from_bytes(hashlib.sha256(hashlib.sha256(
            bytes(buf)).digest()).digest()[:8], "big")
        if dbits == 0 or top < (1 << (64 - dbits)):
            n += 1
            best = min(best, nonce)
    return n, best


@pytest.mark.parametrize("base_name", sorted(BASES))
@pytest.mark.parametrize("dbits", DBITS)
def test_sweep_matches_jnp_and_hashlib(dbits, base_name):
    base = BASES[base_name]
    hdr = _header(100 + dbits)
    ref_ext = ref_sched.extend_midstate(*ref_core.header_midstate(hdr))
    c, m = _REF_SWEEP(ref_ext, np.uint32(base), BATCH, dbits)
    got = _port(hdr, dbits, base)
    assert got == (int(c), int(m))
    assert got == _hashlib(hdr, dbits, base)
    early = _port(hdr, dbits, base, early_exit=True)
    assert early[1] == got[1] and (early[0] > 0) == (got[0] > 0)


@pytest.mark.parametrize("dbits", DBITS)
def test_sweep_matches_eager_pallas_tile(dbits):
    hdr = _header(200 + dbits)
    base = BASES["random"]
    ref_ext = ref_sched.extend_midstate(*ref_core.header_midstate(hdr))
    with jax.disable_jit():
        c, biased = ref_pallas._tile_result(
            jnp.asarray(ref_ext), jnp.uint32(base), difficulty_bits=dbits)
    m = int(jax.lax.bitcast_convert_type(biased, jnp.uint32)
            ^ np.uint32(0x80000000))
    assert _port(hdr, dbits, base) == (int(c), m)


@pytest.mark.parametrize("dbits,seed", [(0, 301), (8, 302), (16, 300)])
def test_early_exit_keeps_the_lowest_nonce(dbits, seed):
    """Over several chunks: early exit stops at the first chunk with a
    hit, so the min is exact and the count is a found-flag. At dbits 16
    the first hit lies in the second chunk."""
    hdr = _header(seed)
    count = 3 * sha256_torch.CHUNK + 5
    full = _port(hdr, dbits, 1000, count)
    early = _port(hdr, dbits, 1000, count, early_exit=True)
    oracle, _ = core.cpu_search(hdr, 1000, count, dbits)
    assert early[1] == full[1] == oracle
    assert (early[0] > 0) == (full[0] > 0)
    assert 0 < early[0] <= full[0]


def test_last_nonce_is_findable_and_ranges_do_not_wrap():
    ext = _ext(_header(7))
    assert sha256_torch.sweep_core_ext(ext, 0xFFFFFFFF, 1, 0) \
        == (1, 0xFFFFFFFF)
    assert sha256_torch.sweep_core_ext(ext, 5, 0, 8) == (0, 0xFFFFFFFF)
    with pytest.raises(ValueError):
        sha256_torch.sweep_core_ext(ext, 0xFFFFFFFF, 2, 0)
    with pytest.raises(ConfigError):
        sha256_torch.sweep_core_ext(ext, 0, 16, 65)


def test_wrapper_runs_plain_on_cpu_and_never_falls_back_on_cuda():
    hdr = _header(8)
    ext = _ext(hdr)
    plain = sha256_torch.sweep_core_ext(ext, 0, BATCH, 8)
    assert sha256_cuda.sweep(ext, 0, BATCH, 8, device="cpu") == plain
    launches = sha256_cuda.launches
    if torch.cuda.is_available():
        assert sha256_cuda.sweep(ext, 0, BATCH, 8, device="cuda") == plain
        assert sha256_cuda.launches == launches + 1
    else:
        with pytest.raises(ConfigError):
            sha256_cuda.sweep(ext, 0, BATCH, 8, device="cuda")
        assert sha256_cuda.launches == launches


def test_select_kernel_policy():
    fn, name = select_kernel("auto", torch.device("cpu"), 8)
    assert name == "torch"
    ext = _ext(_header(9))
    assert fn(ext, 0, BATCH) == sha256_torch.sweep_core_ext(ext, 0, BATCH, 8)
    with pytest.raises(ConfigError, match="needs a CUDA device"):
        select_kernel("cuda", torch.device("cpu"), 8)
    with pytest.raises(ConfigError, match="unknown sweep kernel"):
        select_kernel("pallas", torch.device("cpu"), 8)


# cuobjdump -sass shape: two instantiations, each a prologue, a loop closed
# by a backward branch, and the self-branch that follows EXIT.
_SASS = """
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb1EEEvNS_9SweepArgsEPjPy
        /*0000*/                   SHF.R.U32.HI R2, RZ, 0x3, R0 ;
        /*0010*/                   BRA 0x0 ;
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb0EEEvNS_9SweepArgsEPjPy
        .headerflags    @"EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD.MOV.U32 R4, RZ, RZ, c[0x0][0x210] ;
        /*0030*/                   SHF.R.W.U32.HI R5, R2, 0x7, R2 ;
        /*0040*/                   LOP3.LUT R6, R5, R3, R2, 0x96, !PT ;
        /*0050*/                   IADD3 R7, R6, R5, R3 ;
        /*0060*/                   IMAD.IADD R8, R7, 0x1, R6 ;
        /*0070*/                   VIADD R9, R8, 0x4 ;
        /*0080*/               @P0 BRA 0xa0 ;
        /*0090*/                   REDG.E.MIN.STRONG.GPU [R10.64], R11 ;
        /*00a0*/              @!P1 BRA 0x30 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0 ;
"""


def test_op_count_follows_the_difficulty_classes():
    """The census reads the loop of the production template that serves
    the difficulty's class, not the measuring build's."""
    assert [sha256_cuda.difficulty_class(d) for d in DBITS] \
        == [0, 1, 1, 1, 2, 3, 3, 4]
    loop = {"SHF": 1, "LOP3": 1, "IADD3": 1, "IMAD": 1, "VIADD": 1,
            "BRA": 2, "REDG": 1}
    assert sha256_cuda.loop_census(_SASS, 8) == loop
    assert sha256_cuda.loop_census(_SASS, 31) == loop
    with pytest.raises(ValueError, match="ILi2ELb0E"):
        sha256_cuda.loop_census(_SASS, 32)


def test_bound_takes_the_busiest_pipe():
    clocks = sha256_cuda.sm_clocks_per_nonce
    # 3 ALU ops fill the 64-lane ALU pipe for 3/64 of a clock; the IMAD and
    # the VIADD go elsewhere; issue takes 8/128.
    assert clocks(sha256_cuda.loop_census(_SASS, 8)) == 8 / 128
    assert clocks({"SHF": 100, "IMAD": 30, "NOP": 10}) == 100 / 64
    assert clocks({"SHF": 10, "IMAD": 30}) == 30 / 64
    assert clocks({"IADD3": 64, "IMAD": 64, "ULDC": 128}) == 256 / 128


@pytest.mark.cuda
@pytest.mark.parametrize("dbits", DBITS)
def test_cuda_kernel_matches_plain_on_the_card(dbits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda")
    ext = _ext(_header(400 + dbits))
    ext_t = convert.ext_from_reference(ext, device)
    for base, count in ((0, 1 << 18), (0xFFFFE000, BATCH)):
        for early_exit in (False, True):
            k = sha256_cuda.sweep(ext, base, count, dbits, device=device,
                                  early_exit=early_exit)
            p = sha256_torch.sweep_core_ext(ext_t, base, count, dbits,
                                            early_exit=early_exit)
            assert k[1] == p[1] and (k[0] > 0) == (p[0] > 0)
            if not early_exit:
                assert k == p
