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
only on a card: ``test_torch_sweep_cuda.py`` holds it against the plain
version there. Here, its wrapper's contract on the CPU and the pieces of
its bound (the loop census, the source's adds) are checked.
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


# cuobjdump -sass shape: instantiations, each a prologue, a loop closed by
# a backward branch, and the self-branch that follows EXIT; the stamped one
# and the one reading ext from the constant symbol come first and must not
# be taken.
_SASS = """
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb0ELb0ELb1EEEvNS_9SweepArgsEPjPy
        /*0000*/                   LOP3.LUT R2, RZ, 0x5, R0, 0x96, !PT ;
        /*0010*/                   BRA 0x0 ;
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb0ELb1ELb0EEEvNS_9SweepArgsEPjPy
        /*0000*/                   LOP3.LUT R2, RZ, 0x3, R0, 0x96, !PT ;
        /*0010*/                   BRA 0x0 ;
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb1ELb0ELb0EEEvNS_9SweepArgsEPjPy
        /*0000*/                   SHF.R.U32.HI R2, RZ, 0x3, R0 ;
        /*0010*/                   BRA 0x0 ;
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb0ELb0ELb0EEEvNS_9SweepArgsEPjPy
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


def test_result_buffer_layout_and_its_validation():
    """{count, min, cursor_lo, cursor_hi}: the cursor is a uint64 starting
    at 0, so the buffer is four int32 words, 8-byte aligned."""
    out = sha256_cuda.new_result(torch.device("cpu"))
    assert out.dtype == torch.int32 and out.tolist() == [0, -1, 0, 0]
    assert sha256_cuda.RESULT_WORDS == 4
    sha256_cuda.check_result_buffer(out)
    wrong = [torch.tensor([0, -1], dtype=torch.int32),    # two words
             torch.tensor([0, -1, 0, 0], dtype=torch.int64),
             torch.zeros(8, dtype=torch.int32)[::2],            # strided
             torch.zeros(5, dtype=torch.int32)[1:]]             # 4 bytes in
    for buf in wrong:
        with pytest.raises(ValueError, match="new_result"):
            sha256_cuda.check_result_buffer(buf)
    ext = _ext(_header(10))
    with pytest.raises(ValueError, match="CUDA"):
        sha256_cuda.launch(ext, 0, BATCH, 8, out)


# The queue loop's shape: a slice-taking block (atomic on the cursor,
# shuffles, the early-exit test) inside the loop, closed by a backward
# branch after the vote; here with two nonces hashed per trip.
_SASS_QUEUE = """
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb0ELb0ELb0EEEvNS_9SweepArgsEPjPy
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.NE.AND P0, PT, R30, c[0x0][0x25c], PT ;
        /*0020*/               @P0 BRA 0x70 ;
        /*0030*/                   ATOMG.E.ADD.64.STRONG.GPU PT, R4, [R2.64], R4 ;
        /*0040*/                   SHFL.IDX PT, R5, R4, RZ, 0x1f ;
        /*0050*/                   ISETP.GE.U32.AND P1, PT, R5, c[0x0][0x250], PT ;
        /*0060*/               @P1 EXIT ;
        /*0070*/                   SHF.R.W.U32.HI R5, R2, 0x7, R2 ;
        /*0080*/                   LOP3.LUT R6, R5, R3, R2, 0x96, !PT ;
        /*0090*/                   IMAD R7, R6, c[0x0][0x258], R5 ;
        /*00a0*/                   SHF.R.W.U32.HI R8, R7, 0x7, R7 ;
        /*00b0*/                   LOP3.LUT R9, R8, R3, R7, 0x96, !PT ;
        /*00c0*/                   IMAD R10, R9, c[0x0][0x258], R8 ;
        /*00d0*/                   VOTE.ANY R11, PT, P2 ;
        /*00e0*/              @!P3 BRA 0x10 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   BRA 0x100 ;
"""


def test_census_names_the_template_and_divides_by_the_nonces_per_trip():
    assert sha256_cuda.kernel_symbol(24) \
        == "sha256d_sweep_kernelILi1ELb0ELb0ELb0E"
    assert sha256_cuda.kernel_symbol(40, count_hashed=True) \
        == "sha256d_sweep_kernelILi3ELb1ELb0ELb0E"
    census = sha256_cuda.loop_census(_SASS_QUEUE, 24)
    assert census == {"ISETP": 2, "BRA": 2, "SHF": 2, "LOP3": 2, "IMAD": 2,
                      "ATOMG": 1, "SHFL": 1, "EXIT": 1, "VOTE": 1}
    assert sha256_cuda.pipe_counts(census) == (6, 2, 14)
    clocks = sha256_cuda.sm_clocks_per_nonce
    assert sha256_cuda.NONCES_PER_TRIP == 1
    # 14 instructions issue in 14/128 of a clock, above 6 ALU ops / 64.
    assert clocks(census) == 14 / 128
    assert clocks(census, nonces_per_trip=2) == 14 / 128 / 2
    with pytest.raises(ValueError, match="nonces_per_trip"):
        clocks(census, nonces_per_trip=0)


def test_bound_counts_the_function_work_not_the_pipe_split():
    """ALU-only instructions fill the ALU pipe; adds go on either pipe, one
    an IMAD or two an IADD3, so how the compiler split them does not move
    the bound."""
    bound = sha256_cuda.bound_sm_clocks_per_nonce
    split_a = {"SHF": 100, "LOP3": 28, "IADD3": 50, "IMAD": 80, "BRA": 1}
    split_b = {"SHF": 100, "LOP3": 28, "IADD3": 5, "IMAD": 170, "BRA": 1}
    assert sha256_cuda.alu_only_count(split_a) == 128
    # 128 ALU-only ops take 2 clocks; 64 adds fit on the FMA pipe beside.
    assert bound(split_a, 64) == bound(split_b, 64) == 128 / 64
    # 400 adds do not: the best split gives (2 * 128 + 400) / 192.
    assert bound(split_a, 400) == (2 * 128 + 400) / 192
    assert bound(split_a, 64, nonces_per_trip=2) == 128 / 64 / 2
    with pytest.raises(ValueError, match="nonces_per_trip"):
        bound(split_a, 64, nonces_per_trip=0)
    # The census figure follows the split; the bound never exceeds it.
    census = sha256_cuda.sm_clocks_per_nonce
    assert census(split_a) == 178 / 64 and census(split_b) == 170 / 64
    assert bound(split_a, 64) <= min(census(split_a), census(split_b))


@pytest.mark.parametrize("seed", [11, 12])
def test_source_add_replay_is_the_kernel_function(seed):
    """The replay behind ``source_adds`` computes sha256d's h0, h1 on
    integers, so its adds are the function's."""
    hdr = _header(seed)
    nonce = int(np.random.default_rng(seed).integers(0, 1 << 32))
    ext = [int(x) for x in _ext(hdr)]
    w3 = int.from_bytes(nonce.to_bytes(4, "little"), "big")
    buf = bytearray(hdr)
    buf[76:80] = nonce.to_bytes(4, "little")
    digest = hashlib.sha256(hashlib.sha256(bytes(buf)).digest()).digest()
    assert sha256_cuda._replay_h01(ext, w3) == (
        int.from_bytes(digest[:4], "big"), int.from_bytes(digest[4:8], "big"))


def test_source_adds_follow_what_the_class_reads():
    adds = sha256_cuda.source_adds
    # Class 0 reads no digest word; the h0 classes share one count; h1
    # costs its one feed-forward add (the rest of it is h0's work).
    assert adds(0) == 0
    assert adds(1) == adds(24) == adds(31) == adds(32) > 1000
    assert adds(33) == adds(63) == adds(64) == adds(24) + 1
    # Fewer than a plain count of the two compressions (7 adds a round, 3
    # a schedule word, the feed-forward words): constants and
    # loop-invariant terms fold, dead tails drop.
    assert adds(24) < 7 * (60 + 64) + 3 * (44 + 48) + 8 + 1


def test_sweep_variants_patch_the_current_source(monkeypatch):
    from mpi_blockchain_tpu_torch.tools import sweep_variants
    source = sha256_cuda.SOURCE.read_text()
    assert sweep_variants.variant_source("shipped") == source
    for name in sweep_variants.VARIANTS:
        if name != "shipped":
            assert sweep_variants.variant_source(name) != source
        assert sweep_variants.PER_WARP[1] in sweep_variants.variant_source(
            name, per_warp=True)
    monkeypatch.setitem(sweep_variants.VARIANTS, "stale",
                        [("no such text", "")])
    with pytest.raises(ValueError, match="0 times"):
        sweep_variants.variant_source("stale")
