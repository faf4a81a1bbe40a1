"""The port's fused k-block miner against the reference's, on the CPU.

The plain step functions (``ops/sha256_block.py``) against the reference's
jnp header build and winner digest and the C++ core; the port's
``make_fused_miner`` and ``FusedMiner`` against the reference's (jnp
kernel) and the port's sequential ``Miner``: the same nonces, tip words and
chain bytes, exactly. The rollover, kernel-bug and dispatch-accounting
cases mirror tests/test_exhaustion.py and tests/test_fused.py, with their
exhaust-first-space stub.
"""
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_blockchain_tpu import core as ref_core
from mpi_blockchain_tpu.cli import main as ref_main
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.fused import FusedMiner as RefFusedMiner
from mpi_blockchain_tpu.models.fused import \
    make_fused_miner as ref_make_fused_miner
from mpi_blockchain_tpu.ops import sha256_sched as ref_sched
from mpi_blockchain_tpu.ops.sha256_jnp import IV, _bswap32, compress, \
    sha256d_words_from_midstate
from mpi_blockchain_tpu_torch import core
from mpi_blockchain_tpu_torch.backend import get_backend
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig
from mpi_blockchain_tpu_torch.models import fused
from mpi_blockchain_tpu_torch.models.fused import FusedMiner, \
    make_fused_miner
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_block
from chip_smoke import STEP_EDGE_BITS, STEP_EDGE_HEIGHTS, STEP_EDGE_PREVS
from test_exhaustion import ExhaustFirstSpace

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

DIFF = 10
M32 = 0xFFFFFFFF


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32))


def _ref_template(prev: np.ndarray, data: np.ndarray, height: int,
                  bits: int):
    """The reference fused miner's header build (models/fused.py:89-107),
    from its own jnp ``compress`` and ``extend_midstate``."""
    chunk1 = [jnp.uint32(0x01000000)] + [jnp.uint32(v) for v in prev] \
        + [jnp.uint32(v) for v in data[:7]]
    ms = np.asarray(jnp.stack(compress(tuple(jnp.uint32(v) for v in IV),
                                       chunk1)), dtype=np.uint32)
    tail = np.array([data[7], _bswap32(np.uint32(height)),
                     _bswap32(np.uint32(bits)), 0, 0x80000000]
                    + [0] * 10 + [640], dtype=np.uint32)
    return ms, tail, ref_sched.extend_midstate(ms, tail)


def _header(prev: np.ndarray, data: np.ndarray, height: int, bits: int,
            nonce: int = 0) -> bytes:
    return (struct.pack("<I", 1) + prev.astype(">u4").tobytes()
            + data.astype(">u4").tobytes()
            + struct.pack("<III", height, bits, nonce))


# The step kernel's edge cases (chip_smoke.step_edge_cases): every prev
# word all-zero or all-ones, at each edge difficulty. The plain step, which
# the kernel is held to on the card, is held here to the reference there.
EDGES = [pytest.param((pv, bits), id=f"prev{pv:#x}-bits{bits}")
         for pv in STEP_EDGE_PREVS for bits in STEP_EDGE_BITS]


@pytest.mark.parametrize("seed", [1, 2, 3, *EDGES])
def test_block_template_matches_the_reference_header_build(seed):
    edge = isinstance(seed, tuple)
    rng = np.random.default_rng(list(seed) if edge else seed)
    prev = rng.integers(0, 1 << 32, (4, 8), dtype=np.uint32)
    data = rng.integers(0, 1 << 32, (4, 8), dtype=np.uint32)
    heights = [0, 1, int(rng.integers(0, 1 << 32)), M32]
    bits = int(rng.integers(0, 65))
    if edge:
        prev[:], bits = seed
    ms, tail, ext = sha256_block.block_template(
        _u32(prev), _u32(data), torch.tensor(heights), bits)
    for i, h in enumerate(heights):
        want = _ref_template(prev[i], data[i], h, bits)
        for got, ref in zip((ms[i], tail[i], ext[i]), want):
            assert got.tolist() == ref.tolist()
        # The C++ core's midstate of the same header agrees too.
        c_ms, c_tail = ref_core.header_midstate(_header(prev[i], data[i], h,
                                                        bits))
        assert ms[i].tolist() == c_ms.tolist()
        assert tail[i, :3].tolist() == c_tail[:3].tolist()
    # One block at a time, with an int height, gives the same words.
    one = sha256_block.block_template(_u32(prev[2]), _u32(data[2]),
                                      heights[2], bits)
    assert [t.tolist() for t in one] == [ms[2].tolist(), tail[2].tolist(),
                                         ext[2].tolist()]


@pytest.mark.parametrize("seed", [4, 5, *EDGES])
def test_winner_digest_matches_the_reference_and_header_hash(seed):
    edge = isinstance(seed, tuple)
    rng = np.random.default_rng(list(seed) if edge else seed)
    prev = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
    data = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
    heights, bits = [int(rng.integers(0, 1 << 32))], DIFF
    nonces = [0, M32, *(int(n) for n in rng.integers(0, 1 << 32, 4))]
    if edge:
        (prev[:], bits), heights = seed, list(STEP_EDGE_HEIGHTS)
    for height in heights:
        ms, tail, _ = sha256_block.block_template(_u32(prev), _u32(data),
                                                  height, bits)
        got = sha256_block.winner_digest(ms.expand(len(nonces), 8),
                                         tail.expand(len(nonces), 16),
                                         torch.tensor(nonces))
        ref_ms, ref_tail, _ = _ref_template(prev, data, height, bits)
        ref = np.stack([np.asarray(w) for w in sha256d_words_from_midstate(
            ref_ms, ref_tail, _bswap32(np.array(nonces, dtype=np.uint32)))],
            -1)
        assert got.tolist() == ref.tolist()
        for i, nonce in enumerate(nonces):
            digest = ref_core.header_hash(_header(prev, data, height, bits,
                                                  nonce))
            assert got[i].numpy().astype(">u4").tobytes() == digest
            assert sha256_block.winner_digest(ms, tail, nonce).tolist() \
                == got[i].tolist()


def test_step_on_the_cpu_is_the_plain_step_and_checks_its_buffer():
    rng = np.random.default_rng(6)
    prev = _u32(rng.integers(0, 1 << 32, 8, dtype=np.uint32))
    data = _u32(rng.integers(0, 1 << 32, (2, 8), dtype=np.uint32))
    cpu = torch.device("cpu")
    a, b = sha256_block.new_scratch(cpu), sha256_block.new_scratch(cpu)
    sha256_block.step(a, prev=prev, data=data[0], height=7,
                      difficulty_bits=DIFF)
    sha256_block.step_plain(b, prev=prev, data=data[0], height=7,
                            difficulty_bits=DIFF)
    assert torch.equal(a, b)
    words = a.view(torch.uint32).tolist()
    ms, tail, ext = sha256_block.block_template(prev, data[0], 7, DIFF)
    assert words[:4] == [0, M32, 0, 0]
    assert words[4:24] == ext.tolist() and words[24:32] == ms.tolist()
    assert words[32:] == tail.tolist()
    # The repeated step times the kernel: it has no CPU path.
    c = sha256_block.new_scratch(cpu)
    with pytest.raises(ConfigError, match="on a CUDA device, not cpu"):
        sha256_block.step_repeat(3, c, prev=prev, data=data[0], height=7,
                                 difficulty_bits=DIFF)
    with pytest.raises(ValueError, match="n must be >= 1"):
        sha256_block.step_repeat(0, c, prev=prev)
    assert torch.equal(c, sha256_block.new_scratch(cpu))
    # Finalize with the sentinel in the result buffer, then build on it.
    a.view(torch.uint32)[1] = M32
    nonce = torch.zeros(1, dtype=torch.uint32)
    tip = torch.zeros(8, dtype=torch.uint32)
    sha256_block.step(a, nonce_out=nonce, tip_out=tip)
    assert nonce.tolist() == [M32]
    assert tip.tolist() == sha256_block.winner_digest(ms, tail, M32).tolist()
    with pytest.raises(ValueError, match="needs prev"):
        sha256_block.step(a, data=data[1])
    with pytest.raises(ValueError, match="new_scratch"):
        sha256_block.step(a[:8], prev=prev, data=data[1])


def _payload_words(cfg, start: int, k: int) -> np.ndarray:
    return np.stack([fused._words_be(core.sha256d(cfg.payload(start + j + 1)))
                     for j in range(k)])


def _sentinel_prefix(cap: int) -> str:
    """A data prefix whose height-1 block (on genesis) has no difficulty
    DIFF winner in [0, cap)."""
    genesis = core.Node(DIFF).tip_hash
    for i in range(400):
        prefix = f"cap{i}"
        hdr = core.make_candidate_header(
            genesis, f"{prefix}:1".encode(), 1, DIFF)
        if core.cpu_search(hdr, 0, cap, DIFF)[0] is None:
            return prefix
    pytest.fail("no prefix leaves [0, cap) without a winner")


@pytest.mark.parametrize("max_rounds", [None, 1])
def test_fused_fn_matches_the_reference_make_fused_miner(max_rounds):
    prefix = "block" if max_rounds is None else _sentinel_prefix(1 << 12)
    cfg = MinerConfig(difficulty_bits=DIFF, data_prefix=prefix,
                      device="cpu")
    prev = fused._words_be(core.Node(DIFF).tip_hash)
    data = _payload_words(cfg, 0, 4)
    ours = make_fused_miner(4, 12, DIFF, device="cpu", max_rounds=max_rounds)
    nonces, tip = ours(_u32(prev), _u32(data), 0)
    ref = ref_make_fused_miner(4, 12, DIFF, kernel="jnp",
                               max_rounds=max_rounds)
    ref_nonces, ref_tip = ref(jnp.asarray(prev), jnp.asarray(data),
                              np.uint32(0))
    assert nonces.dtype == tip.dtype == torch.uint32
    assert nonces.tolist() == np.asarray(ref_nonces).tolist()
    assert tip.tolist() == np.asarray(ref_tip).tolist()
    if max_rounds == 1:
        assert nonces.tolist()[0] == M32       # the sentinel, carried on


@pytest.fixture(scope="module")
def oracle_chain():
    """Six blocks at DIFF from the port's sequential Miner."""
    m = Miner(MinerConfig(difficulty_bits=DIFF, n_blocks=6, device="cpu"),
              pipeline=False)
    m.mine_chain()
    return [m.node.block_hash(i).hex() for i in range(7)]


def test_fused_miner_chain_matches_reference_and_sequential_miner(
        oracle_chain):
    cfg = MinerConfig(difficulty_bits=DIFF, n_blocks=6, batch_pow2=12,
                      device="cpu")
    fm = FusedMiner(cfg, blocks_per_call=4)     # crosses a call boundary
    fm.mine_chain()
    ref = RefFusedMiner(RefConfig(difficulty_bits=DIFF, n_blocks=6,
                                  batch_pow2=12, backend="tpu",
                                  kernel="jnp"),
                        blocks_per_call=4, log_fn=lambda d: None)
    ref.mine_chain()
    assert fm.chain_hashes() == ref.chain_hashes() == oracle_chain
    assert fm.host_waits == 0 and fm.effective_kernel == "torch"


def test_fused_miner_resumes_across_mine_chain_calls(oracle_chain):
    cfg = MinerConfig(difficulty_bits=DIFF, n_blocks=6, batch_pow2=12,
                      device="cpu")
    fm = FusedMiner(cfg, blocks_per_call=4)
    heights = []
    fm.mine_chain(3, on_progress=heights.append)
    fm.mine_chain(3, on_progress=heights.append)
    assert heights == [3, 6]
    assert fm.chain_hashes() == oracle_chain


def _rollover_prefix() -> tuple[str, list[str]]:
    """A data prefix whose base-payload candidates (on the staged chain's
    tips) have no winner in the first 32 nonces, and the chain the port's
    sequential Miner mines through the staged exhaustion."""
    for i in range(64):
        cfg = MinerConfig(difficulty_bits=DIFF, n_blocks=3, backend="cpu",
                          data_prefix=f"roll{i}")
        m = Miner(cfg, backend=ExhaustFirstSpace(get_backend("cpu"), cfg),
                  pipeline=False)
        m.mine_chain()
        if all(core.cpu_search(core.make_candidate_header(
                m.node.block_hash(h - 1), cfg.payload(h), h, DIFF),
                0, 32, DIFF)[0] is None for h in range(1, 4)):
            return cfg.data_prefix, [m.node.block_hash(h).hex()
                                     for h in range(4)]
    pytest.fail("staging broken: no prefix keeps base winners beyond cap")


def test_fused_rollover_matches_the_sequential_miner_and_the_reference():
    """The device sweep, capped at 2 rounds of 16 nonces, returns the
    sentinel; validation rejects it and ``_recover_block`` rolls over
    through the staged-empty base space: the same chain as the port's and
    the reference's per-block miners through the same stub."""
    prefix, oracle = _rollover_prefix()
    cfg = MinerConfig(difficulty_bits=DIFF, n_blocks=3, batch_pow2=4,
                      device="cpu", data_prefix=prefix)
    fm = FusedMiner(cfg, blocks_per_call=1, recovery_backend=ExhaustFirstSpace(
        get_backend("cpu"), cfg))
    fm._fns[1] = make_fused_miner(1, 4, DIFF, device="cpu", max_rounds=2)
    fm.mine_chain()
    from mpi_blockchain_tpu.backend import get_backend as ref_get_backend
    from mpi_blockchain_tpu.models.miner import Miner as RefMiner
    ref_cfg = RefConfig(difficulty_bits=DIFF, n_blocks=3, backend="cpu",
                        data_prefix=prefix)
    ref = RefMiner(ref_cfg, backend=ExhaustFirstSpace(ref_get_backend("cpu"),
                                                      ref_cfg),
                   log_fn=lambda d: None)
    ref.mine_chain()
    assert fm.chain_hashes() == oracle == ref.chain_hashes()
    for h in range(1, 4):
        f = core.HeaderFields.unpack(fm.node.block_header(h))
        assert f.data_hash == core.sha256d(cfg.payload(h, extra_nonce=1))


def test_fused_missed_nonce_is_kernel_bug_not_rollover():
    """A winner in the space the device called empty is a kernel bug:
    rolling over would fork the chain away from every other driver."""
    for i in range(32):
        cfg = MinerConfig(difficulty_bits=DIFF, n_blocks=1, batch_pow2=4,
                          device="cpu", data_prefix=f"kbug{i}")
        cand = core.Node(DIFF).make_candidate(cfg.payload(1))
        n, _ = core.cpu_search(cand, 0, 1 << 32, DIFF)
        if n is not None and n >= 16:
            break
    else:
        pytest.fail("staging broken: no prefix with winner beyond cap")
    fm = FusedMiner(cfg, blocks_per_call=1)
    fm._fns[1] = make_fused_miner(1, 4, DIFF, device="cpu", max_rounds=1)
    with pytest.raises(RuntimeError, match="kernel bug"):
        fm.mine_chain()
    assert fm.node.height == 0


def test_pipeline_dispatch_accounting_and_recovery_discard():
    """Each call is dispatched once, in height order; after a failed
    validation the calls in flight are dropped and dispatched again from
    the recovered tip."""
    for i in range(32):
        cfg = MinerConfig(difficulty_bits=DIFF, n_blocks=4, batch_pow2=4,
                          device="cpu", data_prefix=f"pipe{i}")
        cand = core.Node(DIFF).make_candidate(cfg.payload(1))
        n, _ = core.cpu_search(cand, 0, 16, DIFF)
        if n is None:
            break
    else:
        pytest.fail("staging broken")
    fm = FusedMiner(cfg, blocks_per_call=1,
                    recovery_backend=ExhaustFirstSpace(get_backend("cpu"),
                                                       cfg))
    capped = make_fused_miner(1, 4, DIFF, device="cpu", max_rounds=1)
    real = make_fused_miner(1, 4, DIFF, device="cpu")
    dispatch_heights = []

    def spy(prev, data, h):
        dispatch_heights.append(h)
        return (capped if h == 0 else real)(prev, data, h)

    fm._fns[1] = spy
    fm.mine_chain()
    assert fm.node.height == 4
    depth = min(4, FusedMiner.PIPELINE_DEPTH)
    assert dispatch_heights[:depth] == list(range(depth))
    assert dispatch_heights.count(0) == 1
    assert dispatch_heights[-3:] == [1, 2, 3]
    assert core.Node(DIFF).load(fm.node.save())
    f = core.HeaderFields.unpack(fm.node.block_header(1))
    assert f.data_hash == core.sha256d(cfg.payload(1, extra_nonce=1))


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_mine_fused_out_bytes_match_reference_and_per_block(tmp_path,
                                                            capsys):
    flags = ["--difficulty", str(DIFF), "--blocks", "5", "--batch-pow2",
             "12", "--blocks-per-call", "2"]
    ours, plain, ref = (tmp_path / n for n in ("f.bin", "p.bin", "r.bin"))
    assert main(["mine", "--device", "cpu", "--fused", *flags,
                 "--out", str(ours)]) == 0
    summary = _last_json(capsys)
    assert summary["fused"] is True and summary["height"] == 5
    assert "hashes_tried" not in summary and summary["kernel"] == "torch"
    assert main(["mine", "--device", "cpu", *flags, "--out",
                 str(plain)]) == 0
    assert _last_json(capsys)["fused"] is False
    assert ref_main(["mine", "--fused", "--backend", "tpu", "--kernel",
                     "jnp", *flags, "--out", str(ref)]) == 0
    ref_summary = _last_json(capsys)
    assert ours.read_bytes() == plain.read_bytes() == ref.read_bytes()
    assert summary["tip_hash"] == ref_summary["tip_hash"]


def test_mine_fused_without_a_card_is_a_clean_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["mine", "--fused", "--difficulty", "8", "--blocks",
                 "1"]) == 2
    out = _last_json(capsys)
    assert out["event"] == "error" and "no CUDA device" in out["error"]


def test_fused_configuration_errors():
    cpu = MinerConfig(device="cpu")
    with pytest.raises(ConfigError, match="blocks_per_call"):
        FusedMiner(cpu, blocks_per_call=0)
    with pytest.raises(ConfigError, match="cuda backend"):
        FusedMiner(MinerConfig(backend="cpu"))
    with pytest.raises(ConfigError, match="n_miners"):
        FusedMiner(MinerConfig(device="cpu", n_miners=0))
    with pytest.raises(ConfigError, match="needs a CUDA device"):
        make_fused_miner(2, 12, DIFF, kernel="cuda", device="cpu")
    with pytest.raises(ConfigError, match="max_rounds"):
        make_fused_miner(2, 12, DIFF, device="cpu", max_rounds=0)
    assert fused.sweep_cap(12) == 1 << 32
    assert fused.sweep_cap(12, 3) == 3 << 12
    assert fused.sweep_cap(20, 1 << 20) == 1 << 32
    fn = make_fused_miner(2, 12, DIFF, device="cpu")
    prev = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(ValueError, match=r"\(2, 8\)"):
        fn(prev, torch.zeros(3, 8, dtype=torch.uint32), 0)
    with pytest.raises(ValueError, match="cap"):
        sha256_block.mine_k(prev, torch.zeros(1, 8, dtype=torch.uint32), 0,
                            DIFF, 0)


_SASS_STEP = """
        Function : _ZN12_GLOBAL__N_117block_step_kernelILb1EEEvPKjS2_PjS3_S3_jjPy
        /*0000*/                   CS2R R2, SR_CLOCKLO ;
        /*0010*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_117block_step_kernelILb0EEEvPKjS2_PjS3_S3_jjPy
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   SHF.R.W.U32.HI R5, R2, 0x7, R2 ;
        /*0020*/                   LOP3.LUT R6, R5, R3, R2, 0x96, !PT ;
        /*0030*/                   IADD3 R7, R6, R5, R3 ;
        /*0040*/                   SHF.R.W.U32.HI R8, R7, 0x7, R7 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60 ;
        Function : _ZN12_GLOBAL__N_120sha256d_sweep_kernelILi1ELb0ELb1ELb0EEEvNS_9SweepArgsEPjPy
        /*0000*/                   SHF.R.U32.HI R2, RZ, 0x3, R0 ;
"""


def test_function_census_counts_the_whole_step_kernel():
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    census = sha256_cuda.function_census(_SASS_STEP,
                                         sha256_cuda.STEP_KERNEL_SYMBOL)
    assert census == {"SHF": 2, "LDC": 1, "LOP3": 1, "IADD3": 1, "EXIT": 1,
                      "BRA": 1}
    with pytest.raises(ValueError, match="not in the disassembly"):
        sha256_cuda.function_census(_SASS_STEP, "no_such_kernel")


_PTXAS_LOG = """
ptxas info    : 0 bytes gmem, 336 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117block_step_kernelILb1EEEvPKjS2_PjS3_S3_jjPy' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117block_step_kernelILb1EEEvPKjS2_PjS3_S3_jjPy
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 100 registers, used 0 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117block_step_kernelILb0EEEvPKjS2_PjS3_S3_jjPy' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117block_step_kernelILb0EEEvPKjS2_PjS3_S3_jjPy
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 412 bytes cmem[0]
"""


def test_ptxas_report_reads_the_production_step_kernel():
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    assert sha256_cuda.ptxas_report(_PTXAS_LOG,
                                    sha256_cuda.STEP_KERNEL_SYMBOL) == {
        "registers": 96, "stack_bytes": 0, "spill_store_bytes": 0,
        "spill_load_bytes": 0}
    assert sha256_cuda.ptxas_report(_PTXAS_LOG, "block_step_kernelILb1E")[
        "stack_bytes"] == 8
    with pytest.raises(ValueError, match="nothing for sha256d_sweep"):
        sha256_cuda.ptxas_report(_PTXAS_LOG, "sha256d_sweep_kernel")
    assert "-Xptxas" in sha256_cuda.NVCC_FLAGS


def test_step_variants_patch_the_shipped_source(monkeypatch):
    from mpi_blockchain_tpu_torch.ops import sha256_cuda
    from mpi_blockchain_tpu_torch.tools import step_variants

    source = sha256_cuda.SOURCE.read_text()
    assert step_variants.variant_source("shipped") == source
    sources = {name: step_variants.variant_source(name)
               for name in step_variants.VARIANTS}
    assert len(set(sources.values())) == len(sources)
    # Each design choice is timed against the build without it.
    assert "#pragma unroll 1\n  for (int c = 0" in sources["compact_1"]
    assert "#pragma unroll 1\n  for (int t = 0" in sources["compact_2"]
    assert 'asm volatile("griddepcontrol.wait' in source
    assert 'asm volatile("griddepcontrol.wait' not in sources["no_pdl"]
    assert "config.numAttrs = 0;" in sources["no_pdl"]
    in_order = sources["loads_in_order"]
    assert "block_step_kernel(const uint32_t* prev," in in_order
    body = in_order[in_order.index("block_step_kernel(const"):]
    assert body.index("*nonce_out = nonce;") \
        < body.index("load_words(m, tail);") \
        < body.index("load_words(dw, data);")
    assert sources["first_shape"].count("__restrict__") \
        == sources["loads_in_order"].count("__restrict__")
    monkeypatch.setitem(step_variants.VARIANTS, "stale",
                        [("no such line", "")])
    with pytest.raises(ValueError, match="0 times, not once"):
        step_variants.variant_source("stale")
