"""The plain reference against the standard library's SHA-256 and against
a short chain that the program's C++ core mines and validates."""
from __future__ import annotations

import random
import struct

import pytest
import torch

from benchmark import reference as ref


def _digest(words, i: int) -> bytes:
    return b"".join(struct.pack(">I", int(w[i]) & ref.M32) for w in words)


def test_digest_words_match_hashlib_on_ints_and_tensors():
    rng = random.Random(5)
    for _ in range(3):
        head = bytes(rng.getrandbits(8) for _ in range(76))
        nonces = [rng.getrandbits(32) for _ in range(40)] \
            + [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
        t = torch.tensor(nonces, dtype=torch.int64)
        on_bytes = ref.digest_words(head, ref._nonce_words(
            torch, torch.tensor(0), t))
        words = [torch.tensor(ref._s32(w), dtype=torch.int32)
                 for w in ref.header_words(head)]
        on_words = ref.digest_words(words, ref._nonce_words(
            torch, torch.tensor(0), t))
        for i, n in enumerate(nonces):
            want = ref.sha256d(head + struct.pack("<I", n))
            assert _digest(on_bytes, i) == want
            assert _digest(on_words, i) == want
            swapped = struct.unpack(">I", struct.pack("<I", n))[0]
            assert b"".join(struct.pack(">I", w) for w in
                            ref.digest_words(head, swapped)) == want


@pytest.mark.parametrize("bits", [1, 4, 8, 12, 33])
def test_scanner_finds_the_lowest_qualifier(bits):
    head = bytes(range(76))
    lz = [ref.leading_zero_bits(ref.sha256d(head + struct.pack("<I", n)))
          for n in range(1 << 14)]
    want = next((n for n, z in enumerate(lz) if z >= bits), None)
    scan = ref.Scanner(bits, "cpu", chunk=1 << 10)
    assert scan.lowest(head, 0, 1 << 14) == want
    if want is not None:
        assert scan.lowest(head, want, want + 1) == want
        assert scan.lowest(head, 0, want) is None
        after = next((n for n in range(want + 1, 1 << 14)
                      if lz[n] >= bits), None)
        assert scan.lowest(head, want + 1, 1 << 14) == after


def test_scanner_reaches_the_top_of_the_nonce_space():
    head = bytes(76)
    top = ref.NONCE_SPACE - 300
    want = next(n for n in range(top, ref.NONCE_SPACE)
                if ref.leading_zero_bits(ref.sha256d(
                    head + struct.pack("<I", n))) >= 4)
    assert ref.Scanner(4, "cpu", 1 << 7).lowest(
        head, top, ref.NONCE_SPACE) == want


def _program_chain(bits: int, n: int, prefix: str):
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner

    miner = Miner(MinerConfig(difficulty_bits=bits, n_blocks=n,
                              backend="cpu", data_prefix=prefix),
                  log_fn=lambda rec: None)
    miner.mine_chain()
    node = miner.node
    return node.save(), [node.block_hash(i) for i in range(n + 1)]


def test_reference_rebuilds_a_d8_chain_of_the_program():
    chain, hashes = _program_chain(8, 12, "seed-3")
    logged = [(h, struct.unpack_from("<I", head, 76)[0])
              for h, head in enumerate(ref.split_chain(chain)[1:], 1)]
    v = ref.check_chain(chain, prefix="seed-3", bits=8, seed=3,
                        block_hashes=hashes, logged=logged,
                        scan_budget=1 << 20)
    assert v.correct and v.blocks == 12 and v.sampled_blocks == 12
    heads = ref.split_chain(chain)
    assert heads[0] == ref.genesis(8)
    for h in range(1, 13):
        assert heads[h][4:36] == ref.sha256d(heads[h - 1])
        assert heads[h][36:68] == ref.sha256d(b"seed-3:%d" % h)
        assert hashes[h] == ref.sha256d(heads[h])


def _with_nonce(chain: bytes, height: int, nonce: int) -> bytes:
    at = height * ref.HEADER + 76
    return chain[:at] + struct.pack("<I", nonce) + chain[at + 4:]


def test_reference_fails_what_breaks_the_rules():
    chain, hashes = _program_chain(8, 12, "seed-4")
    kw = dict(prefix="seed-4", bits=8, seed=4, scan_budget=1 << 20)
    heads = ref.split_chain(chain)
    nonce = struct.unpack_from("<I", heads[5], 76)[0]
    # A nonce that fails proof of work, with the node's hashes.
    bad = _with_nonce(chain, 5, nonce ^ 1)
    v = ref.check_chain(bad, block_hashes=hashes, **kw)
    assert not v.correct and v.hash_mismatch >= 1
    # A later qualifier of the same header: valid work, not the lowest;
    # its children no longer link.
    later = next(n for n in range(nonce + 1, 1 << 20)
                 if ref.leading_zero_bits(ref.sha256d(
                     heads[5][:76] + struct.pack("<I", n))) >= 8)
    v = ref.check_chain(_with_nonce(chain, 5, later), **kw)
    assert not v.correct and v.not_lowest >= 1 and v.header_mismatch >= 1
    # The wrong payload prefix, the wrong difficulty, logged blocks that
    # are not the chain's, a diverging rank.
    assert ref.check_chain(chain, prefix="seed-5", bits=8, seed=4
                           ).header_mismatch == 12
    assert not ref.check_chain(chain, prefix="seed-4", bits=9, seed=4
                               ).correct
    logged = [(h, struct.unpack_from("<I", heads[h], 76)[0])
              for h in range(1, 13)]
    assert ref.check_chain(chain, logged=logged, **kw).correct
    for wrong in (logged[:-1], logged + [(13, 0)],
                  logged[:4] + [(5, later)] + logged[5:]):
        assert ref.check_chain(chain, logged=wrong, **kw
                               ).logged_mismatch == 1
    assert ref.check_chain(chain, others=[bad], **kw).rank_divergence == 1
    assert ref.check_chain(chain, others=[chain], **kw).correct


def test_needed_nonces_counts_empty_spaces_whole():
    assert ref.needed_nonces(0) == 1
    assert ref.needed_nonces(41, 2) == 2 * (1 << 32) + 42
