"""Golden-byte tests for the frozen 80-byte header layout, on the port.

The port's header codec (``mpi_blockchain_tpu_torch.core``) against the
layout of chain.hpp and against the reference's bytes. The header pass of
the port's chainlint checks the offsets this file slices (``cand[a:b]``)
against the frozen field spans.
"""
import hashlib
import struct

import pytest

from mpi_blockchain_tpu import core as ref_core
from mpi_blockchain_tpu_torch import core


def test_layout_golden_bytes():
    node = core.Node(difficulty_bits=8, node_id=0)
    cand = node.make_candidate(b"payload")
    f = core.HeaderFields.unpack(cand)
    assert f.version == 1
    assert f.prev_hash == node.tip_hash
    assert f.data_hash == hashlib.sha256(
        hashlib.sha256(b"payload").digest()).digest()
    assert f.timestamp == 1          # deterministic: == height
    assert f.bits == 8
    assert f.nonce == 0
    assert f.pack() == cand
    # Field offsets, little-endian scalars.
    assert cand[0:4] == struct.pack("<I", 1)
    assert cand[4:36] == node.tip_hash
    assert cand[68:72] == struct.pack("<I", 1)
    assert cand[72:76] == struct.pack("<I", 8)
    assert cand[76:80] == struct.pack("<I", 0)


@pytest.mark.parametrize("bits, payload", [(8, b"payload"), (16, b""),
                                           (24, b"x" * 100)])
def test_candidate_and_python_twin_match_the_reference(bits, payload):
    ours = core.Node(bits, 0).make_candidate(payload)
    ref = ref_core.Node(bits, 0).make_candidate(payload)
    assert ours == ref
    tip = core.Node(bits, 0).tip_hash
    assert core.make_candidate_header(tip, payload, 1, bits) == ours
    assert core.HeaderFields.unpack(ours) == core.HeaderFields(
        *ref_core.HeaderFields.unpack(ref).__dict__.values())


def test_set_nonce_and_hash_match_the_reference():
    hdr = bytes(range(80))
    h2 = core.set_nonce(hdr, 0xDEADBEEF)
    assert h2[:76] == hdr[:76]
    assert struct.unpack("<I", h2[76:])[0] == 0xDEADBEEF
    assert h2 == ref_core.set_nonce(hdr, 0xDEADBEEF)
    assert core.header_hash(h2) == ref_core.header_hash(h2)
