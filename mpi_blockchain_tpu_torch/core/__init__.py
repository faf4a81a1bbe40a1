"""Python surface of the port's C++ chain core.

The C++ ``Block``/``Chain``/``Node`` classes (``csrc/``, a verbatim copy
of the reference's core) stay the canonical chain state, so a chain mined
by either package is bit-identical. This module is a thin veneer over the
ctypes binding plus the header helpers the miner needs.
"""
from __future__ import annotations

import dataclasses
import struct

from ._ctypes_binding import (HEADER_SIZE, NOT_FOUND, Node,  # noqa: F401
                              cpu_search, header_hash, header_midstate,
                              leading_zero_bits, sha256, sha256d)


@dataclasses.dataclass(frozen=True)
class HeaderFields:
    """Decoded view of the frozen 80-byte header layout (chain.hpp)."""
    version: int
    prev_hash: bytes
    data_hash: bytes
    timestamp: int
    bits: int
    nonce: int

    @classmethod
    def unpack(cls, header80: bytes) -> "HeaderFields":
        v, = struct.unpack_from("<I", header80, 0)
        t, b, n = struct.unpack_from("<III", header80, 68)
        return cls(v, header80[4:36], header80[36:68], t, b, n)

    def pack(self) -> bytes:
        return (struct.pack("<I", self.version) + self.prev_hash +
                self.data_hash + struct.pack("<III", self.timestamp,
                                             self.bits, self.nonce))


def set_nonce(header80: bytes, nonce: int) -> bytes:
    """Returns the header with its nonce field (bytes 76..80, LE) replaced."""
    return header80[:76] + struct.pack("<I", nonce)


def make_candidate_header(prev_hash: bytes, data: bytes, height: int,
                          bits: int) -> bytes:
    """Python twin of ``Node::make_candidate`` for a known prev digest:
    version 1, timestamp == height, nonce 0. The pipelined miner builds
    the next block's candidate from the winner's digest before the C++
    append lands, and re-checks it against ``node.make_candidate`` at the
    next block boundary."""
    return HeaderFields(version=1, prev_hash=prev_hash,
                        data_hash=sha256d(data), timestamp=int(height),
                        bits=int(bits), nonce=0).pack()


class RecvResult:
    """Mirror of chaincore::RecvResult."""
    APPENDED = 0
    DUPLICATE = 1
    STALE_OR_FORK = 2
    INVALID = 3
    REORGED = 4
    IGNORED_SHORTER = 5
