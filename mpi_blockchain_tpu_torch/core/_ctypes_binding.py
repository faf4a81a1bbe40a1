"""ctypes binding over the chain core's C ABI (``csrc/capi.cpp``).

Headers cross the boundary as 80-byte blobs and hashes as 32-byte
digests. Pointers go in as ``c_void_p`` and 64-bit counts as
``c_uint64``. The library is built and loaded at first use, not at import.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from .build import ensure_built

HEADER_SIZE = 80
NOT_FOUND = 2**64 - 1

_P = ctypes.c_void_p
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_SIGNATURES = {
    # name: (argtypes, restype)
    "cc_sha256": ([_P, _U64, _P], None),
    "cc_sha256d": ([_P, _U64, _P], None),
    "cc_header_hash": ([_P, _P], None),
    "cc_leading_zero_bits": ([_P], ctypes.c_int),
    "cc_header_midstate": ([_P, _P, _P], None),
    "cc_search": ([_P, _U64, _U64, _U32, _P], _U64),
    "cc_node_new": ([_U32, ctypes.c_int], _P),
    "cc_node_free": ([_P], None),
    "cc_node_height": ([_P], _U64),
    "cc_node_difficulty": ([_P], _U32),
    "cc_node_tip_hash": ([_P, _P], None),
    "cc_node_block_hash": ([_P, _U64, _P], None),
    "cc_node_block_header": ([_P, _U64, _P], None),
    "cc_node_make_candidate": ([_P, _P, _U64, _P], None),
    "cc_node_submit": ([_P, _P], ctypes.c_int),
    "cc_node_receive": ([_P, _P], ctypes.c_int),
    "cc_node_adopt_chain": ([_P, _P, _U64], ctypes.c_int),
    "cc_node_adopt_suffix": ([_P, _U64, _P, _U64], ctypes.c_int),
    "cc_node_find": ([_P, _P], ctypes.c_int64),
    "cc_node_headers_from": ([_P, _U64, _P], _U64),
    "cc_node_save": ([_P, _P], _U64),
    "cc_node_load": ([_P, _P, _U64], ctypes.c_int),
    "cc_node_rollback": ([_P, _U64], None),
    "cc_node_set_retarget": ([_P, _U32, _U32, _U32], ctypes.c_int),
    "cc_node_next_bits": ([_P], _U32),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(ensure_built()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _out_buf(n: int):
    return (ctypes.c_uint8 * n)()


def _check_len(buf: bytes, n: int, what: str) -> None:
    if len(buf) != n:
        raise ValueError(f"{what} must be {n} bytes, got {len(buf)}")


def sha256(data: bytes) -> bytes:
    out = _out_buf(32)
    _lib().cc_sha256(data, len(data), out)
    return bytes(out)


def sha256d(data: bytes) -> bytes:
    out = _out_buf(32)
    _lib().cc_sha256d(data, len(data), out)
    return bytes(out)


def header_hash(header80: bytes) -> bytes:
    _check_len(header80, HEADER_SIZE, "header")
    out = _out_buf(32)
    _lib().cc_header_hash(header80, out)
    return bytes(out)


def leading_zero_bits(digest32: bytes) -> int:
    _check_len(digest32, 32, "digest")
    return _lib().cc_leading_zero_bits(digest32)


def header_midstate(header80: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Midstate after chunk 1 and the 16 chunk-2 words (nonce at word 3),
    as uint32 arrays of shape (8,) and (16,)."""
    _check_len(header80, HEADER_SIZE, "header")
    state = (ctypes.c_uint32 * 8)()
    tail = (ctypes.c_uint32 * 16)()
    _lib().cc_header_midstate(header80, state, tail)
    return (np.frombuffer(bytes(state), np.uint32).copy(),
            np.frombuffer(bytes(tail), np.uint32).copy())


def cpu_search(header80: bytes, start_nonce: int, count: int,
               difficulty_bits: int) -> tuple[int | None, int]:
    """Sequential lowest-nonce search over [start, start + count) clamped
    to 2^32. Returns (nonce or None, hashes_tried)."""
    _check_len(header80, HEADER_SIZE, "header")
    tried = ctypes.c_uint64(0)
    n = _lib().cc_search(header80, start_nonce, count, difficulty_bits,
                         ctypes.byref(tried))
    return (None if n == NOT_FOUND else n), tried.value


class Node:
    """Handle to a C++ ``chaincore::Node``: the canonical chain state."""

    def __init__(self, difficulty_bits: int, node_id: int = 0):
        self._lib = _lib()
        self._h = self._lib.cc_node_new(difficulty_bits, node_id)
        self.node_id = node_id

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cc_node_free(h)
            self._h = None

    @property
    def height(self) -> int:
        return self._lib.cc_node_height(self._h)

    @property
    def difficulty_bits(self) -> int:
        return self._lib.cc_node_difficulty(self._h)

    @property
    def tip_hash(self) -> bytes:
        out = _out_buf(32)
        self._lib.cc_node_tip_hash(self._h, out)
        return bytes(out)

    def _check_height(self, height: int) -> None:
        if not 0 <= height <= self.height:
            raise IndexError(f"height {height} not in [0, {self.height}]")

    def block_hash(self, height: int) -> bytes:
        self._check_height(height)
        out = _out_buf(32)
        self._lib.cc_node_block_hash(self._h, height, out)
        return bytes(out)

    def block_header(self, height: int) -> bytes:
        self._check_height(height)
        out = _out_buf(HEADER_SIZE)
        self._lib.cc_node_block_header(self._h, height, out)
        return bytes(out)

    def make_candidate(self, data: bytes) -> bytes:
        out = _out_buf(HEADER_SIZE)
        self._lib.cc_node_make_candidate(self._h, data, len(data), out)
        return bytes(out)

    def submit(self, header80: bytes) -> bool:
        _check_len(header80, HEADER_SIZE, "header")
        return bool(self._lib.cc_node_submit(self._h, header80))

    def receive(self, header80: bytes) -> int:
        _check_len(header80, HEADER_SIZE, "header")
        return self._lib.cc_node_receive(self._h, header80)

    def adopt_chain(self, headers80: list[bytes]) -> int:
        blob = b"".join(headers80)
        _check_len(blob, len(headers80) * HEADER_SIZE, "header blob")
        return self._lib.cc_node_adopt_chain(self._h, blob, len(headers80))

    def adopt_suffix(self, anchor: int, headers80: list[bytes]) -> int:
        """Suffix adoption above a common ancestor (O(suffix) sync)."""
        blob = b"".join(headers80)
        _check_len(blob, len(headers80) * HEADER_SIZE, "header blob")
        return self._lib.cc_node_adopt_suffix(self._h, anchor, blob,
                                              len(headers80))

    def find(self, digest32: bytes) -> int:
        """Height of this block hash on the chain, or -1."""
        _check_len(digest32, 32, "digest")
        return self._lib.cc_node_find(self._h, digest32)

    def headers_from(self, from_height: int) -> list[bytes]:
        """Headers for heights from_height+1..tip."""
        n = max(self.height - from_height, 0)
        out = _out_buf(n * HEADER_SIZE)
        got = self._lib.cc_node_headers_from(self._h, from_height, out)
        blob = bytes(out)
        return [blob[i * HEADER_SIZE:(i + 1) * HEADER_SIZE]
                for i in range(got)]

    def save(self) -> bytes:
        """The whole chain, genesis..tip, as concatenated 80-byte headers
        (the same bytes the reference's ``mine --out`` writes)."""
        out = _out_buf((self.height + 1) * HEADER_SIZE)
        n = self._lib.cc_node_save(self._h, out)
        return bytes(out)[: n * HEADER_SIZE]

    def load(self, blob: bytes) -> bool:
        if not blob or len(blob) % HEADER_SIZE != 0:
            return False
        return bool(self._lib.cc_node_load(self._h, blob,
                                           len(blob) // HEADER_SIZE))

    def rollback(self, new_height: int) -> None:
        self._lib.cc_node_rollback(self._h, new_height)

    def set_retarget(self, interval: int, step: int = 1,
                     max_bits: int = 0) -> bool:
        """Arms the height-scheduled difficulty-retarget rule (interval 0
        disables). False once blocks beyond genesis exist."""
        return bool(self._lib.cc_node_set_retarget(self._h, interval, step,
                                                   max_bits))

    def next_bits(self) -> int:
        """Bits the next block (height+1) must carry under the rule."""
        return self._lib.cc_node_next_bits(self._h)

    def all_headers(self) -> list[bytes]:
        """Headers for heights 1..tip (the adopt_chain wire format)."""
        return self.headers_from(0)
