"""The plain reference that decides ``correct``.

A straightforward implementation of the chain's rules, independent of the
program under test: SHA-256 from the standard library (``hashlib``) for
each header, a SHA-256 compression written out in plain Python for the
header's first chunk, and a plain PyTorch scan (elementwise tensor ops,
no kernel of the program) that looks for a qualifying nonce below a
block's winner. It imports nothing of the program.

The chain's rules, as the program states them:

* genesis: version 1, prev 0^32, data hash sha256d(b"genesis"),
  timestamp 0, bits = difficulty, nonce 0; exempt from proof of work;
* block h: version 1 (uint32 LE), the parent's sha256d, sha256d of the
  payload ``f"{prefix}:{h}"`` (with ``b":x<k>"`` appended when the k
  spaces before it held no qualifier), timestamp h, bits = difficulty,
  nonce (uint32 LE): 80 bytes;
* the nonce is the lowest in [0, 2^32) whose header's sha256d has at
  least ``difficulty`` leading zero bits (read from digest byte 0, most
  significant bit first).
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
import struct

M32 = 0xFFFFFFFF
HEADER = 80
NONCE_SPACE = 1 << 32

# FIPS 180-4: the first 32 bits of the fractional parts of the cube roots
# of the first 64 primes, and of the square roots of the first 8.
K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)


def sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def payload(prefix: str, height: int, extra_nonce: int = 0) -> bytes:
    data = f"{prefix}:{height}".encode()
    return data if extra_nonce == 0 else data + b":x%d" % extra_nonce


def header(prev: bytes, data_hash: bytes, height: int, bits: int,
           nonce: int) -> bytes:
    return (struct.pack("<I", 1) + prev + data_hash
            + struct.pack("<III", height, bits, nonce))


def genesis(bits: int) -> bytes:
    return header(bytes(32), sha256d(b"genesis"), 0, bits, 0)


def leading_zero_bits(digest: bytes) -> int:
    value = int.from_bytes(digest, "big")
    return 256 - value.bit_length()


# ---- SHA-256 on words: Python ints, or int32 tensors of nonces ----------
# A word is a Python int in [0, 2^32) or an int32 tensor holding the same
# 32 bits (two's complement): tensor adds wrap mod 2^32 as the function
# wants, and a right shift masks off the sign's copies. Constants fold as
# ints, so what does not depend on the nonce is computed once.

def _s32(c: int) -> int:
    return c - (1 << 32) if c >= 1 << 31 else c


def _add(*xs):
    const = sum(x for x in xs if isinstance(x, int)) & M32
    out = None
    for x in xs:
        if not isinstance(x, int):
            out = x if out is None else out + x
    if out is None:
        return const
    return out + _s32(const) if const else out


def _bit(op, x, y):
    if isinstance(x, int) and isinstance(y, int):
        return op(x, y)
    return op(_s32(x) if isinstance(x, int) else x,
              _s32(y) if isinstance(y, int) else y)


def _xor(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = _bit(lambda p, q: p ^ q, out, x)
    return out


def _and(x, y):
    return _bit(lambda p, q: p & q, x, y)


def _shr(x, n: int):
    if isinstance(x, int):
        return x >> n
    return (x >> n) & ((1 << (32 - n)) - 1)


def _rotr(x, n: int):
    if isinstance(x, int):
        return ((x >> n) | (x << (32 - n))) & M32
    return _shr(x, n) | (x << (32 - n))


def _compress(state, w: list):
    """SHA-256's compression of the 16 words ``w`` from ``state``, the
    feed-forward included."""
    w = list(w)
    for r in range(16, 64):
        x, y = w[r - 15], w[r - 2]
        s0 = _xor(_rotr(x, 7), _rotr(x, 18), _shr(x, 3))
        s1 = _xor(_rotr(y, 17), _rotr(y, 19), _shr(y, 10))
        w.append(_add(w[r - 16], s0, w[r - 7], s1))
    a, b, c, d, e, f, g, h = state
    for r in range(64):
        t1 = _add(h, _xor(_rotr(e, 6), _rotr(e, 11), _rotr(e, 25)),
                  _xor(g, _and(e, _xor(f, g))), K[r], w[r])
        t2 = _add(_xor(_rotr(a, 2), _rotr(a, 13), _rotr(a, 22)),
                  _xor(b, _and(_xor(a, b), _xor(b, c))))
        h, g, f, e, d, c, b, a = g, f, e, _add(d, t1), c, b, a, \
            _add(t1, t2)
    return [_add(x, y) for x, y in zip((a, b, c, d, e, f, g, h), state)]


def _be_words(chunk: bytes) -> list[int]:
    return list(struct.unpack(">16I", chunk))


def header_words(head76: bytes) -> list[int]:
    """The 11 words a header's nonce is hashed with: the midstate of its
    first 64 bytes and chunk-2 words 0..2."""
    return (_compress(IV, _be_words(head76[:64]))
            + list(struct.unpack(">3I", head76[64:76])))


def digest_words(head, nonce_word):
    """The 8 digest words (big-endian) of sha256d(header): ``head`` the
    76 bytes before the nonce, or their ``header_words`` (ints or int32
    tensors); ``nonce_word`` the nonce as chunk-2 word 3 reads it (the
    byte-swapped nonce), an int or an int32 tensor."""
    if isinstance(head, bytes):
        head = header_words(head)
    tail = list(head[8:11]) + [nonce_word, 0x80000000] + [0] * 10 + [640]
    first = _compress(head[:8], tail)
    return _compress(IV, first + [0x80000000] + [0] * 6 + [256])


def _top_zero(x, n: int):
    """True where the top ``n`` (1..32) bits of the word are zero."""
    return x == 0 if n >= 32 else _shr(x, 32 - n) == 0


def _qualifies(h0, h1, bits: int):
    if bits <= 32:
        return _top_zero(h0, max(bits, 1)) | (bits <= 0)
    return (h0 == 0) & _top_zero(h1, min(bits - 32, 32))


def _nonce_words(torch, base, offsets):
    """The byte-swapped nonces base + offsets as int32 words."""
    n = base + offsets
    w = (((n & 0xFF) << 24) | ((n & 0xFF00) << 8)
         | ((n >> 8) & 0xFF00) | ((n >> 24) & 0xFF))
    return (w - ((w >> 31) << 32)).to(torch.int32)


class Scanner:
    """Finds the lowest qualifying nonce of a range of a header: a plain
    PyTorch scan of every nonce, ``chunk`` at a time, on ``device``. The
    header's words and the chunk's base are tensors, so on a card one
    chunk's elementwise ops are captured once into a CUDA graph and
    replayed for every chunk of every header."""

    def __init__(self, bits: int, device="cpu", chunk: int = 1 << 20):
        import torch

        self.torch, self.bits, self.chunk = torch, bits, chunk
        self.device = torch.device(device)
        self.offsets = torch.arange(chunk, dtype=torch.int64,
                                    device=self.device)
        self.base = torch.zeros((), dtype=torch.int64, device=self.device)
        self.end = torch.zeros((), dtype=torch.int64, device=self.device)
        self.words = torch.zeros(11, dtype=torch.int32, device=self.device)
        self._step = self._first_hit
        if self.device.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._first_hit()
            torch.cuda.current_stream(self.device).wait_stream(side)
            with torch.cuda.graph(graph):
                out = self._first_hit()

            def replay(n=None):
                graph.replay()
                return out
            self._step = replay

    def _first_hit(self, n: int | None = None):
        torch = self.torch
        offsets = self.offsets[:n]
        nonces = self.base + offsets
        h = digest_words(list(self.words.unbind()),
                         _nonce_words(torch, self.base, offsets))
        hit = _qualifies(h[0], h[1], self.bits) & (nonces < self.end) \
            & self.searched(nonces)
        return hit.any(), hit.to(torch.int8).argmax()

    def searched(self, nonces):
        """Which of ``nonces`` the scan looks at: all of them."""
        return True

    def lowest(self, head76: bytes, lo: int, hi: int) -> int | None:
        """The lowest nonce in [lo, hi) whose header qualifies, or None."""
        words = [_s32(w) for w in header_words(head76)]
        self.words.copy_(self.torch.tensor(words, dtype=self.torch.int32))
        self.end.fill_(hi)
        for b in range(lo, hi, self.chunk):
            self.base.fill_(b)
            found, index = self._step(min(self.chunk, hi - b))
            if bool(found):
                return b + int(index)
        return None


# ---- the comparison -------------------------------------------------------

@dataclasses.dataclass
class Verdict:
    """What the comparison found: counts of blocks at fault (each limit
    0) and what was scanned."""
    blocks: int = 0
    header_mismatch: int = 0      # bytes differ from the rebuilt header
    hash_mismatch: int = 0        # the program's block hash is not sha256d
    pow_fail: int = 0             # fewer leading zero bits than required
    not_lowest: int = 0           # a lower nonce qualifies (sampled blocks)
    rank_divergence: int = 0      # ranks whose chain differs from rank 0's
    logged_mismatch: int = 0      # blocks the driver logged, not the chain's
    sampled_blocks: int = 0
    sampled_nonces: int = 0
    failed_heights: list = dataclasses.field(default_factory=list)

    LIMITED = ("header_mismatch", "hash_mismatch", "pow_fail", "not_lowest",
               "rank_divergence", "logged_mismatch")

    def compared(self) -> dict:
        """Each number compared beside its limit."""
        return {name: {"value": getattr(self, name), "limit": 0}
                for name in self.LIMITED}

    @property
    def correct(self) -> bool:
        return self.blocks > 0 and all(getattr(self, name) == 0
                                       for name in self.LIMITED)

    @property
    def failed(self) -> int:
        return len(set(self.failed_heights)) + self.rank_divergence \
            + self.logged_mismatch


def split_chain(blob: bytes) -> list[bytes]:
    if len(blob) % HEADER:
        raise ValueError(f"a chain is whole 80-byte headers, got "
                         f"{len(blob)} bytes")
    return [blob[i:i + HEADER] for i in range(0, len(blob), HEADER)]


def check_chain(blob: bytes, *, prefix: str, bits: int, seed: int,
                block_hashes: list[bytes] | None = None,
                logged: list[tuple[int, int]] | None = None,
                others: list[bytes] = (), scan_budget: int = 1 << 27,
                scan_blocks: int = 64, device="cpu",
                max_extra_nonce: int = 4) -> Verdict:
    """Holds the chain ``blob`` (genesis..tip, as the program's node saved
    it) to the rules: every header rebuilt from the payloads, its hash,
    its proof of work, its link; ``block_hashes``, the node's own hash of
    each block, against sha256d of the header; ``others``, the chains of
    the other ranks, byte for byte against this one; ``logged``, the
    (height, nonce) of each block the driver saw appended, against the
    chain's. Whether a block's nonce is the lowest is scanned
    for a sample of blocks drawn from ``seed``, in that order, until
    ``scan_blocks`` blocks or ``scan_budget`` nonces are scanned."""
    heads = split_chain(blob)
    v = Verdict(blocks=len(heads) - 1)
    if logged is not None and logged != [
            (h, struct.unpack_from("<I", heads[h], 76)[0])
            for h in range(1, len(heads))]:
        v.logged_mismatch = 1
    v.rank_divergence = sum(1 for o in others if o != blob)
    if not heads or heads[0] != genesis(bits):
        v.header_mismatch += 1
        v.failed_heights.append(0)
        return v
    prev = sha256d(heads[0])
    extras = {}
    for h in range(1, len(heads)):
        got = heads[h]
        nonce = struct.unpack_from("<I", got, 76)[0]
        rebuilt = None
        for extra in range(max_extra_nonce + 1):
            cand = header(prev, sha256d(payload(prefix, h, extra)), h, bits,
                          nonce)
            if cand == got:
                rebuilt, extras[h] = cand, extra
                break
        digest = sha256d(got)
        if rebuilt is None:
            v.header_mismatch += 1
            v.failed_heights.append(h)
        if block_hashes is not None and (h >= len(block_hashes)
                                         or block_hashes[h] != digest):
            v.hash_mismatch += 1
            v.failed_heights.append(h)
        if leading_zero_bits(digest) < bits:
            v.pow_fail += 1
            v.failed_heights.append(h)
        prev = digest
    # The lowest-nonce rule on a seeded sample. A block found after k > 0
    # empty spaces would need those spaces scanned too; at the
    # difficulties benchmarked one never occurs (an empty 2^32 space has
    # probability exp(-2^(32 - d))), so such a block counts as failed.
    order = list(extras)
    random.Random(seed).shuffle(order)
    scanner = None
    for h in order:
        if v.sampled_blocks >= scan_blocks:
            break
        nonce = struct.unpack_from("<I", heads[h], 76)[0]
        if v.sampled_nonces and v.sampled_nonces + nonce > scan_budget:
            continue
        v.sampled_blocks += 1
        v.sampled_nonces += nonce
        if scanner is None and nonce:
            scanner = Scanner(bits, device)
        lower = scanner.lowest(heads[h][:76], 0, nonce) if nonce else None
        if lower is not None or extras[h]:
            v.not_lowest += 1
            v.failed_heights.append(h)
    return v


def needed_nonces(nonce: int, extra_nonce: int = 0) -> int:
    """Nonces the chain needs for a block: every empty space before its
    own, in full, and its own up to and including the winner."""
    return extra_nonce * NONCE_SPACE + nonce + 1
