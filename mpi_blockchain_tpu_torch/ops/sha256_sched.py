"""Per-template SHA-256d precompute: the extended midstate (numpy).

The chunk-1 midstate (``core.header_midstate``) already takes the first
64 header bytes out of the sweep. ``extend_midstate`` takes out the rest
of the double hash that does not depend on the nonce:

* rounds 0..2 of the chunk-2 compression, which read only template words
  (the nonce sits at word ``NONCE_WORD_INDEX`` = 3);
* round 3, folded to two constants: its two new state words are
  ``rc_a + w3`` and ``rc_e + w3``;
* the nonce-invariant schedule prefix: w16, w17 and the constant partial
  sums of w18 and w19.

All of it is packed into one ``EXT_WORDS``-word uint32 payload that the
sweep kernels take as their only per-template input. uint32 addition is
associative, so every fold is exact.
"""
from __future__ import annotations

import numpy as np

# FIPS 180-4 round constants / IV (same values as core/csrc/sha256.cpp).
K = np.array([
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
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

IV = np.array([0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
               0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19],
              dtype=np.uint32)

NOT_FOUND_U32 = 0xFFFFFFFF

# The nonce's word in the header's second SHA-256 chunk: byte offset 76 of
# the frozen layout (chain.hpp) = 64 + NONCE_WORD_INDEX * 4.
NONCE_WORD_INDEX = 3

# Chunk-2 words 4..15 are fixed by the 80-byte layout: 0x80000000 pad bit,
# zeros, 640-bit message length.
CHUNK2_TAIL_CONST = np.array([0x80000000] + [0] * 10 + [80 * 8],
                             dtype=np.uint32)
# The second hash's message is the 32-byte digest + the same padding
# shape: words 8..15 are 0x80000000, zeros, 256-bit length.
DIGEST_PAD_CONST = np.array([0x80000000] + [0] * 6 + [32 * 8],
                            dtype=np.uint32)

# ---- extended-midstate payload layout (EXT_WORDS uint32 words) ------------
# [0:8]   the chunk-1 midstate (hash 1's feed-forward terms)
# [8:14]  the six nonce-invariant state words entering round 4:
#         a2, a1, a0 (the a-chain) and e2, e1, e0 (the e-chain)
# [14]    rc_a: a3 = rc_a + w3
# [15]    rc_e: e3 = rc_e + w3
# [16]    w16
# [17]    w17
# [18]    rc18: w18 = rc18 + s0(w3)
# [19]    rc19: w19 = w3 + rc19
EXT_MS = 0
EXT_A2, EXT_A1, EXT_A0 = 8, 9, 10
EXT_E2, EXT_E1, EXT_E0 = 11, 12, 13
EXT_RC_A = 14
EXT_RC_E = 15
EXT_W16 = 16
EXT_W17 = 17
EXT_RC18 = 18
EXT_RC19 = 19
EXT_WORDS = 20


def _rotr(x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _sigma0(x):
    """Schedule sigma0: rotr7 ^ rotr18 ^ (x >> 3)."""
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> np.uint32(3))


def _sigma1(x):
    """Schedule sigma1: rotr17 ^ rotr19 ^ (x >> 10)."""
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> np.uint32(10))


def extend_midstate(midstate: np.ndarray, tail_w: np.ndarray) -> np.ndarray:
    """(EXT_WORDS,) uint32 extended-midstate payload for one template.

    midstate: (8,) uint32, the state after header chunk 1
    tail_w:   (16,) uint32, the chunk-2 word template (word 3, the nonce
              slot, is ignored; words 4..15 are the layout constants)
    """
    ms = [np.uint32(midstate[i]) for i in range(8)]
    w0, w1, w2 = (np.uint32(tail_w[i]) for i in range(3))
    # errstate: the modular uint32 adds ARE the algorithm.
    with np.errstate(over="ignore"):
        a, b, c, d, e, f, g, h = ms
        for r, wi in enumerate((w0, w1, w2)):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = g ^ (e & (f ^ g))
            t1 = h + S1 + ch + K[r] + wi
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = b ^ ((a ^ b) & (b ^ c))
            t2 = S0 + maj
            h, g, f, e = g, f, e, d + t1
            d, c, b, a = c, b, a, t1 + t2
        # Round 3 folded onto the nonce word: t1 = t1c + w3, so the two
        # state words it produces are rc + w3 each.
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = g ^ (e & (f ^ g))
        t1c = h + S1 + ch + K[3]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = b ^ ((a ^ b) & (b ^ c))
        rc_a = t1c + S0 + maj
        rc_e = d + t1c
        # Nonce-invariant schedule prefix (w9..w14 are zero, w15 = 640):
        w16 = w0 + _sigma0(w1)
        w17 = w1 + _sigma0(w2) + _sigma1(CHUNK2_TAIL_CONST[11])
        rc18 = w2 + _sigma1(w16)
        rc19 = _sigma0(CHUNK2_TAIL_CONST[0]) + _sigma1(w17)
        vals = ms + [a, b, c, e, f, g, rc_a, rc_e, w16, w17, rc18, rc19]
    return np.array(vals, dtype=np.uint32)
