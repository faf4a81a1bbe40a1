"""The plain PyTorch double-SHA-256 nonce sweep.

Twin of the reference's ``sha256d_h01_from_ext`` / ``difficulty_mask`` /
``sweep_core_ext``: the same extended-midstate algebra written as
elementwise tensor ops. It is the CPU path of the port and the yardstick
the hand-written CUDA kernel (``sha256_cuda.py``) is held against on the
card, bit for bit.

uint32 words are held in int64 tensors and masked with 0xFFFFFFFF after
every add and left shift: PyTorch's CPU build implements few operators for
``torch.uint32`` (``+``, shifts, ``<``, ``min`` and ``arange`` raise
NotImplementedError), and int64 holds a sum of up to 2^31 uint32 terms
without overflow. Template words stay Python ints, so the nonce-invariant
parts fold on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ConfigError
from .sha256_sched import (CHUNK2_TAIL_CONST, DIGEST_PAD_CONST, EXT_A0,
                           EXT_A1, EXT_A2, EXT_E0, EXT_E1, EXT_E2, EXT_RC18,
                           EXT_RC19, EXT_RC_A, EXT_RC_E, EXT_W16, EXT_W17,
                           EXT_WORDS, IV, K, NOT_FOUND_U32)

M32 = 0xFFFFFFFF
NONCE_SPACE = 1 << 32
#: Nonces hashed per tensor pass; bounds memory at a few MiB per live word.
CHUNK = 1 << 16


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _sigma0(x):
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _sigma1(x):
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


def _bswap32(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | (x >> 24))


def _rounds(state, w: list, ks) -> tuple:
    """SHA-256 rounds ``ks`` from ``state``; ``w`` is the 16-word message
    window aligned at the first round, expanded in place while a later
    round still reads it. Returns the state after the last round, without
    the feed-forward add."""
    a, b, c, d, e, f, g, h = state
    n = len(ks)
    for i, k in enumerate(ks):
        wi = w[i]
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = g ^ (e & (f ^ g))
        t1 = h + S1 + ch + int(k) + wi
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = b ^ ((a ^ b) & (b ^ c))
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + S0 + maj) & M32
        if i + 16 < n:
            w.append((wi + _sigma0(w[i + 1]) + w[i + 9]
                      + _sigma1(w[i + 14])) & M32)
    return a, b, c, d, e, f, g, h


def sha256d_h01_from_ext(ext: list[int], nonce_word: torch.Tensor):
    """Digest words h0, h1 (all the difficulty test reads) for a batch of
    byte-swapped nonce words (int64 tensor), from the extended midstate
    ``ext`` given as 20 Python ints.

    Hash 1 enters at round 4: round 3 is the two folded adds, and the
    window starts at word 4 with w16/w17 and the rc18/rc19 partial sums.
    Hash 2 is a full compression of the 8 digest words.
    """
    w3 = nonce_word
    a3 = (ext[EXT_RC_A] + w3) & M32
    e3 = (ext[EXT_RC_E] + w3) & M32
    w18 = (ext[EXT_RC18] + _sigma0(w3)) & M32
    w19 = (w3 + ext[EXT_RC19]) & M32
    window = [int(v) for v in CHUNK2_TAIL_CONST] \
        + [ext[EXT_W16], ext[EXT_W17], w18, w19]
    st4 = (a3, ext[EXT_A2], ext[EXT_A1], ext[EXT_A0],
           e3, ext[EXT_E2], ext[EXT_E1], ext[EXT_E0])
    out = _rounds(st4, window, K[4:])
    d1 = [(o + ext[i]) & M32 for i, o in enumerate(out)]
    w2 = d1 + [int(v) for v in DIGEST_PAD_CONST]
    a, b = _rounds(tuple(int(v) for v in IV), w2, K)[:2]
    return (a + int(IV[0])) & M32, (b + int(IV[1])) & M32


def difficulty_mask(h0: torch.Tensor, h1: torch.Tensor,
                    difficulty_bits: int) -> torch.Tensor:
    """True where the 256-bit big-endian digest has at least
    ``difficulty_bits`` (0..64) leading zero bits."""
    d = int(difficulty_bits)
    if d <= 0:
        return torch.ones_like(h0, dtype=torch.bool)
    if d < 32:
        return h0 < (1 << (32 - d))
    if d == 32:
        return h0 == 0
    if d < 64:
        return (h0 == 0) & (h1 < (1 << (64 - d)))
    if d == 64:
        return (h0 == 0) & (h1 == 0)
    raise ConfigError(f"difficulty_bits {d} > 64 unsupported")


def ext_words(ext) -> list[int]:
    """The 20 extended-midstate words as Python ints, from a numpy array
    or a tensor (a CUDA tensor is copied to the host)."""
    if isinstance(ext, torch.Tensor):
        ext = ext.detach().cpu().numpy()
    arr = np.asarray(ext)
    if arr.shape != (EXT_WORDS,):
        raise ValueError(f"ext must have shape ({EXT_WORDS},), "
                         f"got {arr.shape}")
    words = [int(v) for v in arr.tolist()]
    if any(not 0 <= v <= M32 for v in words):
        raise ValueError("ext words must lie in [0, 2^32)")
    return words


def check_range(base: int, count: int) -> None:
    """The sweep range [base, base + count) must lie inside the uint32
    nonce space: nothing wraps, so nonce 0xFFFFFFFF stays findable."""
    if base < 0 or count < 0 or base + count > NONCE_SPACE:
        raise ValueError(f"nonce range [{base}, {base} + {count}) is not "
                         f"inside [0, 2^32)")


def sweep_core_ext(ext, base: int, count: int, difficulty_bits: int, *,
                   early_exit: bool = False) -> tuple[int, int]:
    """Sweeps nonces [base, base + count) from an extended midstate.

    ``ext`` is the 20-word payload as a tensor (the sweep runs on its
    device) or a numpy array (the sweep runs on the CPU). Returns
    ``(count, min_nonce)``: the number of qualifying nonces and the lowest
    one, 0xFFFFFFFF when none qualifies (told apart from a real winner by
    count > 0). With ``early_exit`` the sweep stops after the first chunk
    that holds a qualifier: ``min_nonce`` stays exact and ``count`` is
    only a found-flag.
    """
    check_range(base, count)
    device = ext.device if isinstance(ext, torch.Tensor) \
        else torch.device("cpu")
    words = ext_words(ext)
    total, best = 0, NOT_FOUND_U32
    for lo in range(base, base + count, CHUNK):
        hi = min(lo + CHUNK, base + count)
        nonces = torch.arange(lo, hi, dtype=torch.int64, device=device)
        h0, h1 = sha256d_h01_from_ext(words, _bswap32(nonces))
        qual = difficulty_mask(h0, h1, difficulty_bits)
        c = int(qual.sum())
        if c:
            total += c
            best = min(best, int(nonces[qual].min()))
            if early_exit:
                break
    return total, best
