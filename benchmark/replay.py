"""The work of one nonce of SHA-256d, counted once from the function.

``work(difficulty_bits)`` replays the double hash of a header on symbols
and counts, for one nonce, what the fewest instructions of a Hopper SM
must do: ``adds``, the two-input 32-bit adds (A), and ``alu_only``, the
operations only the ALU pipe runs (L): one SHF a rotate or shift, one
LOP3 a logical function of up to three inputs (a sigma's three-way xor,
ch, maj), one ISETP a word the difficulty test reads. The counts come
from the function alone, never from a compiled loop, so the same work is
counted whatever implements it.

The replay hoists what does not depend on the nonce, as every sweep does:
header chunk 1 is a midstate; chunk-2 words 0..2 and rounds 0..2 are
fixed by the template; round 3 adds the nonce word to two fixed sums
(a3 = rc_a + w3, e3 = rc_e + w3); schedule words w16 and w17 are fixed and
w18, w19 are a fixed part plus a term in w3. Constants fold. Sums
associate mod 2^32, so the fixed terms of a sum fold into one, and a sum
of n terms that depend on the nonce takes n - 1 adds, one more when a
fixed term remains. Only what the difficulty test reads is counted: the
digest's word 0 below 32 bits of difficulty, words 0 and 1 above. The
nonce word itself (the byte swap of the nonce) is not counted: a sweep
over whole 32-nonce slices can step it by an add folded into the rest.

The bound of a nonce on one SM (``clocks_per_nonce``) follows the pipe
model of the H100: the ALU and FMA pipes each take 64 instructions a
clock. The ALU-only work fills the ALU pipe for L / 64 clocks. An add
runs either as IMAD on the FMA pipe (one add) or as IADD3 on the ALU pipe
(up to two adds), so the best split of A adds takes max(L / 64,
(2 L + A) / 192) clocks.
"""
from __future__ import annotations

from .reference import IV, K, M32

PIPE_PER_SM_CLOCK = 64
_FIXED = "fixed"     # depends on the template only: hoisted out of the loop


class _Node:
    """A value that depends on the nonce: the work forming it and the
    nonce-dependent values it reads."""

    __slots__ = ("alu", "adds", "reads")

    def __init__(self, alu: int, adds: int, reads: list):
        self.alu, self.adds, self.reads = alu, adds, reads


def _nonce(xs) -> list:
    return [x for x in xs if isinstance(x, _Node)]


def _op(fn, *xs):
    """An ALU-only operation (SHF, LOP3): folded on constants, hoisted on
    fixed values, one instruction otherwise."""
    if all(isinstance(x, int) for x in xs):
        return fn(*xs) & M32
    nonce = _nonce(xs)
    return _Node(1, 0, nonce) if nonce else _FIXED


def _sum(*xs):
    const = sum(x for x in xs if isinstance(x, int)) & M32
    fixed = any(x is _FIXED for x in xs)
    nonce = _nonce(xs)
    if not nonce:
        return _FIXED if fixed else const
    return _Node(0, len(nonce) - 1 + int(fixed or const != 0), nonce)


def _rot(x, n: int):
    return _op(lambda v: (v >> n) | (v << (32 - n)), x)


def _shr(x, n: int):
    return _op(lambda v: v >> n, x)


def _xor3(a, b, c):
    return _op(lambda p, q, r: p ^ q ^ r, a, b, c)


def _big_sigma0(a):
    return _xor3(_rot(a, 2), _rot(a, 13), _rot(a, 22))


def _big_sigma1(e):
    return _xor3(_rot(e, 6), _rot(e, 11), _rot(e, 25))


def _small_sigma0(x):
    return _xor3(_rot(x, 7), _rot(x, 18), _shr(x, 3))


def _small_sigma1(x):
    return _xor3(_rot(x, 17), _rot(x, 19), _shr(x, 10))


def _ch(e, f, g):
    return _op(lambda p, q, r: r ^ (p & (q ^ r)), e, f, g)


def _maj(a, b, c):
    return _op(lambda p, q, r: q ^ ((p ^ q) & (q ^ r)), a, b, c)


def _expand(w: list, first: int) -> None:
    for r in range(first, 64):
        w[r] = _sum(_small_sigma1(w[r - 2]), w[r - 16], w[r - 7],
                    _small_sigma0(w[r - 15]))


def _rounds(state: list, w: list, first: int) -> list:
    a, b, c, d, e, f, g, h = state
    for r in range(first, 64):
        t1 = _sum(h, K[r], w[r], _big_sigma1(e), _ch(e, f, g))
        t2 = _sum(_big_sigma0(a), _maj(a, b, c))
        h, g, f, e = g, f, e, _sum(d, t1)
        d, c, b, a = c, b, a, _sum(t1, t2)
    return [a, b, c, d, e, f, g, h]


def _digest_words01() -> tuple:
    """Digest words 0 and 1 of the header's double hash, on symbols."""
    w3 = _Node(0, 0, [])
    w = [0] * 64
    w[:3] = [_FIXED] * 3
    w[3] = w3
    w[4], w[15] = 0x80000000, 80 * 8          # words 5..14 are 0
    w[16], w[17] = _FIXED, _FIXED
    w[18] = _sum(_FIXED, _small_sigma0(w3))
    w[19] = _sum(w3, _FIXED)
    _expand(w, 20)
    state = _rounds([_sum(_FIXED, w3), _FIXED, _FIXED, _FIXED,
                     _sum(_FIXED, w3), _FIXED, _FIXED, _FIXED], w, 4)
    w2 = [0] * 64
    w2[:8] = [_sum(x, _FIXED) for x in state]   # the feed-forward
    w2[8], w2[15] = 0x80000000, 32 * 8          # words 9..14 are 0
    _expand(w2, 16)
    out = _rounds(list(IV), w2, 0)
    return _sum(out[0], IV[0]), _sum(out[1], IV[1])


def difficulty_class(difficulty_bits: int) -> int:
    """0: every nonce qualifies; 1: below 32 bits (word 0 alone); 2:
    exactly 32 (word 0 is zero); 3: 33 to 63 (word 0 zero, word 1 below
    a bound); 4: 64 and above (words 0 and 1 zero)."""
    d = int(difficulty_bits)
    return 0 if d <= 0 else 1 if d < 32 else 2 if d == 32 else \
        3 if d < 64 else 4


def work(difficulty_bits: int) -> dict:
    """{"alu_only": L, "adds": A} of one nonce at this difficulty."""
    cls = difficulty_class(difficulty_bits)
    if cls == 0:
        return {"alu_only": 0, "adds": 0}
    h0, h1 = _digest_words01()
    read = [h0] if cls <= 2 else [h0, h1]
    tests = [_Node(1, 0, [v]) for v in read]    # one ISETP a word
    seen, alu, adds = set(), 0, 0
    stack = list(tests)
    while stack:
        v = stack.pop()
        if id(v) in seen:
            continue
        seen.add(id(v))
        alu += v.alu
        adds += v.adds
        stack.extend(v.reads)
    return {"alu_only": alu, "adds": adds}


def clocks_per_nonce(alu_only: int, adds: int) -> float:
    """The fewest SM clocks a nonce takes under the pipe model."""
    return max(alu_only / PIPE_PER_SM_CLOCK,
               (2 * alu_only + adds) / (3 * PIPE_PER_SM_CLOCK))
