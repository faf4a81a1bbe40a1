"""The fused miner's per-block step: header template and winner digest.

Twin of the header build in the reference's fused k-block miner
(``mpi_blockchain_tpu/models/fused.py:89-114``, jnp that XLA compiles). For
each block the loop builds the header on the device from the previous
block's digest, so the host never sees it:

* ``block_template(prev, data, height, bits)``: the midstate of header
  chunk 1 (version | prev_hash | data_hash[0:7]), the chunk-2 template
  (data_hash[7] | timestamp | bits | nonce slot | padding) and its extended
  midstate (``sha256_sched``), the sweep's only per-template input;
* ``winner_digest(midstate, tail, nonce)``: the double hash of the header
  with that nonce, the 8 big-endian digest words that are the next block's
  prev_hash.

These are the plain versions: int64 tensors masked to 32 bits, as the
plain sweep computes (``sha256_torch``), of any leading shape. The CUDA
step kernel (``csrc/sha256d_sweep.cu``, ``block_step_kernel``) does both
for one block per launch on one thread, in place on a device scratch
buffer; ``step`` is its wrapper and ``step_plain`` the same step in plain
PyTorch; ``step_repeat`` enqueues n steps in one call into the library, so
that the kernel can be timed apart from the host. ``mine_k`` enqueues a
whole k-block call of the fused loop (step, copy of the ext into the
sweep's ``__constant__`` symbol, early-exit sweep, k times, then a final
step) in one call into the library;
``mine_k_plain`` is the same sequence with the plain step and the plain
sweep. A rank of a world of processes drives the same loop from the host,
a round at a time: ``slice_launch`` sweeps its slice of a round of the
block whose ext a step built, into a result buffer of its own, and
``put_result`` writes the round's winner-select into the scratch's result
buffer, from which the next step finalizes the block.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from ..config import ConfigError
from . import sha256_cuda, sha256_torch
from .sha256_sched import DIGEST_PAD_CONST, IV, K, NONCE_WORD_INDEX, \
    NOT_FOUND_U32
from .sha256_torch import M32, NONCE_SPACE, _bswap32, _rotr, _rounds, \
    _sigma0, _sigma1

#: Header word 0: version 1, stored little-endian, read big-endian.
VERSION_WORD = 0x01000000
#: uint32 words of a step's scratch buffer: the sweep's result buffer
#: {count, min, cursor_lo, cursor_hi} first (so 8-byte aligned), then the
#: block's extended midstate, its midstate and its chunk-2 template.
SCRATCH_RESULT, SCRATCH_EXT, SCRATCH_MIDSTATE, SCRATCH_TAIL = 0, 4, 24, 32
SCRATCH_WORDS = 48
#: Dependent operations on the longest chain of one step that finalizes a
#: block and builds the next: three compressions, each input the digest of
#: the one before (hash 1 and hash 2 of the winner, then chunk 1 of the next
#: header), and the extension. A round's e-word needs three dependent
#: operations (the rotations, their xor, one three-input add of the word's
#: precomputed part, Sigma1 and ch); the feed-forward adds one per
#: compression; the extension's three rounds and round-3 fold four more.
#: Schedule words and the a-word chain run beside the e-word chain.
STEP_DEPENDENT_OPS = 3 * (64 * 3 + 1) + 4 * 3

#: Step-kernel launches so far. ``step`` adds one per launch and ``mine_k``
#: one per step it enqueues; nothing else touches it.
step_launches = 0


def _compress(state, block):
    """The 8 words of SHA-256's compression of 16 message words from
    ``state``, feed-forward included (words: tensors or ints)."""
    out = _rounds(tuple(state), list(block), K)
    return [(o + s) & M32 for o, s in zip(out, state)]


def to_words(t: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32) words as int64 in [0, 2^32); other integer
    tensors are only cast. The bits go through an int32 view: casts from
    torch.uint32 are not implemented on every device."""
    if t.dtype in (torch.uint32, torch.int32):
        return t.view(torch.int32).to(torch.int64) & M32
    return t.to(torch.int64)


def store_words(dst: torch.Tensor, words: torch.Tensor) -> None:
    """Writes int64 words in [0, 2^32) into a uint32 or int32 tensor."""
    dst.view(torch.int32).copy_(
        torch.where(words >= 1 << 31, words - (1 << 32), words))


def _words(t: torch.Tensor) -> list:
    return [t[..., i] for i in range(t.shape[-1])]


def extend_midstate(midstate: torch.Tensor, tail: torch.Tensor
                    ) -> torch.Tensor:
    """(..., 20) extended midstate from (..., 8) midstate and (..., 16)
    chunk-2 template words: the plain twin of ``sha256_sched``'s, in int64
    masked to 32 bits."""
    ms = _words(midstate)
    w0, w1, w2 = (tail[..., i] for i in range(3))
    a, b, c, d, e, f, g, h = _rounds(tuple(ms), [w0, w1, w2], K[:3])
    # Round 3 folded onto the nonce word: its new words are rc + w3.
    s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    t1c = (h + s1 + (g ^ (e & (f ^ g))) + int(K[3])) & M32
    s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    rc_a = (t1c + s0 + (b ^ ((a ^ b) & (b ^ c)))) & M32
    rc_e = (d + t1c) & M32
    # The nonce-invariant schedule prefix (w9..w14 are 0, w15 = 640).
    w16 = (w0 + _sigma0(w1)) & M32
    w17 = (w1 + _sigma0(w2) + _sigma1(tail[..., 15])) & M32
    rc18 = (w2 + _sigma1(w16)) & M32
    rc19 = (_sigma0(tail[..., 4]) + _sigma1(w17)) & M32
    return torch.stack(ms + [a, b, c, e, f, g, rc_a, rc_e, w16, w17, rc18,
                             rc19], dim=-1)


def block_template(prev_words: torch.Tensor, data_words: torch.Tensor,
                   height, bits: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(midstate (..., 8), tail (..., 16), ext (..., 20)) of the header at
    ``height`` on ``prev_words`` (the previous digest's 8 big-endian words)
    with ``data_words`` (its data hash's), at ``bits`` leading zero bits:
    int64 tensors masked to 32 bits. ``height`` is an int or an int64
    tensor of the leading shape."""
    prev, data = to_words(prev_words), to_words(data_words)
    chunk1 = [VERSION_WORD] + _words(prev) + _words(data)[:7]
    midstate = torch.stack(_compress([int(v) for v in IV], chunk1), dim=-1)
    word7 = data[..., 7]
    height = torch.as_tensor(height, dtype=torch.int64, device=word7.device)

    def const(v: int) -> torch.Tensor:
        return torch.full_like(word7, v)

    tail = torch.stack(
        [word7, _bswap32(height & M32).expand_as(word7),
         const(_bswap32(int(bits) & M32)), const(0), const(0x80000000)]
        + [const(0)] * 10 + [const(80 * 8)], dim=-1)
    return midstate, tail, extend_midstate(midstate, tail)


def winner_digest(midstate: torch.Tensor, tail: torch.Tensor, nonce
                  ) -> torch.Tensor:
    """(..., 8) big-endian words of the double hash of the header whose
    chunk-1 midstate and chunk-2 template these are, with ``nonce`` (an int
    or an int64 tensor of the leading shape) in its nonce field."""
    w = _words(to_words(tail))
    w[NONCE_WORD_INDEX] = _bswap32(
        torch.as_tensor(nonce, dtype=torch.int64,
                        device=midstate.device).expand_as(w[0]) & M32)
    d1 = _compress(_words(to_words(midstate)), w)
    d2 = _compress([int(v) for v in IV],
                   d1 + [int(v) for v in DIGEST_PAD_CONST])
    return torch.stack(d2, dim=-1)


def new_scratch(device: torch.device) -> torch.Tensor:
    """A step's scratch buffer: ``SCRATCH_WORDS`` int32 words (read as
    uint32) whose first four are a reset result buffer."""
    scratch = torch.zeros(SCRATCH_WORDS, dtype=torch.int32, device=device)
    scratch[SCRATCH_RESULT + 1] = -1
    return scratch


def step_plain(scratch: torch.Tensor, *, prev: torch.Tensor | None = None,
               data: torch.Tensor | None = None, height: int = 0,
               difficulty_bits: int = 0,
               nonce_out: torch.Tensor | None = None,
               tip_out: torch.Tensor | None = None) -> None:
    """The step kernel's work in plain PyTorch, on any device. Finalize
    when ``nonce_out`` is given: the result buffer's min (word 1) goes to
    ``nonce_out`` and the digest of the header with it replaces ``prev``.
    Build when ``data`` is given: the block at ``height`` on that digest,
    its midstate, template and ext written to ``scratch`` and the result
    buffer reset, cursor included. When nothing is built, the digest goes
    to ``tip_out`` (if given)."""
    words = to_words(scratch)
    if nonce_out is not None:
        nonce = words[SCRATCH_RESULT + 1]
        store_words(nonce_out, nonce.reshape(nonce_out.shape))
        prev = winner_digest(words[SCRATCH_MIDSTATE:SCRATCH_TAIL],
                             words[SCRATCH_TAIL:], nonce)
    elif prev is None:
        raise ValueError("a step that finalizes no block needs prev")
    if data is None:
        if tip_out is not None:
            store_words(tip_out, to_words(prev))
        return
    midstate, tail, ext = block_template(prev, data, height,
                                         difficulty_bits)
    reset = torch.tensor([0, NOT_FOUND_U32, 0, 0], dtype=torch.int64,
                         device=words.device)
    store_words(scratch, torch.cat([reset, ext, midstate, tail]))


def _check_scratch(scratch: torch.Tensor) -> None:
    if scratch.dtype != torch.int32 or scratch.shape != (SCRATCH_WORDS,) \
            or not scratch.is_contiguous() or scratch.data_ptr() % 8:
        raise ValueError(f"scratch must be a contiguous, 8-byte aligned "
                         f"({SCRATCH_WORDS},) int32 tensor (new_scratch)")


def _ptr(t: torch.Tensor | None, shape: tuple, device: torch.device,
         name: str):
    if t is None:
        return None
    sha256_cuda.check_device_words(t, shape, device, name)
    return t.data_ptr()


def step(scratch: torch.Tensor, *, prev: torch.Tensor | None = None,
         data: torch.Tensor | None = None, height: int = 0,
         difficulty_bits: int = 0, nonce_out: torch.Tensor | None = None,
         tip_out: torch.Tensor | None = None) -> None:
    """One fused step (see ``step_plain``) on ``scratch``'s device. On a
    CUDA device this enqueues the step kernel on the current stream or
    raises; on the CPU it runs ``step_plain``. ``prev``, ``data``,
    ``tip_out`` are (8,) and ``nonce_out`` (1,) uint32 tensors."""
    global step_launches
    _check_scratch(scratch)
    device = scratch.device
    if device.type == "cpu":
        step_plain(scratch, prev=prev, data=data, height=height,
                   difficulty_bits=difficulty_bits, nonce_out=nonce_out,
                   tip_out=tip_out)
        return
    if device.type != "cuda":
        raise ConfigError(f"the step runs on a CUDA device or the CPU, "
                          f"not {device}")
    args = _step_args(scratch, prev, data, height, difficulty_bits,
                      nonce_out, tip_out)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = sha256_cuda._lib().sha256d_block_step_launch(*args, stream)
    if err != 0:
        raise sha256_cuda.cuda_error("the block step launch", err)
    step_launches += 1


def _step_args(scratch, prev, data, height, difficulty_bits, nonce_out,
               tip_out) -> list:
    """The step kernel's C arguments (pointers and words) for a CUDA
    ``scratch``; raises on what the kernel does not take."""
    device = scratch.device
    if prev is None and nonce_out is None:
        raise ValueError("a step that finalizes no block needs prev")
    return [_ptr(prev, (8,), device, "prev"), _ptr(data, (8,), device, "data"),
            scratch.data_ptr(), _ptr(nonce_out, (1,), device, "nonce_out"),
            _ptr(tip_out, (8,), device, "tip_out"), int(height) & M32,
            int(difficulty_bits) & M32]


def step_repeat(n: int, scratch: torch.Tensor, *,
                prev: torch.Tensor | None = None,
                data: torch.Tensor | None = None, height: int = 0,
                difficulty_bits: int = 0,
                nonce_out: torch.Tensor | None = None,
                tip_out: torch.Tensor | None = None,
                stamps: torch.Tensor | None = None) -> None:
    """Enqueues ``n`` steps with the same arguments (see ``step``) back to
    back on the current stream of ``scratch``'s CUDA device, in one call
    into the library, so that no host work lies between the launches: what
    they take on the card is the kernel's. It measures the kernel, so it
    raises on any other device. ``stamps``, a (2 n,) int64 tensor on the
    same device, selects the measuring build, which writes the SM clock
    (``clock64``) at each launch's first and last instruction to
    stamps[2 i] and stamps[2 i + 1]."""
    global step_launches
    _check_scratch(scratch)
    device = scratch.device
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if device.type != "cuda":
        raise ConfigError(f"step_repeat times the step kernel on a CUDA "
                          f"device, not {device}")
    if stamps is not None and (stamps.device != device
                               or stamps.dtype != torch.int64
                               or stamps.shape != (2 * n,)
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be a contiguous ({2 * n},) int64 "
                         f"tensor on {device}")
    args = _step_args(scratch, prev, data, height, difficulty_bits,
                      nonce_out, tip_out)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = sha256_cuda._lib().sha256d_block_step_repeat(
            n, *args, None if stamps is None else stamps.data_ptr(), stream)
    if err != 0:
        raise sha256_cuda.cuda_error("the repeated block step launch", err)
    step_launches += n


def _check_call(prev: torch.Tensor, data: torch.Tensor, difficulty_bits: int,
                cap: int) -> int:
    """The number of blocks k of a k-block call; raises on bad inputs."""
    if data.dim() != 2 or data.shape[1] != 8 or data.shape[0] < 1:
        raise ValueError(f"data_words must have shape (k, 8), k >= 1, got "
                         f"{tuple(data.shape)}")
    if prev.shape != (8,):
        raise ValueError(f"prev_words must have shape (8,), got "
                         f"{tuple(prev.shape)}")
    if not 1 <= cap <= NONCE_SPACE:
        raise ValueError(f"cap {cap} is not in [1, 2^32]")
    if not 0 <= difficulty_bits <= 64:
        raise ConfigError(f"difficulty_bits {difficulty_bits} not in "
                          f"[0, 64]")
    return data.shape[0]


def mine_k_plain(prev_words: torch.Tensor, data_words: torch.Tensor,
                 start_height: int, difficulty_bits: int, cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mine_k``'s sequence in plain PyTorch on the inputs' device: per
    block ``step_plain`` and ``sha256_torch.sweep_core_ext`` with early
    exit over [0, cap), then the final step."""
    k = _check_call(prev_words, data_words, difficulty_bits, cap)
    device = prev_words.device
    scratch = new_scratch(device)
    nonces = torch.empty(k, dtype=torch.uint32, device=device)
    tip = torch.empty(8, dtype=torch.uint32, device=device)
    for j in range(k + 1):
        step_plain(scratch, prev=prev_words if j == 0 else None,
                   data=data_words[j] if j < k else None,
                   height=start_height + j + 1,
                   difficulty_bits=difficulty_bits,
                   nonce_out=nonces[j - 1:j] if j else None,
                   tip_out=tip if j == k else None)
        if j < k:
            count, best = sha256_torch.sweep_core_ext(
                to_words(scratch[SCRATCH_EXT:SCRATCH_MIDSTATE]), 0, cap,
                difficulty_bits, early_exit=True)
            store_words(scratch[:2], torch.tensor(
                [min(count, M32), best], dtype=torch.int64, device=device))
    return nonces, tip


def slice_launch(scratch: torch.Tensor, base: int, count: int,
                 difficulty_bits: int) -> Callable[[], tuple[int, int]]:
    """Starts an early-exit sweep of [base, base + count) of the block
    whose extended midstate a step built into ``scratch``, into a result
    buffer of its own: the scratch's stays the block's, for the round's
    winner-select (``put_result``). Returns the function that waits for it
    and gives (count, min_nonce). On a CUDA device this enqueues the
    constant-ext sweep kernel on the current stream or raises; on the CPU
    it runs the plain sweep."""
    _check_scratch(scratch)
    ext = scratch[SCRATCH_EXT:SCRATCH_MIDSTATE]
    device = scratch.device
    if device.type == "cpu":
        res = sha256_torch.sweep_core_ext(to_words(ext), base, count,
                                          difficulty_bits, early_exit=True)
        return lambda: res
    with torch.cuda.device(device), \
            sha256_cuda.kernel_errors("sha256d_sweep launch"):
        out = sha256_cuda.fresh_result(device)
        sha256_cuda.launch(ext, base, count, difficulty_bits, out,
                           early_exit=True)
    return lambda: sha256_cuda.read_result(out)


def put_result(scratch: torch.Tensor, count: int, min_nonce: int) -> None:
    """Writes a round's (count, min_nonce) into ``scratch``'s result
    buffer, where the next step reads the block's winner: an 8-byte copy
    on the current stream of its device (from pinned memory, without a
    host sync, on a card)."""
    _check_scratch(scratch)
    src = torch.tensor([w - (1 << 32) if w >= 1 << 31 else w
                        for w in (min(count, M32), min_nonce)],
                       dtype=torch.int32)
    dst = scratch[SCRATCH_RESULT:SCRATCH_RESULT + 2]
    if scratch.device.type == "cpu":
        dst.copy_(src)
    else:
        dst.copy_(src.pin_memory(), non_blocking=True)


def _event_handles(events: list | None, n: int, name: str):
    """A ctypes array of the ``n`` CUDA events' handles (None for None)."""
    if events is None:
        return None
    if len(events) != n or not all(ev.cuda_event for ev in events):
        raise ValueError(f"{name} must be {n} recorded CUDA events")
    return (ctypes.c_void_p * n)(*(ev.cuda_event for ev in events))


def mine_k(prev_words: torch.Tensor, data_words: torch.Tensor,
           start_height: int, difficulty_bits: int, cap: int, *,
           sweep_events: list | None = None,
           step_events: list | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mines the k blocks of ``data_words`` (k, 8) uint32 on
    ``prev_words`` (8,) uint32, the first at ``start_height + 1``: returns
    (nonces (k,), tip (8,)) uint32 on the inputs' device. A block's nonce
    is its lowest qualifying nonce in [0, cap), or 0xFFFFFFFF when there is
    none, and the chain carries on from that header's digest; tip is the
    last block's digest.

    On a CUDA device this enqueues the whole call on the current stream,
    in one call into the library, and returns without synchronising; it
    raises if that fails. On the CPU it runs ``mine_k_plain``.
    ``sweep_events`` (CUDA only), 2 k ``torch.cuda.Event`` already
    recorded once, are recorded again before and after each block's
    sweep; ``step_events``, k + 1 such events, after each step."""
    global step_launches
    k = _check_call(prev_words, data_words, difficulty_bits, cap)
    device = prev_words.device
    if device.type == "cpu":
        return mine_k_plain(prev_words, data_words, start_height,
                            difficulty_bits, cap)
    if device.type != "cuda":
        raise ConfigError(f"the fused loop runs on a CUDA device or the "
                          f"CPU, not {device}")
    sha256_cuda.check_device_words(prev_words, (8,), device, "prev_words")
    sha256_cuda.check_device_words(data_words, (k, 8), device, "data_words")
    sweeps = _event_handles(sweep_events, 2 * k, "sweep_events")
    steps = _event_handles(step_events, k + 1, "step_events")
    nonces = torch.empty(k, dtype=torch.uint32, device=device)
    tip = torch.empty(8, dtype=torch.uint32, device=device)
    # The first step builds a block, which resets the result buffer.
    scratch = torch.empty(SCRATCH_WORDS, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        args = [prev_words.data_ptr(), data_words.data_ptr(), k,
                int(start_height) & M32, int(difficulty_bits), int(cap),
                scratch.data_ptr(), nonces.data_ptr(), tip.data_ptr(), sweeps]
        with sha256_cuda.ext_symbol_user(device, stream):
            err = sha256_cuda._lib().sha256d_fused_enqueue(
                *args, steps, stream.cuda_stream)
    if err != 0:
        raise sha256_cuda.cuda_error("the fused k-block enqueue", err)
    sha256_cuda.launches += k
    step_launches += k + 1
    return nonces, tip
