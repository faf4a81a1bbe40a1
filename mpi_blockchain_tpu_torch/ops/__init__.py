"""Double-SHA-256 nonce sweeps of the port and the policy that picks one.

Two implementations of the same (count, min_nonce) contract, bit-exact
with the C++ core:

  sha256_torch -- the plain PyTorch version (CPU, or any device)
  sha256_cuda  -- the hand-written CUDA kernel for Hopper (sm_90a)

Both take the extended midstate from ``sha256_sched.extend_midstate``.
``sha256_block`` holds the fused miner's per-block step (header template,
winner digest) in plain PyTorch and as a CUDA kernel.
"""
from __future__ import annotations

import functools

import torch

from ..config import ConfigError
from .sha256_sched import EXT_WORDS, extend_midstate  # noqa: F401


def resolve_kernel(kernel: str, device: torch.device) -> str:
    """The kernel a run on ``device`` uses: "cuda" (the hand-written
    kernels) or "torch" (their plain PyTorch versions). "auto" is "cuda" on
    a CUDA device and "torch" on the CPU, which the caller reaches only by
    asking for the CPU device; "cuda" on the CPU raises ConfigError."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ConfigError(f"unsupported device {device}")
    if kernel == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if kernel == "cuda" and device.type != "cuda":
        raise ConfigError(f"kernel='cuda' needs a CUDA device, got {device}")
    if kernel not in ("cuda", "torch"):
        raise ConfigError(f"unknown sweep kernel {kernel!r}")
    return kernel


def select_kernel(kernel: str, device: torch.device, difficulty_bits: int):
    """Resolves the sweep kernel for ``device`` in one place.

    kernel: {"auto", "torch", "cuda"}. "auto" is the CUDA kernel on a CUDA
    device and the plain PyTorch version on the CPU, which the caller
    reaches only by asking for the CPU device. An explicit "cuda" on the
    CPU raises ConfigError. Nothing falls back: a kernel that cannot build
    or launch raises at its call.

    Returns ``(fn, effective_kernel)`` where
    ``fn(ext, base, count, *, early_exit=False) -> (count, min_nonce)``.
    """
    from . import sha256_cuda, sha256_torch

    device = torch.device(device)
    kernel = resolve_kernel(kernel, device)
    if kernel == "cuda":
        return functools.partial(sha256_cuda.sweep,
                                 difficulty_bits=difficulty_bits,
                                 device=device), "cuda"

    def plain(ext, base, count, *, early_exit=False):
        ext_t = torch.as_tensor(sha256_torch.ext_words(ext),
                                dtype=torch.int64, device=device)
        return sha256_torch.sweep_core_ext(ext_t, base, count,
                                           difficulty_bits,
                                           early_exit=early_exit)
    return plain, "torch"
