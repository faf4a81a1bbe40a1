"""Carries state from the reference package into the port.

In this system the chain takes the place of weights: a chain file written
by the reference (``mine --out``, the C++ ``node.save()`` bytes) loads into
the port's Node with the same height and tip, and the port mines on from
it. The per-template sweep input, the 20-word extended midstate, converts
from the reference's numpy form to the port's tensor form.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ConfigError
from .core import Node
from .ops.sha256_sched import EXT_WORDS


def ext_from_reference(ext_np: np.ndarray,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """The reference's (20,) uint32 extended-midstate payload as the
    port's tensor: int64 words in [0, 2^32) on ``device`` (the plain
    PyTorch sweep computes in int64; see ``ops/sha256_torch.py``)."""
    arr = np.asarray(ext_np)
    if arr.shape != (EXT_WORDS,) or arr.dtype != np.uint32:
        raise ValueError(f"expected a ({EXT_WORDS},) uint32 array, got "
                         f"{arr.shape} {arr.dtype}")
    return torch.as_tensor(arr.astype(np.int64), device=torch.device(device))


def node_from_reference_chain(blob: bytes, difficulty_bits: int) -> Node:
    """A Node holding the chain in ``blob`` (concatenated 80-byte headers,
    genesis first, as the reference writes them). Every block is
    re-validated under ``difficulty_bits``; a chain that does not validate
    raises ConfigError."""
    node = Node(difficulty_bits, 0)
    if not node.load(blob):
        raise ConfigError(f"chain of {len(blob)} bytes does not validate "
                          f"at difficulty {difficulty_bits}")
    return node
