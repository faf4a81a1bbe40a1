"""The nonce-space split of more than one miner, and its winner-select.

Search-space data parallelism, as in the reference's ``parallel/mesh.py``:
round r covers the contiguous global range [base, base + n_miners * B);
miner i sweeps its B-sized slice (``sharded_local_base``). The epilogue of
a round sums the miners' qualifier counts and takes the least of their
lowest qualifying nonces (``winner_select``), so the first round with a
qualifier yields the exact global lowest nonce. Ranges are disjoint, so
ties are impossible and no rank tiebreak is needed.

Everything here is plain Python on ints, plus, for a world of more than
one process, two ``torch.distributed`` all-reduces of int64 CPU tensors.
The round's result is already on the host after the sweep's 8-byte
read-back, so the collectives run over gloo, which also lets several
processes share one card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

from ..config import ConfigError

#: The full uint32 nonce space every striping scheme must tile exactly.
NONCE_SPACE = 1 << 32
_NONE = 0xFFFFFFFF


def sharded_local_base(base: int, batch_size: int, index: int) -> int:
    """Miner ``index``'s slice offset of a round's contiguous global range:
    round r covers [base, base + n_miners * batch_size); miner i sweeps
    [base + i * batch_size, + batch_size). uint32 arithmetic, as the
    reference's."""
    return (base + index * batch_size) & 0xFFFFFFFF


def stripe_windows(index: int, n_live: int, batch_size: int,
                   space: int = NONCE_SPACE):
    """The nonce windows the dense ``index``-th of ``n_live`` live ranks
    sweeps, ascending: the host-side twin of ``sharded_local_base``.
    Round r covers [r * n_live * B, + n_live * B) and the index-th rank
    owns its B-sized slice of every round, so the union of all live
    ranks' windows is exactly [0, space), with no gap and no overlap.

    Yields ``(start, end)`` pairs. n_live == 1 yields one full-space
    window (no reason to chop a lone rank's sweep into round slices).
    """
    if not 0 <= index < n_live:
        raise ConfigError(f"stripe index {index} out of range for "
                          f"{n_live} live rank(s)")
    if batch_size < 1 or space < 1:
        raise ConfigError(f"stripe batch_size/space must be >= 1, got "
                          f"{batch_size}/{space}")
    if n_live == 1:
        yield (0, space)
        return
    round_size = n_live * batch_size
    for base in range(index * batch_size, space, round_size):
        yield (base, min(base + batch_size, space))


def winner_select(count: int, min_nonce: int, group=None) -> tuple[int, int]:
    """The round's epilogue: the sum of every miner's qualifier count and
    the least of their lowest qualifying nonces (0xFFFFFFFF where none),
    the same on every rank. The reference's psum / pmin.

    ``group`` is a ``torch.distributed`` process group (None: the default
    group). In a single process, with no distributed world initialized,
    it returns its inputs. The collectives carry int64: the "none" nonce
    0xFFFFFFFF is negative as int32, and MIN would pick it.
    """
    import torch
    import torch.distributed as dist

    if group is None and not (dist.is_available() and
                              dist.is_initialized()):
        return int(count), int(min_nonce)
    t = torch.tensor([int(count), int(min_nonce)], dtype=torch.int64)
    total, least = t[:1].clone(), t[1:].clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(least, op=dist.ReduceOp.MIN, group=group)
    return int(total.item()), int(least.item())
