"""Entry points of the port: a single-card sweep check and a dry run of
the sharded mine step, the twin of the reference's ``__graft_entry__.py``.

    entry()             -> (fn, example_args): one double-SHA-256 nonce
                           sweep round, (count, min_nonce)
    dryrun_multichip(n) -> the reference's three layers with n miners in
                           this process, each mined block appended to the
                           C++ node

    python -m mpi_blockchain_tpu_torch.graft_entry [n] [--device cpu]

Both run on the card (the hand-written sweep and step kernels) unless the
caller asks for the CPU (the plain versions). The reference re-runs its
dry run in a subprocess with the CPU platform forced, to beat JAX's
platform hooks; nothing here needs that.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

#: The reference's example: one tile of its Pallas kernel, difficulty 8.
ENTRY_BATCH, ENTRY_DBITS = 1 << 13, 8
#: The dry run's shapes, the reference's.
DRYRUN_BATCH_POW2, DRYRUN_DBITS = 10, 8


def _example_inputs():
    """The reference's example block: (node, header, midstate, tail)."""
    from . import core

    node = core.Node(8, 0)
    header = node.make_candidate(b"graft-entry block")
    midstate, tail = core.header_midstate(header)
    return node, header, midstate, tail


def entry(device: str | torch.device = "cuda"):
    """Returns ``(fn, example_args)`` for the single-card sweep step:
    ``fn(midstate (8,), tail (16,), base)`` extends the midstate and sweeps
    [base, base + 2^13) at difficulty 8 through ``sha256_cuda.sweep``, the
    kernel on a card and the plain sweep on an explicit CPU device, and
    gives (count, min_nonce), min_nonce 0xFFFFFFFF when count is 0."""
    from .backend.cuda import resolve_device
    from .ops import extend_midstate, sha256_cuda

    device = resolve_device(device)
    _, _, midstate, tail = _example_inputs()

    def fn(midstate, tail_w, base_nonce):
        ext = extend_midstate(np.asarray(midstate, np.uint32),
                              np.asarray(tail_w, np.uint32))
        return sha256_cuda.sweep(ext, int(base_nonce), ENTRY_BATCH,
                                 ENTRY_DBITS, device=device)

    return fn, (midstate, tail, np.uint32(0))


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> None:
    """The sharded mine step with ``n_devices`` miners in this process, at
    the reference's shapes (2^10 nonces a miner's slice, difficulty 8):

    1. the per-round sharded sweep: each miner sweeps its slice of a round,
       the round's epilogue sums the counts and takes the least nonce
       (the reference's psum/pmin), until a round holds a qualifier; the
       winner is appended to the C++ node;
    2. the multi-round searcher (``CudaBackend(n_miners=n)``) finds the
       same winner;
    3. ``FusedMiner(n_miners=n, blocks_per_call=2)`` mines a 2-block
       chain, appended through its C++ node.

    Prints the reference's line, with the mesh as ``{'miners': n}``."""
    from . import core
    from .backend.cuda import CudaBackend, resolve_device
    from .config import MinerConfig
    from .models.fused import FusedMiner
    from .ops import extend_midstate, sha256_cuda
    from .parallel.mesh import NONCE_SPACE, sharded_local_base

    device = resolve_device(device)
    batch = 1 << DRYRUN_BATCH_POW2
    node, header, midstate, tail = _example_inputs()
    ext = extend_midstate(midstate, tail)
    base = 0
    while True:
        slices = [sha256_cuda.sweep(ext, sharded_local_base(base, batch, i),
                                    batch, DRYRUN_DBITS, device=device)
                  for i in range(n_devices)]
        count = sum(c for c, _ in slices)
        min_nonce = min(m for _, m in slices)
        if count > 0:
            break
        base += batch * n_devices
        assert base < NONCE_SPACE, "dry run failed to find a nonce"
    winner = core.set_nonce(header, min_nonce)
    assert node.submit(winner), "mesh winner failed chain validation"
    assert node.height == 1

    search = CudaBackend(batch_pow2=DRYRUN_BATCH_POW2, n_miners=n_devices,
                         device=device).search(header, DRYRUN_DBITS)
    assert search.nonce == min_nonce, \
        "multi-round sharded searcher disagrees with the per-round sweep"

    cfg = MinerConfig(difficulty_bits=DRYRUN_DBITS, n_blocks=2,
                      batch_pow2=DRYRUN_BATCH_POW2, n_miners=n_devices,
                      backend="cuda", device=device.type)
    fused = FusedMiner(cfg, blocks_per_call=2)
    fused.mine_chain()
    assert fused.node.height == 2, "fused sharded mine step failed"
    print(f"dryrun_multichip({n_devices}): per-round block "
          f"nonce={min_nonce} hash={node.tip_hash.hex()[:16]}… ; "
          f"multiround searcher agrees; "
          f"fused 2-block chain tip={fused.node.tip_hash.hex()[:16]}… "
          f"on mesh {({'miners': n_devices})}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.graft_entry",
        description="the sharded mine step's dry run, then the sweep "
                    "entry's check")
    parser.add_argument("n", type=int, nargs="?", default=8,
                        help="miners of the dry run (default 8)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the CPU only when asked for")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    fn, example = entry(device=args.device)
    print("entry():", [int(x) for x in fn(*example)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
