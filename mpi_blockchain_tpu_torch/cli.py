"""Command-line entry point of the port.

    python -m mpi_blockchain_tpu_torch mine --difficulty 20 --blocks 10 \\
        --batch-pow2 20 --out chain.bin
    python -m mpi_blockchain_tpu_torch mine --device cpu --difficulty 12
    python -m mpi_blockchain_tpu_torch mine --fused --blocks-per-call 100 \
        --difficulty 24 --blocks 1000 --batch-pow2 24
    python -m mpi_blockchain_tpu_torch verify --chain chain.bin --difficulty 20
    python -m mpi_blockchain_tpu_torch info

Flags keep the reference CLI's names. ``mine`` runs on the card unless
``--device cpu`` (or ``--backend cpu``, the C++ sweep) asks for the CPU;
with no card it fails with a clean error instead of running elsewhere.
``mine --out`` writes the C++ node's ``save()`` bytes, the same format the
reference writes, so the two packages' chain files compare with ``cmp``.
``mine --fused`` mines ``--blocks-per-call`` blocks per host call with the
fused k-block miner (``models/fused.py``); as in the reference, its
summary has no ``hashes_tried``.
``verify`` reads raw chain files (sealed checkpoints come with a later
slice of the port).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time

from .config import BACKENDS, DEVICES, KERNELS, PRESETS, ConfigError, \
    MinerConfig


def _batch_pow2_arg(s: str):
    if s == "auto":
        return s
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {s!r}") from None


def _config_from(args) -> MinerConfig:
    if args.preset:
        return dataclasses.replace(PRESETS[args.preset], device=args.device)
    return MinerConfig(difficulty_bits=args.difficulty, n_blocks=args.blocks,
                       batch_pow2=args.batch_pow2, n_miners=args.miners,
                       backend=args.backend, kernel=args.kernel,
                       device=args.device)


def cmd_mine(args) -> int:
    from .models.fused import FusedMiner
    from .models.miner import Miner

    cfg = _config_from(args)
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG, stream=sys.stderr,
                            format="%(message)s")
    if args.fused:
        miner = FusedMiner(cfg, blocks_per_call=args.blocks_per_call)
    else:
        miner = Miner(cfg)
    t0 = time.perf_counter()
    miner.mine_chain(cfg.n_blocks)
    wall = time.perf_counter() - t0
    if args.out:
        with open(args.out, "wb") as f:
            f.write(miner.node.save())
    summary = {
        "event": "chain_mined",
        "config": dataclasses.asdict(cfg),
        "height": miner.node.height,
        "tip_hash": miner.node.tip_hash.hex(),
        "wall_s": round(wall, 3),
        "fused": args.fused,
    }
    if args.fused:
        summary.update(kernel=miner.effective_kernel,
                       host_waits=miner.host_waits)
    else:
        summary.update(hashes_tried=miner.total_hashes(),
                       hashes_per_sec=round(miner.hashes_per_sec()),
                       backend=miner.backend.name,
                       kernel=getattr(miner.backend, "effective_kernel",
                                      None))
    print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_verify(args) -> int:
    """Validates a saved chain file (proof of work + linkage)."""
    from . import core

    try:
        with open(args.chain, "rb") as f:
            blob = f.read()
    except OSError as e:
        print(json.dumps({"event": "chain_verified", "valid": False,
                          "error": str(e)}, sort_keys=True))
        return 1
    node = core.Node(args.difficulty, 0)
    ok = node.load(blob)
    print(json.dumps({
        "event": "chain_verified", "valid": bool(ok),
        "height": node.height if ok else None,
        "tip_hash": node.tip_hash.hex() if ok else None,
    }, sort_keys=True))
    return 0 if ok else 1


def cmd_info(args) -> int:
    """PyTorch, CUDA and card facts, and whether the kernel can build."""
    import torch

    from .ops.sha256_cuda import find_nvcc

    available = torch.cuda.is_available()
    print(json.dumps({
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": available,
        "device_count": torch.cuda.device_count() if available else 0,
        "device_name": torch.cuda.get_device_name(0) if available else None,
        "nvcc": find_nvcc(),
    }, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mpi_blockchain_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_mine = sub.add_parser("mine", help="mine a chain")
    p_mine.add_argument("--preset", choices=sorted(PRESETS),
                        help="named config (overrides the other flags "
                             "except --device)")
    p_mine.add_argument("--difficulty", type=int, default=16,
                        help="leading-zero bits (default 16)")
    p_mine.add_argument("--blocks", type=int, default=10)
    p_mine.add_argument("--miners", type=int, default=1,
                        help="CPU ranks of the cpu backend (the cuda "
                             "backend mines on one device)")
    p_mine.add_argument("--backend", choices=BACKENDS, default="cuda")
    p_mine.add_argument("--kernel", choices=KERNELS, default="auto",
                        help="sweep kernel of the cuda backend: the CUDA "
                             "kernel, the plain PyTorch version, or auto "
                             "(by device)")
    p_mine.add_argument("--batch-pow2", type=_batch_pow2_arg, default=20,
                        help="log2 nonces per sweep round, or 'auto' to "
                             "track the difficulty (clamped to [13, 24])")
    p_mine.add_argument("--device", choices=DEVICES, default="cuda",
                        help="torch device of the cuda backend; the CPU "
                             "only when asked for")
    p_mine.add_argument("--fused", action="store_true",
                        help="mine with the fused k-block loop on the "
                             "device (one host call per --blocks-per-call)")
    p_mine.add_argument("--blocks-per-call", type=int, default=16)
    p_mine.add_argument("--out", help="write the chain to this file")
    p_mine.add_argument("--verbose", action="store_true",
                        help="per-block JSON lines on stderr")
    p_mine.set_defaults(fn=cmd_mine)

    p_verify = sub.add_parser("verify", help="validate a saved chain file")
    p_verify.add_argument("--chain", required=True)
    p_verify.add_argument("--difficulty", type=int, required=True)
    p_verify.set_defaults(fn=cmd_verify)

    p_info = sub.add_parser("info", help="torch, CUDA and card facts")
    p_info.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ConfigError as e:
        # Config errors (no card, bad kernel/device pair, ...) surface as
        # one clean JSON line; any other exception keeps its traceback.
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2


if __name__ == "__main__":
    sys.exit(main())
