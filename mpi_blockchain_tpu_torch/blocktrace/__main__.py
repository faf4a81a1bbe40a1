"""CLI: python -m mpi_blockchain_tpu_torch.blocktrace overhead

``overhead`` runs the telemetry self-overhead audit and prints its
payload, ``{"event": "trace_overhead", ...}`` (``--block-observe`` for
the per-block observation's, ``trace_block_observe``). It runs on the
card unless ``--device cpu`` asks for the C++ sweep, and exits 1 when
``overhead_pct`` is over the reference's 3% bound. The reference's
``smoke`` subcommand (two ``--mesh-obs`` ranks) waits for the
``--mesh-obs`` slice of the port.
"""
from __future__ import annotations

import argparse
import json
import sys


def cmd_overhead(args) -> int:
    from ..perfwatch.detector import SECTION_BOUNDS
    from .overhead import measure_block_observe, measure_trace_overhead

    if args.device != "cpu":
        from ..backend.cuda import resolve_device
        resolve_device(args.device)     # no card: a clean ConfigError
    if args.block_observe:
        payload = measure_block_observe(device=args.device)
        print(json.dumps({"event": "trace_block_observe", **payload},
                         sort_keys=True))
        return 0
    payload = measure_trace_overhead(seconds=args.seconds, reps=args.reps,
                                     device=args.device)
    print(json.dumps({"event": "trace_overhead", **payload},
                     sort_keys=True))
    return 0 if payload["overhead_pct"] <= SECTION_BOUNDS["trace_overhead"] \
        else 1


def main(argv: list[str] | None = None) -> int:
    from ..config import ConfigError

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.blocktrace",
        description="telemetry self-overhead audit")
    sub = parser.add_subparsers(dest="command", required=True)
    p_ovh = sub.add_parser("overhead", help="measure the telemetry "
                                            "self-overhead payload")
    p_ovh.add_argument("--seconds", type=float, default=1.0,
                       help="seconds of paired rounds per rep "
                            "(default %(default)s)")
    p_ovh.add_argument("--reps", type=int, default=3,
                       help="independent paired-median reps "
                            "(default %(default)s)")
    p_ovh.add_argument("--block-observe", action="store_true",
                       help="measure the per-block critical-path "
                            "observation instead of the per-round "
                            "overhead")
    p_ovh.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="the round's sweep: the CUDA kernel on the card "
                            "or the C++ sweep; the CPU only when asked for")
    p_ovh.set_defaults(fn=cmd_overhead)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ConfigError as e:
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2


if __name__ == "__main__":
    sys.exit(main())
