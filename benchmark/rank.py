"""A rank other than 0 of a world, started by rank 0 (``world.py``):

    python -m benchmark.rank --workload W --seed S --seconds X --trace T \
        --rank R --port P --device cuda --here DIR

It runs the same warm-up, window and traced sub-window as rank 0, in
step with it, hands what rank 0 needs to it, and ends. It prints nothing
on stdout.
"""
from __future__ import annotations

import argparse
import pathlib


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.rank")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--here", default=None)
    args = p.parse_args(argv)

    from . import harness, spec

    here = pathlib.Path(args.here) if args.here else spec.HERE
    cell = spec.cell(args.workload, root=here.parent, here=here)
    ctx = harness.Ctx(cell, args.seed, args.seconds, bool(args.trace),
                      args.device, rank=args.rank, port=args.port)
    driver = harness.make_driver(ctx)
    try:
        driver.finish(harness.run_rank(driver, ctx))
    finally:
        driver.close()
    return 0


if __name__ == "__main__":
    from mpi_blockchain_tpu_torch.parallel.distributed import exit_process

    try:
        rc = main()
    except BaseException:
        import traceback
        traceback.print_exc()
        rc = 1
    exit_process(rc)
