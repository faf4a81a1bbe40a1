"""CLI: python -m mpi_blockchain_tpu_torch.telemetry

The port's copy of the reference's telemetry CLI: runs a short
instrumented mine plus a faulted adversarial simulation (partition and
seeded drops, so the drop and reorg metrics move), then prints the
Prometheus snapshot to stdout. Per-block JSON-line events stream to
stderr while it runs.

    python -m mpi_blockchain_tpu_torch.telemetry --steps 3
    python -m mpi_blockchain_tpu_torch.telemetry --steps 3 \\
        --metrics-dump /tmp/m.prom

The reference runs both legs on its C++ sweep. The port runs them on the
card (the CUDA sweep kernel behind ``ResilientBackend``, in the mine and
in each simulated group) unless ``--device cpu`` asks for the C++ sweep,
which is the reference's run; with no card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import default_registry, dump_metrics, recent_events, reset
from ..config import DEVICES


def run_instrumented(steps: int = 3, difficulty: int = 8,
                     sim_target: int = 4, partition_steps: int = 12,
                     drop_rate_pct: int = 25, seed: int = 0,
                     sim: bool = True, device: str = "cuda") -> dict:
    """The smoke workload: a short mine and a faulted simulation, both
    driving the full telemetry wiring (miner counters and spans, backend
    spans, sim bus counters, reorg histogram, group gauges). ``device``
    "cuda" mines and searches on the card; "cpu" on the C++ sweep. Returns
    the tips and the rung each backend ended on: {"tip_hash", "rung"}
    of the mine, {"sim_tips", "sim_rungs"} of each simulated group."""
    from ..config import MinerConfig
    from ..models.miner import Miner

    if device == "cpu":
        backend = {"backend": "cpu"}
    else:
        from ..backend.cuda import resolve_device
        resolve_device(device)          # no card: a clean ConfigError
        backend = {"backend": "cuda", "device": device}
    miner = Miner(MinerConfig(difficulty_bits=difficulty, n_blocks=steps,
                              **backend))
    miner.mine_chain()
    out = {"tip_hash": miner.node.tip_hash.hex(),
           "rung": getattr(miner.backend, "rung", miner.backend.name),
           "sim_tips": [], "sim_rungs": []}
    if sim:
        from ..simulation import run_adversarial

        net = run_adversarial(config=MinerConfig(difficulty_bits=difficulty,
                                                 n_blocks=sim_target,
                                                 **backend),
                              partition_steps=partition_steps,
                              target_height=sim_target, nonce_budget=1 << 8,
                              drop_rate_pct=drop_rate_pct, seed=seed)
        out["sim_tips"] = [n.node.tip_hash.hex() for n in net.nodes]
        out["sim_rungs"] = [getattr(n.backend, "rung", n.backend.name)
                            for n in net.nodes]
    return out


def main(argv: list[str] | None = None) -> int:
    from ..config import ConfigError

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.telemetry",
        description="run a short instrumented mine + faulted simulation "
                    "and print the Prometheus metrics snapshot")
    parser.add_argument("--steps", type=int, default=3,
                        help="blocks to mine in the instrumented run "
                             "(default 3)")
    parser.add_argument("--difficulty", type=int, default=8,
                        help="leading-zero bits for the smoke mine "
                             "(default 8 — sub-second)")
    parser.add_argument("--no-sim", action="store_true",
                        help="skip the faulted simulation leg")
    parser.add_argument("--sim-target", type=int, default=4,
                        help="simulation convergence height (default 4)")
    parser.add_argument("--partition-steps", type=int, default=12,
                        help="steps the sim groups stay partitioned")
    parser.add_argument("--drop-rate", type=int, default=25,
                        help="%% of sim deliveries dropped (seeded)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics-dump", metavar="PATH", default=None,
                        help="also write the Prometheus snapshot here")
    parser.add_argument("--events", action="store_true",
                        help="append the ringed JSON events to stdout "
                             "after the snapshot")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="the card's sweep kernel, or the C++ sweep; "
                             "the CPU only when asked for")
    args = parser.parse_args(argv)

    from .events import clear_events

    reset()         # a fresh registry + event ring: the snapshot and
    clear_events()  # --events output reflect exactly this run
    try:
        run_instrumented(steps=args.steps, difficulty=args.difficulty,
                         sim_target=args.sim_target,
                         partition_steps=args.partition_steps,
                         drop_rate_pct=args.drop_rate, seed=args.seed,
                         sim=not args.no_sim, device=args.device)
    except ConfigError as e:
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2
    except RuntimeError as e:  # e.g. sim non-convergence under max_steps
        print(f"telemetry: instrumented run failed: {e}", file=sys.stderr)
        print(default_registry().render_prometheus())
        return 1
    print(default_registry().render_prometheus())
    if args.events:
        for rec in recent_events():
            print(json.dumps(rec, sort_keys=True, default=str))
    if args.metrics_dump:
        dump_metrics(args.metrics_dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
