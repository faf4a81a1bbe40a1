"""Command-line entry point of the port.

    python -m mpi_blockchain_tpu_torch mine --difficulty 20 --blocks 10 \\
        --batch-pow2 20 --out chain.bin
    python -m mpi_blockchain_tpu_torch mine --device cpu --difficulty 12
    python -m mpi_blockchain_tpu_torch mine --fused --blocks-per-call 100 \
        --difficulty 24 --blocks 1000 --batch-pow2 24
    python -m mpi_blockchain_tpu_torch mine --difficulty 20 --blocks 1000 \
        --checkpoint ck.bin --checkpoint-every 10 [--resume ck.bin]
    python -m mpi_blockchain_tpu_torch mine --fault-plan plan.json|seed:N
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

``mine`` searches through the resilience layer's ``ResilientBackend``
(retries, host re-validation of every winner, the step-down ladder
``cuda:<kernel>`` → ``cuda:torch`` → ``cpu``); the summary names the rung
that mined (``rung``), and a run that stepped down says ``"degraded":
true`` and warns on stderr. ``--fault-plan`` (or ``MPIBT_FAULT_PLAN``)
arms the fault-injection harness; ``--checkpoint``, ``--checkpoint-every``
and ``--resume`` save and resume sealed checkpoints
(``utils/checkpoint.py``), which ``verify`` checks as well as raw chain
files. Exit codes: 0 converged (possibly degraded, warned); 1 a resume or
verify that failed; 2 a configuration error, retries exhausted on every
rung, or a hand-written kernel that failed (``KernelError``: it did not
build or launch, a CUDA error came back at its read-back, or its rung kept
failing with no injected fault behind it; never stepped over), each as one
JSON error line; 3 an invalid fault plan, or a strict one that did not
fire in full.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

from .config import BACKENDS, DEVICES, KERNELS, PRESETS, ConfigError, \
    KernelError, MinerConfig
from .resilience import FaultPlanError, RetryExhausted


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


def _resume(miner, path: str, cfg) -> str | None:
    """Puts the chain of the --resume checkpoint into ``miner``, a torn
    tail truncated to the last valid block; returns an error message, or
    None."""
    from .resilience.policy import call_with_retry
    from .telemetry import heartbeat
    from .telemetry.events import emit_event
    from .utils.checkpoint import recover_chain

    try:
        # The checkpoint.read budget covers transient file system errors;
        # integrity damage is CheckpointError (never retried), which
        # recover_chain's truncation handles.
        node, report = call_with_retry(
            lambda: recover_chain(path, cfg.difficulty_bits),
            site="checkpoint.read")
    except RetryExhausted as e:
        return str(e.last)
    except (OSError, ValueError) as e:
        return str(e)
    miner.node = node
    # The heartbeat shows the resumed height before the first sweep.
    heartbeat("miner_heartbeat").set(node.height)
    emit_event({"event": "checkpoint_resumed", "height": node.height,
                "recovered": report["recovered"],
                "dropped_bytes": report["dropped_bytes"]})
    if report["recovered"]:
        if report["dropped_bytes"]:
            print(f"resume: torn checkpoint tail truncated to last valid "
                  f"block (height {node.height}, "
                  f"{report['dropped_bytes']} chain bytes dropped)",
                  file=sys.stderr)
        else:
            print(f"resume: checkpoint seal repaired (height "
                  f"{node.height}, no chain bytes lost)", file=sys.stderr)
    return None


def cmd_mine(args) -> int:
    from .models.fused import FusedMiner
    from .models.miner import Miner

    cfg = _config_from(args)
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG, stream=sys.stderr,
                            format="%(message)s")
    if args.checkpoint_every:
        if args.checkpoint_every < 0:
            raise ConfigError(f"--checkpoint-every must be >= 1, "
                              f"got {args.checkpoint_every}")
        if not args.checkpoint:
            raise ConfigError("--checkpoint-every needs --checkpoint PATH "
                              "(where to save)")
    if args.fused:
        miner = FusedMiner(cfg, blocks_per_call=args.blocks_per_call)
    else:
        miner = Miner(cfg)
    if args.resume:
        err = _resume(miner, args.resume, cfg)
        if err is not None:
            print(json.dumps({"event": "chain_mined", "error": err},
                             sort_keys=True))
            return 1
    # --blocks is the target height, so a resumed run mines the rest.
    remaining = max(0, cfg.n_blocks - miner.node.height)
    save = None
    if args.checkpoint_every:
        from .resilience.policy import call_with_retry
        from .utils.checkpoint import save_chain

        def save(height: int) -> None:
            # Transient file system errors retry under the
            # checkpoint.write budget: a periodic save must not kill a
            # long run.
            call_with_retry(
                lambda: save_chain(miner.node, args.checkpoint, cfg),
                site="checkpoint.write")
    t0 = time.perf_counter()
    if args.fused:
        # The fused loop appends whole device spans: save at span
        # boundaries (every span is at least one block of progress).
        miner.mine_chain(remaining, on_progress=save)
    else:
        on_block = None
        if save is not None:
            def on_block(rec):
                if rec.height % args.checkpoint_every == 0:
                    save(rec.height)
        miner.mine_chain(remaining, on_block=on_block)
    wall = time.perf_counter() - t0
    if args.out:
        with open(args.out, "wb") as f:
            f.write(miner.node.save())
    if args.checkpoint:
        from .utils.checkpoint import save_chain
        save_chain(miner.node, args.checkpoint, cfg)
    summary = {
        "event": "chain_mined",
        "config": dataclasses.asdict(cfg),
        "height": miner.node.height,
        "tip_hash": miner.node.tip_hash.hex(),
        "wall_s": round(wall, 3),
        "fused": args.fused,
    }
    if args.fused:
        backend = miner.recovery
        summary.update(kernel=miner.effective_kernel,
                       host_waits=miner.host_waits)
    else:
        backend = miner.backend
        active = getattr(backend, "active_backend", backend)
        summary.update(hashes_tried=miner.total_hashes(),
                       hashes_per_sec=round(miner.hashes_per_sec()),
                       backend=backend.name,
                       kernel=getattr(active, "effective_kernel", None),
                       rung=getattr(backend, "rung", None))
    degradations = getattr(backend, "degradations", [])
    if degradations:
        # Converged after stepping down: rc 0, but loudly. The run
        # finished on a lower rung than it was asked for.
        summary["degraded"] = True
        summary["degraded_to"] = degradations[-1]["to"]
        print(f"warning: backend degraded "
              f"{' -> '.join(d['to'] for d in degradations)} "
              f"after repeated dispatch failure; run converged anyway",
              file=sys.stderr)
    print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_verify(args) -> int:
    """Validates a saved chain file (proof of work + linkage). Accepts
    raw header files (``--out``) and sealed checkpoints (``--checkpoint``,
    whose trailer and sidecar are checked)."""
    from . import core
    from .utils.checkpoint import CheckpointError, open_checkpoint

    try:
        with open(args.chain, "rb") as f:
            blob = f.read()
    except OSError as e:
        print(json.dumps({"event": "chain_verified", "valid": False,
                          "error": str(e)}, sort_keys=True))
        return 1
    try:
        # The full integrity gate (trailer + sidecar): a torn sealed
        # checkpoint reads as invalid, never as a valid shorter chain.
        payload, sealed, _ = open_checkpoint(args.chain, blob)
    except CheckpointError as e:
        print(json.dumps({"event": "chain_verified", "valid": False,
                          "sealed": True, "error": str(e)},
                         sort_keys=True))
        return 1
    node = core.Node(args.difficulty, 0)
    ok = node.load(payload)
    print(json.dumps({
        "event": "chain_verified", "valid": bool(ok), "sealed": sealed,
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
    p_mine.add_argument("--checkpoint",
                        help="save the chain + config sidecar here when "
                             "done (atomic write + integrity trailer)")
    p_mine.add_argument("--checkpoint-every", type=int, default=0,
                        metavar="N",
                        help="also save --checkpoint every N mined blocks "
                             "(every device span with --fused), so a "
                             "SIGKILL loses at most N blocks; resume with "
                             "--resume")
    p_mine.add_argument("--resume",
                        help="load this checkpoint (checking integrity; a "
                             "torn tail is truncated to the last valid "
                             "block) and mine up to --blocks")
    p_mine.add_argument("--fault-plan", metavar="PATH|seed:N",
                        help="arm the deterministic fault-injection "
                             "harness with a JSON fault plan (or a "
                             "seed-derived one); env MPIBT_FAULT_PLAN also "
                             "arms it. Exit codes: 0 converged (possibly "
                             "degraded, warned), 2 retries exhausted or a "
                             "kernel that failed, 3 plan invalid or "
                             "unexhausted")
    p_mine.add_argument("--metrics-dump", metavar="PATH",
                        help="write the run's metrics (Prometheus text) "
                             "here on every exit path")
    p_mine.set_defaults(fn=cmd_mine)

    p_verify = sub.add_parser("verify", help="validate a saved chain file")
    p_verify.add_argument("--chain", required=True)
    p_verify.add_argument("--difficulty", type=int, required=True)
    p_verify.set_defaults(fn=cmd_verify)

    p_info = sub.add_parser("info", help="torch, CUDA and card facts")
    p_info.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    fault_arg = getattr(args, "fault_plan", None)
    if fault_arg is None and hasattr(args, "fault_plan"):
        # The environment arms only the subcommand that takes the flag.
        fault_arg = os.environ.get("MPIBT_FAULT_PLAN") or None
    plan_armed = False
    try:
        if fault_arg:
            from .resilience import injection
            from .resilience.faultplan import FaultPlan
            injection.arm(FaultPlan.parse_arg(fault_arg))
            plan_armed = True
            print(f"fault plan armed: {fault_arg}", file=sys.stderr,
                  flush=True)
        rc = args.fn(args)
        if plan_armed:
            # A strict plan demands that every fault fired; an unexhausted
            # plan is its own failure (rc 3). Only a successful run is
            # checked: an unfired fault never masks the run's own failure.
            plan_armed = False
            from .resilience import injection
            injection.disarm(strict=(rc == 0))
        return rc
    except FaultPlanError as e:
        # Before ConfigError, which it subclasses: "bad or unexhausted
        # fault plan" (3) is told apart from a bad config (2).
        print(json.dumps({"event": "error", "kind": "fault_plan",
                          "error": str(e)}, sort_keys=True))
        return 3
    except RetryExhausted as e:
        # Every attempt on every rung failed: a clean failure, not a
        # traceback.
        print(json.dumps({"event": "error", "kind": "retry_exhausted",
                          "site": e.site, "error": str(e)},
                         sort_keys=True))
        return 2
    except KernelError as e:
        # A kernel that failed to build or launch: never retried, never
        # stepped over.
        print(json.dumps({"event": "error", "kind": "kernel",
                          "error": str(e)}, sort_keys=True))
        return 2
    except ConfigError as e:
        # Config errors (no card, bad kernel/device pair, an invalid
        # checkpoint, ...) surface as one clean JSON line; any other
        # exception keeps its traceback.
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2
    finally:
        if plan_armed:
            from .resilience import injection
            injection.disarm()
        # The metrics of a failed run are what a post-mortem needs: dump
        # on every exit path, and let no dump failure mask the outcome.
        if getattr(args, "metrics_dump", None):
            from .telemetry import dump_metrics
            try:
                dump_metrics(args.metrics_dump)
            except OSError as e:
                print(f"metrics-dump failed: {e}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
