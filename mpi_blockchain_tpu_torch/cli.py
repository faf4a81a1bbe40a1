"""Command-line entry point of the port.

    python -m mpi_blockchain_tpu_torch mine --difficulty 20 --blocks 10 \\
        --batch-pow2 20 --out chain.bin
    python -m mpi_blockchain_tpu_torch mine --device cpu --difficulty 12
    python -m mpi_blockchain_tpu_torch mine --fused --blocks-per-call 100 \
        --difficulty 24 --blocks 1000 --batch-pow2 24
    python -m mpi_blockchain_tpu_torch mine --difficulty 20 --blocks 1000 \
        --checkpoint ck.bin --checkpoint-every 10 [--resume ck.bin]
    python -m mpi_blockchain_tpu_torch mine --fault-plan plan.json|seed:N
    python -m mpi_blockchain_tpu_torch mine --preset tpu-mesh8 [--fused]
    python -m mpi_blockchain_tpu_torch mine --difficulty 20 --blocks 10 \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0
    python -m mpi_blockchain_tpu_torch mine --elastic --process-id 1 \
        --num-processes 4 --mesh-obs DIR --events-dump causal_1.json
    python -m mpi_blockchain_tpu_torch mine --elastic --miners 4
    python -m mpi_blockchain_tpu_torch bench --mode sweep --seconds 5
    python -m mpi_blockchain_tpu_torch bench --mode chain --blocks 1000
    python -m mpi_blockchain_tpu_torch verify --chain chain.bin --difficulty 20
    python -m mpi_blockchain_tpu_torch sim --preset adversarial
    python -m mpi_blockchain_tpu_torch sim --difficulty 24 --blocks 12 \
        --nonce-budget-pow2 24 --batch-pow2 24 --partition-steps 8
    python -m mpi_blockchain_tpu_torch sim --preset adversarial-bench
    python -m mpi_blockchain_tpu_torch serve --difficulty 24 --blocks 1000 \
        --batch-pow2 24 --port 9100
    python -m mpi_blockchain_tpu_torch mine --serve 9100 --difficulty 20
    python -m mpi_blockchain_tpu_torch mine --serve-metrics 0 --difficulty 20
    python -m mpi_blockchain_tpu_torch info

Flags keep the reference CLI's names. ``mine`` runs on the card unless
``--device cpu`` (or ``--backend cpu``, the C++ sweep) asks for the CPU;
with no card it fails with a clean error instead of running elsewhere.
``mine --out`` writes the C++ node's ``save()`` bytes, the same format the
reference writes, so the two packages' chain files compare with ``cmp``.
``mine --fused`` mines ``--blocks-per-call`` blocks per host call with the
fused k-block miner (``models/fused.py``); as in the reference, its
summary has no ``hashes_tried``. ``--miners N`` splits each round over N
logical miners in this process; ``--coordinator/--num-processes/
--process-id`` make this process one miner of a world of processes
(gloo, ``parallel/distributed.py``), every process running the same
command, and rank 0 alone writes ``--out``, ``--checkpoint`` and the
summary. ``bench`` measures the sweep rate (``--mode sweep``) or a whole
chain's wall (``--mode chain``) and prints one JSON payload
(``bench_lib.py``).

``mine --elastic`` survives a dead peer (``resilience/elastic.py``). As
one rank of a process-per-rank world (``--process-id/--num-processes``,
or ``MPIBT_MESH_RANK``/``MPIBT_MESH_WORLD``, and no ``--coordinator``) it
sweeps its stripe of the nonce space, evicts a peer the ``--mesh-obs``
shard oracle confirms dead (or a seeded ``mesh.rank_death`` fault kills),
re-stripes over the survivors and mines on; every rank prints its own
summary, with a ``mesh`` object. With ``--miners N`` on the cuda backend
it mines through ``ElasticMeshBackend``, which shrinks its logical miners
on a suspected rank loss (``summary["mesh"]["device_mesh"]``).
``--events-dump PATH`` writes the rank's causal log (membership changes
and mined blocks), the reference's bytes for the same run, which ``python
-m mpi_blockchain_tpu_torch.forensics`` reads. ``--resume`` restores the
checkpoint sidecar's shrunken membership. ``--elastic`` refuses
``--coordinator`` and ``--fused``.

``sim`` runs BASELINE config 5, competing miner groups that fork in a
partition and reconcile by longest-chain reorg (``simulation.py``), on the
real-chain bus: each group searches through its own ``ResilientBackend``,
so on the card every group's bounded search is one launch of the sweep
kernel. Like ``mine`` it runs on the card unless ``--device cpu`` or
``--backend cpu`` asks for the CPU (the reference's ``sim`` defaults to
its CPU backend). A scenario preset (``--preset adversarial-bench``) or
``--nodes N`` runs the vectorized scenario engine instead (``sim/``), a
seeded lottery in numpy on the host in both packages. ``sim`` exits 1 when
the run does not converge (the flight recorder dumps, if armed);
``--events-dump`` writes every node's causal log, the same bytes the
reference writes for the same run.

``serve`` mines a chain while the blockserve front door
(``service/``) takes transactions over HTTP: ``POST /submit``, ``GET
/tx_status``, ``/chain``, ``/template``, with ``/metrics``, ``/healthz`` and
``/events``; a bounded fee-ordered mempool feeds each block's template
through the miner's ``payload_for`` seam. ``mine --serve PORT`` attaches
the same door to a mine run (not with ``--fused``, whose device loop
never reads ``payload_for``, and not in a world of processes, whose ranks
must search the same header). ``--serve-metrics PORT`` (or
``MPIBT_METRICS_PORT``) on mine, sim, bench and serve serves
``/metrics``, ``/healthz`` and ``/events`` for the run's length
(``perfwatch/server.py``); port 0 binds a free port, announced on stderr.
Like ``mine``, ``serve`` runs on the card unless ``--device cpu``.

Every block is traced (``blocktrace``, ``meshwatch.pipeline``), and the
``mine`` summary carries the reference's ``pipeline`` object once any
dispatch was recorded: ``host_overlapped_fraction``, ``bubble_fraction``
(the device's idle share of the run) and ``speculative_discards``.
``--incident-dir DIR`` (or ``MPIBT_INCIDENT_DIR``) on mine, bench, sim and
serve arms the ``chainwatch`` watchdog for the run's length, with its
evidence bundles written into DIR.
``--mesh-obs DIR`` (or ``MPIBT_MESH_OBS``) on the same four writes this
rank's telemetry shard into DIR on a flusher thread, and a final one on
exit carrying the exit status (``meshwatch/shard.py``); the rank is
``--process-id`` or ``MPIBT_MESH_RANK``. ``python -m
mpi_blockchain_tpu_torch.meshwatch`` merges a directory of shards,
reports its pipeline and serves the mesh ``/healthz``. A shard armed
without ``--incident-dir`` arms the watchdog too, without bundles.

``mine`` searches through the resilience layer's ``ResilientBackend``
(retries, host re-validation of every winner, the step-down ladder
``cuda:<kernel>`` → ``cuda:torch`` → ``cpu``); the summary names the rung
that mined (``rung``), and a run that stepped down says ``"degraded":
true`` and warns on stderr. ``--fault-plan`` (or ``MPIBT_FAULT_PLAN``)
arms the fault-injection harness; ``--checkpoint``, ``--checkpoint-every``
and ``--resume`` save and resume sealed checkpoints
(``utils/checkpoint.py``), which ``verify`` checks as well as raw chain
files. ``--flight-recorder PATH`` (or ``MPIBT_FLIGHT_RECORDER``) arms the
crash flight recorder (``telemetry/flight_recorder.py``). Exit codes: 0
converged (possibly degraded, warned); 1 a resume or verify that failed,
or a simulation that did not converge; 2 a configuration error, retries
exhausted on every rung, or a hand-written kernel that failed
(``KernelError``: it did not build or launch, a CUDA error came back at
its read-back, or its rung kept failing with no injected fault behind it;
never stepped over), each as one JSON error line; 3 an invalid fault
plan, or a strict one that did not fire in full.
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

#: The vectorized engine's preset names (``sim.SCENARIO_PRESETS``), as a
#: literal so that building the parser imports no numpy; a test holds the
#: two equal.
SCENARIO_PRESET_NAMES = ("adversarial-1k", "adversarial-bench",
                         "adversarial-smoke")


def _batch_pow2_arg(s: str):
    if s == "auto":
        return s
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {s!r}") from None


def _add_metrics_dump_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--metrics-dump", metavar="PATH",
                   help="write the run's metrics (Prometheus text) here on "
                        "every exit path")
    p.add_argument("--flight-recorder", metavar="PATH",
                   help="arm the crash flight recorder: on an abnormal exit "
                        "(uncaught exception, sim non-convergence, a device "
                        "init that hangs) dump events, causal logs and a "
                        "metrics snapshot to PATH (env "
                        "MPIBT_FLIGHT_RECORDER also arms it)")
    p.add_argument("--serve-metrics", metavar="PORT", type=int, default=None,
                   help="serve /metrics, /healthz, /events over HTTP for "
                        "the duration of the run (0 = ephemeral port, "
                        "announced on stderr; env MPIBT_METRICS_PORT also "
                        "enables it)")
    p.add_argument("--mesh-obs", metavar="DIR", default=None,
                   help="write this rank's telemetry shard (registry "
                        "snapshot, heartbeats, pipeline records) into DIR "
                        "on a background flusher, for mesh-wide "
                        "aggregation with python -m "
                        "mpi_blockchain_tpu_torch.meshwatch (env "
                        "MPIBT_MESH_OBS also arms it; rank from "
                        "--process-id or MPIBT_MESH_RANK)")
    p.add_argument("--incident-dir", metavar="DIR", default=None,
                   help="arm the chainwatch live watchdog with an "
                        "incident-bundle directory: anomaly rules run on "
                        "the per-block telemetry cadence and a firing rule "
                        "writes a bounded, non-fatal evidence bundle into "
                        "DIR while the run keeps mining (env "
                        "MPIBT_INCIDENT_DIR also arms it; --mesh-obs arms "
                        "the rules without bundles)")


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(PRESETS),
                   help="named config (overrides the other flags except "
                        "--device)")
    p.add_argument("--difficulty", type=int, default=16,
                   help="leading-zero bits (default 16)")
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--miners", type=int, default=1,
                   help="miners that split each round: C++ ranks of the cpu "
                        "backend, logical miners of the cuda backend in this "
                        "process")
    p.add_argument("--backend", choices=BACKENDS, default="cuda")
    p.add_argument("--kernel", choices=KERNELS, default="auto",
                   help="sweep kernel of the cuda backend: the CUDA kernel, "
                        "the plain PyTorch version, or auto (by device)")
    p.add_argument("--batch-pow2", type=_batch_pow2_arg, default=20,
                   help="log2 nonces per sweep round, or 'auto' to track "
                        "the difficulty (clamped to [13, 24])")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="torch device of the cuda backend; the CPU only "
                        "when asked for")


def _add_fault_plan_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fault-plan", metavar="PATH|seed:N",
                   help="arm the deterministic fault-injection harness "
                        "with a JSON fault plan (or a seed-derived one); "
                        "env MPIBT_FAULT_PLAN also arms it. Exit codes: 0 "
                        "converged (possibly degraded, warned), 2 retries "
                        "exhausted or a kernel that failed, 3 plan invalid "
                        "or unexhausted")


def _config_from(args) -> MinerConfig:
    if args.preset:
        return dataclasses.replace(PRESETS[args.preset], device=args.device)
    return MinerConfig(difficulty_bits=args.difficulty, n_blocks=args.blocks,
                       batch_pow2=args.batch_pow2, n_miners=args.miners,
                       backend=args.backend, kernel=args.kernel,
                       device=args.device)


def _resume(miner, path: str, cfg, world=None) -> str | None:
    """Puts the chain of the --resume checkpoint into ``miner``, a torn
    tail truncated to the last valid block, and the sidecar's membership
    into the elastic ``world`` when there is one; returns an error
    message, or None."""
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
    if world is not None and report.get("mesh"):
        # The sidecar's membership restores the shrunken world: a resumed
        # survivor keeps its re-striped share instead of re-assuming the
        # seed world (and re-overlapping stripes the survivors re-covered).
        world.restore(report["mesh"])
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


def _mesh_identity(args) -> tuple[int, int]:
    """This process's (rank, world_size) for its shard: the world-of-
    processes flags win; a standalone rank (one process a rank, no
    coordinator) is labeled through MPIBT_MESH_RANK / MPIBT_MESH_WORLD by
    whatever launched it."""
    from .telemetry.events import env_number

    rank = getattr(args, "process_id", None)
    if rank is None:
        rank = env_number("MPIBT_MESH_RANK", 0, cast=int, minimum=0)
    world = getattr(args, "num_processes", None)
    if world is None:
        world = env_number("MPIBT_MESH_WORLD", 1, cast=int, minimum=1)
    return rank, world


def _init_world(args, cfg):
    """Joins the world of processes when --coordinator is given: every
    process runs this same command, one miner on its card
    (``cuda:<rank % device_count>``). Returns (cfg, group, is_main)."""
    if not args.coordinator:
        return cfg, None, True
    import torch
    import torch.distributed as dist

    from .parallel.distributed import init_distributed
    from .resilience.policy import call_with_retry

    # A slow-to-bind peer is the classic transient launch fault: retry
    # under the distributed.init budget before giving up (rc 2).
    call_with_retry(
        lambda: init_distributed(args.coordinator, args.num_processes,
                                 args.process_id),
        site="distributed.init")
    if cfg.device == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    cfg = dataclasses.replace(cfg, backend="cuda",
                              n_miners=dist.get_world_size())
    return cfg, dist.group.WORLD, dist.get_rank() == 0


def _agree_on_resume(miner, err: str | None) -> str | None:
    """In a world of processes every rank must resume from the same chain,
    or they run different numbers of rounds and the collectives hang:
    compare (ok, height, tip) across the ranks before the first search."""
    import torch
    import torch.distributed as dist

    ok = err is None
    tip = miner.node.tip_hash[:8] if ok else bytes(8)
    state = torch.tensor([int(ok), miner.node.height if ok else -1,
                          int.from_bytes(tip, "big") >> 1],
                         dtype=torch.int64)
    rows = [torch.zeros_like(state) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, state)
    if any(not torch.equal(r, rows[0]) for r in rows):
        return (f"resume state diverges across processes (this process: "
                f"{err or 'ok'})")
    return err


def _elastic_miner(args, cfg):
    """The ``--elastic`` miner and its world: an ``ElasticMiner`` striped
    over this rank's ``ElasticWorld``, searching through
    ``ElasticMeshBackend`` when the cuda backend splits rounds over more
    than one logical miner. Returns (miner, world)."""
    from .resilience.elastic import (ElasticMeshBackend, ElasticMiner,
                                     ElasticWorld)

    rank, world_size = _mesh_identity(args)
    obs = args.mesh_obs or os.environ.get("MPIBT_MESH_OBS") or None
    if world_size > 1 and obs is None:
        # Without the shard oracle the supervisor is blind: a SIGKILLed
        # peer is never evicted and its stripes never re-covered. Seeded
        # mesh.rank_death plans still work (the plan names the deaths),
        # so warn rather than refuse.
        print("elastic: multi-rank world has no --mesh-obs/"
              "MPIBT_MESH_OBS shard oracle — dead peers will not be "
              "detected or evicted", file=sys.stderr, flush=True)
    world = ElasticWorld(world_size, rank, obs_dir=obs)
    backend = (ElasticMeshBackend(cfg)
               if cfg.backend == "cuda" and cfg.n_miners > 1 else None)
    return ElasticMiner(cfg, world, backend=backend), world


def cmd_mine(args) -> int:
    cfg = _config_from(args)
    if args.serve is not None and args.fused:
        raise ConfigError(
            "--serve needs the per-block miner (drop --fused): the "
            "template feed rebinds Miner.payload_for at block "
            "boundaries, a seam the fused device loop never consults")
    if args.serve is not None and args.coordinator:
        # The reference opens the door on rank 0 alone; its templates would
        # then differ between the ranks, whose winner-selects combine
        # searches of different headers.
        raise ConfigError(
            "--serve with --coordinator is not supported: the door's "
            "templates would exist on rank 0 alone, and the ranks must "
            "search the same header; serve from a single process")
    if args.elastic and args.coordinator:
        raise ConfigError(
            "--elastic cannot ride a torch.distributed world (a gloo "
            "world's size is fixed at init and cannot shrink); run "
            "elastic ranks as independent processes sharing --mesh-obs")
    if args.elastic and args.fused:
        raise ConfigError(
            "--elastic needs the per-block miner (drop --fused): the "
            "fused device loop has no per-block supervision point to "
            "evict and re-stripe at")
    if args.fused and args.coordinator:
        raise ConfigError(
            "--fused with --coordinator needs a collective inside the "
            "k-block call, which is not ported yet (ROADMAP §A); drop "
            "--fused to mine as a world of processes")
    cfg, group, is_main = _init_world(args, cfg)
    try:
        return _mine(args, cfg, group, is_main)
    finally:
        if group is not None:
            from .parallel.distributed import shutdown_distributed
            shutdown_distributed()


def _mine(args, cfg, group, is_main: bool) -> int:
    from .models.fused import FusedMiner
    from .models.miner import Miner

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
    world = None
    if args.elastic:
        miner, world = _elastic_miner(args, cfg)
    elif args.fused:
        miner = FusedMiner(cfg, blocks_per_call=args.blocks_per_call)
    elif group is not None:
        from .backend import backend_from_config
        miner = Miner(cfg, backend=backend_from_config(cfg, group=group))
    else:
        miner = Miner(cfg)
    if args.resume:
        err = _resume(miner, args.resume, cfg, world)
        if group is not None:
            err = _agree_on_resume(miner, err)
        if err is not None:
            print(json.dumps({"event": "chain_mined", "error": err},
                             sort_keys=True))
            return 1

    def membership():
        # The elastic world's membership rides every checkpoint sidecar.
        return world.membership() if world is not None else None

    # --blocks is the target height, so a resumed run mines the rest.
    remaining = max(0, cfg.n_blocks - miner.node.height)
    save = None
    # Every rank of a world mines the same chain; only rank 0 writes it.
    if args.checkpoint_every and is_main:
        from .meshwatch.pipeline import profiler
        from .resilience.policy import call_with_retry
        from .utils.checkpoint import save_chain

        def save(height: int) -> None:
            # Transient file system errors retry under the
            # checkpoint.write budget: a periodic save must not kill a
            # long run. The save is the dispatch pipeline's `checkpoint`
            # segment: it sits on the host between sweeps.
            with profiler().segment_on_last("checkpoint"):
                call_with_retry(
                    lambda: save_chain(miner.node, args.checkpoint, cfg,
                                       mesh=membership()),
                    site="checkpoint.write")
    service_state = service_summary = None
    if args.serve is not None:
        from .service import install_service
        service_state = install_service(miner, port=args.serve)
        print(f"serving chain on http://127.0.0.1:"
              f"{service_state.server.port} "
              f"(/submit /tx_status /chain /template)",
              file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
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
    finally:
        if service_state is not None:
            # Stats before teardown, and the door closes on every exit
            # path: a crashed mine leaves no socket serving a dead miner.
            from .service import uninstall_service
            service_summary = service_state.stats()
            uninstall_service(service_state)
    wall = time.perf_counter() - t0
    if not is_main:      # the other ranks mine but stay silent
        return 0
    if args.out:
        with open(args.out, "wb") as f:
            f.write(miner.node.save())
    if args.checkpoint:
        from .utils.checkpoint import save_chain
        save_chain(miner.node, args.checkpoint, cfg, mesh=membership())
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
    if service_summary is not None:
        summary["service"] = service_summary
    from .meshwatch.pipeline import pipeline_report
    from .telemetry import default_registry
    pipe = pipeline_report()
    if pipe["dispatch_count"]:
        # host_overlapped_fraction: how much host work hid behind device
        # windows; bubble_fraction: the device's idle share of the run.
        # The device window is the card's own (the pipelined Miner), the
        # call to its read-back (fused), or the search call (no card).
        summary["pipeline"] = {
            "host_overlapped_fraction": pipe["host_overlapped_fraction"],
            "bubble_fraction": pipe["bubble_fraction"],
            "speculative_discards": int(default_registry().total(
                "speculative_discards_total")),
        }
    if world is not None:
        summary["mesh"] = world.summary()
        if hasattr(miner.backend, "n_live"):   # ElasticMeshBackend
            summary["mesh"]["device_mesh"] = miner.backend.summary()
        if args.events_dump:
            # As sim's --events-dump: a dump failure must not mask the
            # run's own outcome.
            try:
                world.dump_causal(args.events_dump,
                                  meta={"target_blocks": cfg.n_blocks,
                                        "difficulty_bits":
                                            cfg.difficulty_bits})
            except OSError as e:
                print(f"events-dump failed: {e}", file=sys.stderr)
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


def cmd_serve(args) -> int:
    """Mines a chain while serving the blockserve front door: submit,
    tx_status, chain and template over HTTP. The form of ``mine --serve``
    with the door's knobs; exits when the chain reaches --blocks."""
    from .models.miner import Miner
    from .service import (Mempool, TemplateFeed, install_service,
                          uninstall_service)

    cfg = _config_from(args)
    miner = Miner(cfg)
    mempool = Mempool(cap=args.mempool_cap)          # None -> env default
    feed = TemplateFeed(mempool, cfg, max_txs=args.template_txs)
    state = install_service(miner, port=args.port, host=args.host,
                            mempool=mempool, feed=feed,
                            deadline_s=args.deadline)
    print(json.dumps({
        "event": "service_started",
        "url": f"http://{args.host}:{state.server.port}",
        "endpoints": ["/submit", "/tx_status", "/chain", "/template",
                      "/metrics", "/healthz", "/events"]},
        sort_keys=True), file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        miner.mine_chain(cfg.n_blocks)
    finally:
        stats = state.stats()
        uninstall_service(state)
    print(json.dumps({
        "event": "chain_served",
        "height": miner.node.height,
        "tip_hash": miner.node.tip_hash.hex(),
        "wall_s": round(time.perf_counter() - t0, 3),
        "backend": miner.backend.name,
        "rung": getattr(miner.backend, "rung", None),
        "service": stats,
    }, sort_keys=True))
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


def cmd_bench(args) -> int:
    from .bench_lib import bench_chain, run_bench

    if args.mode == "chain":
        result = bench_chain(n_blocks=args.blocks,
                             difficulty_bits=args.difficulty,
                             batch_pow2=(args.batch_pow2
                                         if args.batch_pow2 is not None
                                         else 24),
                             blocks_per_call=args.blocks_per_call,
                             n_miners=args.miners, kernel=args.kernel,
                             device=args.device)
    else:
        # The raw sweep has no difficulty to track, so "auto" falls back
        # to the launch-amortizing default.
        pow2 = args.batch_pow2 if isinstance(args.batch_pow2, int) else 28
        result = run_bench(backend=args.backend, seconds=args.seconds,
                           batch_pow2=pow2, n_miners=args.miners,
                           kernel=args.kernel, device=args.device)
    print(json.dumps(result, sort_keys=True))
    return 0


def _sim_scenario_from(args):
    """Resolves the vectorized engine's scenario: a named scenario preset,
    or an ad-hoc one from the --nodes/--steps/strategy/churn/retarget
    flags. Returns None when the real-chain bus runs instead."""
    from .sim import (SCENARIO_PRESETS, AdversarySpec, ChurnSchedule,
                      LatencySpec, RetargetRule, Scenario)

    if args.preset in SCENARIO_PRESETS:
        if args.nodes is not None:
            raise ConfigError(
                f"--nodes cannot resize scenario preset {args.preset} "
                f"(its partitions/churn/adversaries are sized to "
                f"{SCENARIO_PRESETS[args.preset].n_nodes} nodes); "
                f"build an ad-hoc scenario with --nodes alone")
        sc = SCENARIO_PRESETS[args.preset]
        # Every flag given overrides the preset (an explicit 0 too: the
        # defaults are None); a silently dropped --strategy would be an
        # attack that never ran.
        seed = sc.seed if args.seed is None else args.seed
        steps = sc.steps if args.steps is None else args.steps
        over: dict = {"seed": seed, "steps": steps}
        if args.difficulty is not None:
            over["difficulty_bits"] = args.difficulty
        if args.hashes_per_step is not None:
            over["hashes_per_step"] = args.hashes_per_step
        if args.converge_margin is not None:
            over["converge_margin"] = args.converge_margin
        if args.drop_rate is not None:
            over["drop_rate_pct"] = args.drop_rate
        if args.latency is not None:
            over["latency"] = LatencySpec.parse(args.latency)
        if args.retarget is not None:
            over["retarget"] = RetargetRule.parse(args.retarget)
        if args.strategy:
            over["adversaries"] = tuple(AdversarySpec.parse(s)
                                        for s in args.strategy)
        if args.churn is not None:
            over["churn"] = ChurnSchedule.from_seed(
                seed, sc.n_nodes, steps, args.churn)
        return dataclasses.replace(sc, **over)
    if args.nodes is None:
        # The real-chain bus, but flags of the vectorized engine alone
        # must not be ignored in silence (a "flood attack" that never ran).
        vec_only = [flag for flag, value in (
            ("--strategy", args.strategy), ("--churn", args.churn),
            ("--steps", args.steps),
            ("--latency", args.latency),
            ("--hashes-per-step", args.hashes_per_step),
            ("--converge-margin", args.converge_margin))
            if value is not None and value != []]
        if vec_only:
            raise ConfigError(
                f"{'/'.join(vec_only)} need the vectorized engine: "
                f"pass --nodes N or a scenario preset "
                f"({', '.join(sorted(SCENARIO_PRESETS))})")
        return None
    if args.preset:
        # A mining preset composed with --nodes would be discarded by the
        # vectorized engine in silence: refuse instead.
        raise ConfigError(
            f"--preset {args.preset} is a legacy mining preset; with "
            f"--nodes use a scenario preset "
            f"({', '.join(sorted(SCENARIO_PRESETS))}) or drop --nodes")
    seed = 0 if args.seed is None else args.seed
    steps = 1000 if args.steps is None else args.steps
    return Scenario(
        n_nodes=args.nodes,
        steps=steps,
        seed=seed,
        difficulty_bits=(16 if args.difficulty is None
                         else args.difficulty),
        hashes_per_step=(32 if args.hashes_per_step is None
                         else args.hashes_per_step),
        retarget=(RetargetRule.parse(args.retarget)
                  if args.retarget else None),
        latency=LatencySpec.parse(args.latency or "1"),
        drop_rate_pct=args.drop_rate or 0,
        churn=ChurnSchedule.from_seed(seed, args.nodes, steps,
                                      args.churn or 0),
        adversaries=tuple(AdversarySpec.parse(s)
                          for s in (args.strategy or [])),
        converge_margin=(1000 if args.converge_margin is None
                         else args.converge_margin),
    )


def _register_network(net) -> None:
    """Hands a simulation network to the flight recorder, if armed, before
    the run starts: a run that does not converge raises out of the run,
    and its causal logs are what the dump must hold."""
    from .telemetry import flight_recorder

    if flight_recorder.installed():
        flight_recorder.register_network(net)


def _cmd_sim_vec(args, scenario) -> int:
    """The vectorized scenario engine behind ``sim`` (host numpy)."""
    from .sim import run_scenario
    from .telemetry import flight_recorder

    t0 = time.perf_counter()
    net, summary = run_scenario(scenario, on_network=_register_network)
    wall = time.perf_counter() - t0
    if args.events_dump:
        try:
            net.dump_causal(args.events_dump,
                            meta={"preset": args.preset})
        except OSError as e:
            print(f"events-dump failed: {e}", file=sys.stderr)
    summary["wall_s"] = round(wall, 3)
    summary["steps_per_sec"] = round(scenario.steps / wall, 1) if wall \
        else None
    print(json.dumps(summary, sort_keys=True))
    if not summary["converged"]:
        flight_recorder.dump_now("vec sim non-convergence at cutoff")
        return 1
    return 0


def cmd_sim(args) -> int:
    """BASELINE config 5 from the command line: partition, then reorg.
    Scenario presets and --nodes run the vectorized engine instead of the
    real-chain bus."""
    from .simulation import run_adversarial
    from .telemetry import flight_recorder

    scenario = _sim_scenario_from(args)
    if scenario is not None:
        return _cmd_sim_vec(args, scenario)
    if args.seed is None:     # the real-chain bus: plain defaults
        args.seed = 0
    if args.drop_rate is None:
        args.drop_rate = 0

    retarget = None
    if args.retarget:
        from .sim import RetargetRule
        retarget = RetargetRule.parse(args.retarget)
    if args.preset:
        cfg = dataclasses.replace(PRESETS[args.preset], device=args.device)
        target_height = cfg.n_blocks
    else:  # flags always take effect (difficulty defaults to the sim's 8)
        cfg = MinerConfig(
            difficulty_bits=8 if args.difficulty is None else args.difficulty,
            n_blocks=args.blocks, backend=args.backend,
            kernel=args.kernel, batch_pow2=args.batch_pow2,
            device=args.device)
        target_height = args.blocks

    held: dict = {}

    def _on_network(net) -> None:
        held["net"] = net
        _register_network(net)

    def _dump_events() -> None:
        # A dump failure must not mask the run's own outcome.
        if args.events_dump and "net" in held:
            try:
                held["net"].dump_causal(args.events_dump, meta={
                    "seed": args.seed, "groups": args.groups,
                    "partition_steps": args.partition_steps,
                    "drop_rate_pct": args.drop_rate,
                    "delay_steps": args.delay_steps,
                    "target_height": target_height,
                    "difficulty_bits": cfg.difficulty_bits})
            except OSError as e:
                print(f"events-dump failed: {e}", file=sys.stderr)

    try:
        net = run_adversarial(config=cfg,
                              partition_steps=args.partition_steps,
                              target_height=target_height,
                              nonce_budget=1 << args.nonce_budget_pow2,
                              delay_steps=args.delay_steps,
                              drop_rate_pct=args.drop_rate,
                              seed=args.seed, n_groups=args.groups,
                              retarget=retarget,
                              on_network=_on_network)
    except RuntimeError as e:  # Network.run: no convergence in max_steps
        if not hasattr(e, "network"):
            # Only Network.run's non-convergence carries .network; any
            # other RuntimeError (a KernelError among them) keeps its
            # traceback and its own exit code, and is never reported as
            # a consensus outcome.
            raise
        # Handled (rc 1), not a crash, so the dump is made here.
        flight_recorder.dump_now(f"sim non-convergence: {e}")
        _dump_events()
        print(json.dumps({"event": "sim_done", "converged": False,
                          "error": str(e)}, sort_keys=True))
        return 1
    _dump_events()
    tips = {n.node.tip_hash.hex() for n in net.nodes}
    degradations = [d for n in net.nodes
                    for d in getattr(n.backend, "degradations", [])]
    if degradations:
        print(f"warning: {len(degradations)} backend degradation(s) "
              f"during the sim; converged anyway", file=sys.stderr)
    out = {
        "event": "sim_done",
        "converged": net.converged(),
        "degraded": bool(degradations),
        "steps": net.step_count,
        "heights": [n.node.height for n in net.nodes],
        "tips": sorted(tips),
        "stats": [dataclasses.asdict(n.stats) for n in net.nodes],
        # height == mined + accepted + adopted - reorged_away on every
        # node (the suffix-sync stats contract).
        "stats_conserved": all(n.stats.conserved_height() == n.node.height
                               for n in net.nodes),
    }
    print(json.dumps(out, sort_keys=True))
    return 0 if net.converged() else 1


def cmd_info(args) -> int:
    """PyTorch, CUDA and card facts, whether the kernel can build, and
    this process's place in its world."""
    import torch

    from .ops.sha256_cuda import find_nvcc
    from .parallel.distributed import world_info

    available = torch.cuda.is_available()
    print(json.dumps({
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": available,
        "device_count": torch.cuda.device_count() if available else 0,
        "device_name": torch.cuda.get_device_name(0) if available else None,
        "nvcc": find_nvcc(),
        **world_info(),
    }, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mpi_blockchain_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_mine = sub.add_parser("mine", help="mine a chain")
    _add_config_args(p_mine)
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
    _add_fault_plan_arg(p_mine)
    _add_metrics_dump_arg(p_mine)
    p_mine.add_argument("--coordinator", metavar="HOST:PORT",
                        help="multi-process launch: rank 0's address "
                             "(run the same command in every process; "
                             "the mpirun -np N equivalent, over gloo)")
    p_mine.add_argument("--num-processes", type=int, default=None,
                        help="multi-process launch: world size")
    p_mine.add_argument("--process-id", type=int, default=None,
                        help="multi-process launch: this process's rank")
    p_mine.add_argument("--serve", metavar="PORT", type=int, default=None,
                        help="open the blockserve front door on PORT "
                             "(0 = ephemeral) while mining: /submit "
                             "/tx_status /chain /template; not with "
                             "--fused")
    p_mine.add_argument("--elastic", action="store_true",
                        help="rank-death survival: this rank sweeps its "
                             "stripe of the nonce space, evicts peers the "
                             "--mesh-obs shard oracle confirms dead, "
                             "re-stripes over the survivors and keeps "
                             "mining (rank and world from --process-id/"
                             "--num-processes or MPIBT_MESH_RANK/"
                             "MPIBT_MESH_WORLD); with --miners N on the "
                             "cuda backend the searches run under the "
                             "MPIBT_COLLECTIVE_TIMEOUT watchdog and the "
                             "logical miners shrink on suspicion; not "
                             "with --coordinator or --fused")
    p_mine.add_argument("--events-dump", metavar="PATH", default=None,
                        help="with --elastic: write this rank's Lamport-"
                             "stamped causal log (mined blocks and "
                             "membership changes) to PATH on exit, the "
                             "same bytes for same-seed mesh.rank_death "
                             "runs")
    p_mine.set_defaults(fn=cmd_mine)

    p_verify = sub.add_parser("verify", help="validate a saved chain file")
    p_verify.add_argument("--chain", required=True)
    p_verify.add_argument("--difficulty", type=int, required=True)
    p_verify.set_defaults(fn=cmd_verify)

    p_bench = sub.add_parser(
        "bench", help="sweep rate (--mode sweep) or a whole chain's wall "
                      "(--mode chain)")
    p_bench.add_argument("--mode", choices=["sweep", "chain"],
                         default="sweep",
                         help="sweep: the raw rate for --seconds; chain: "
                              "mine --blocks at --difficulty with the fused "
                              "miner (--backend/--seconds ignored)")
    p_bench.add_argument("--backend", choices=BACKENDS, default="cuda")
    p_bench.add_argument("--seconds", type=float, default=5.0)
    # Sweep default 28: one launch amortizes its overhead only at large
    # batches. Chain default 24: the early-exit sweet spot at difficulty
    # 24. "auto" (chain mode) sizes the batch to the difficulty.
    p_bench.add_argument("--batch-pow2", type=_batch_pow2_arg, default=None)
    p_bench.add_argument("--miners", type=int, default=1)
    p_bench.add_argument("--kernel", choices=KERNELS, default="auto")
    p_bench.add_argument("--blocks", type=int, default=1000,
                         help="chain mode: blocks to mine")
    p_bench.add_argument("--difficulty", type=int, default=24,
                         help="chain mode: leading-zero bits")
    p_bench.add_argument("--blocks-per-call", type=int, default=100)
    p_bench.add_argument("--device", choices=DEVICES, default="cuda",
                         help="torch device; the CPU only when asked for")
    _add_metrics_dump_arg(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    p_sim = sub.add_parser(
        "sim", help="adversarial simulation: the config-5 partition+reorg "
                    "bus on the card, or the vectorized scenario engine "
                    "on the host (--preset adversarial-1k / --nodes N)")
    p_sim.add_argument("--preset",
                       choices=sorted(PRESETS) + sorted(
                           SCENARIO_PRESET_NAMES),
                       help="a named mining config (the real-chain bus; "
                            "overrides the other flags except --device) "
                            "or a scenario preset (the vectorized engine)")
    p_sim.add_argument("--difficulty", type=int, default=None,
                       help="leading-zero bits (default: sim-internal 8)")
    p_sim.add_argument("--blocks", type=int, default=8,
                       help="target height every node must converge to")
    p_sim.add_argument("--backend", choices=BACKENDS, default="cuda",
                       help="search backend of every group: cuda (the card "
                            "unless --device cpu) or cpu (the C++ sweep); "
                            "default cuda, where the reference's sim "
                            "defaults to its cpu backend: entry points of "
                            "the port run on the card unless asked")
    p_sim.add_argument("--kernel", choices=KERNELS, default="auto",
                       help="sweep kernel of the cuda backend")
    p_sim.add_argument("--device", choices=DEVICES, default="cuda",
                       help="torch device of the cuda backend; the CPU "
                            "only when asked for")
    p_sim.add_argument("--batch-pow2", type=_batch_pow2_arg, default=12)
    p_sim.add_argument("--partition-steps", type=int, default=30,
                       help="steps the groups stay partitioned")
    p_sim.add_argument("--nonce-budget-pow2", type=int, default=8,
                       help="log2 nonces each group tries per sim step")
    p_sim.add_argument("--delay-steps", type=int, default=1,
                       help="delivery delay in sim steps")
    p_sim.add_argument("--drop-rate", type=int, default=None,
                       help="%% of deliveries dropped (seeded, "
                            "deterministic; default 0)")
    p_sim.add_argument("--seed", type=int, default=None,
                       help="seed for the drop/scenario schedules "
                            "(default 0; overrides a scenario preset's "
                            "baked-in seed when given, 0 included)")
    p_sim.add_argument("--groups", type=int, default=2,
                       help="number of competing miner groups")
    p_sim.add_argument("--retarget", metavar="INT[:STEP[:MAX]]",
                       default=None,
                       help="height-scheduled difficulty retargeting: "
                            "+STEP bits every INT blocks, capped at MAX "
                            "(validated on sync adoption, both engines)")
    p_sim.add_argument("--nodes", type=int, default=None,
                       help="vectorized engine: network size (switches "
                            "sim to the batched scenario engine)")
    p_sim.add_argument("--steps", type=int, default=None,
                       help="vectorized engine: scenario horizon in "
                            "steps (default 1000)")
    p_sim.add_argument("--strategy", action="append", metavar="SPEC",
                       help="vectorized engine: adversary strategy, "
                            "repeatable — selfish:node=1,hashrate=8 | "
                            "eclipse:node=2,victim=5,start=50,until=120 "
                            "| flood:node=3,every=25")
    p_sim.add_argument("--churn", type=int, default=None, metavar="N",
                       help="vectorized engine: N seeded crash-restart "
                            "churn events across the horizon")
    p_sim.add_argument("--latency", default=None, metavar="N|LO-HI",
                       help="vectorized engine: delivery delay steps, "
                            "fixed (N, default 1) or seeded uniform "
                            "(LO-HI)")
    p_sim.add_argument("--hashes-per-step", type=int, default=None,
                       help="vectorized engine: per-node hashes/step in "
                            "the mining lottery (default 32)")
    p_sim.add_argument("--converge-margin", type=int, default=None,
                       help="vectorized engine: fault-free "
                            "reconciliation steps granted past the "
                            "horizon (default 1000)")
    p_sim.add_argument("--events-dump", metavar="PATH", default=None,
                       help="write every node's Lamport-stamped causal "
                            "event log to PATH on exit")
    _add_fault_plan_arg(p_sim)
    _add_metrics_dump_arg(p_sim)
    p_sim.set_defaults(fn=cmd_sim)

    p_serve = sub.add_parser(
        "serve", help="mine while serving the blockserve HTTP front door "
                      "(submit/tx_status/chain/template)")
    _add_config_args(p_serve)
    p_serve.add_argument("--port", type=int, default=0,
                         help="door port (0 = ephemeral, announced on "
                              "stderr)")
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--deadline", type=float, default=None,
                         metavar="SECONDS",
                         help="per-request deadline (default "
                              "MPIBT_SERVICE_DEADLINE, 5s): expired work "
                              "is dropped before it reaches the miner")
    p_serve.add_argument("--mempool-cap", type=int, default=None,
                         metavar="N",
                         help="bounded mempool capacity (default "
                              "MPIBT_MEMPOOL_CAP, 512)")
    p_serve.add_argument("--template-txs", type=int, default=None,
                         metavar="N",
                         help="max txs folded into one block template "
                              "(default MPIBT_TEMPLATE_TXS, 16)")
    _add_metrics_dump_arg(p_serve)
    p_serve.set_defaults(fn=cmd_serve)

    p_info = sub.add_parser("info", help="torch, CUDA and card facts")
    p_info.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    fr_path = (getattr(args, "flight_recorder", None)
               or os.environ.get("MPIBT_FLIGHT_RECORDER"))
    if fr_path:
        from .telemetry import flight_recorder
        flight_recorder.install(fr_path)
        flight_recorder.register_context(command=args.command)
    fault_arg = getattr(args, "fault_plan", None)
    if fault_arg is None and hasattr(args, "fault_plan"):
        # The environment arms only the subcommand that takes the flag.
        fault_arg = os.environ.get("MPIBT_FAULT_PLAN") or None
    plan_armed = False
    metrics_port = getattr(args, "serve_metrics", None)
    if metrics_port is None and hasattr(args, "serve_metrics"):
        # The environment arms only the subcommands that take the flag.
        from .telemetry.events import env_number
        metrics_port = env_number("MPIBT_METRICS_PORT", None, cast=int,
                                  minimum=0)
    metrics_server = None
    if metrics_port is not None:
        from .perfwatch.server import MetricsServer
        metrics_server = MetricsServer(port=metrics_port)
        try:
            port = metrics_server.start()
        except (OSError, OverflowError) as e:
            # A taken (or out-of-range) port must not kill the run it was
            # meant to observe.
            print(f"serve-metrics failed: {e}", file=sys.stderr)
            metrics_server = None
        else:
            print(f"serving metrics on http://127.0.0.1:{port} "
                  f"(/metrics /healthz /events)", file=sys.stderr,
                  flush=True)
    mesh_obs = getattr(args, "mesh_obs", None)
    if mesh_obs is None and hasattr(args, "mesh_obs"):
        # The environment arms only the subcommands that take the flag.
        mesh_obs = os.environ.get("MPIBT_MESH_OBS") or None
    shard_armed = False
    # The exit status the final shard carries: every handled path below
    # sets it; an unhandled exception leaves "error", so a crashed rank
    # never reads as cleanly finished in the mesh view.
    exit_status: int | str = "error"
    if mesh_obs:
        from .meshwatch import shard as mesh_shard

        rank, world = _mesh_identity(args)
        try:
            mesh_shard.install(mesh_obs, rank=rank, world_size=world)
        except OSError as e:
            # An unwritable shard directory must not kill the run it
            # observes.
            print(f"mesh-obs failed: {e}", file=sys.stderr)
        else:
            shard_armed = True
            print(f"mesh-obs: rank {rank}/{world} shard -> {mesh_obs}",
                  file=sys.stderr, flush=True)
    incident_dir = getattr(args, "incident_dir", None)
    if incident_dir is None and hasattr(args, "incident_dir"):
        # The environment arms only the subcommands that take the flag.
        incident_dir = os.environ.get("MPIBT_INCIDENT_DIR") or None
    chainwatch_armed = False
    if incident_dir or shard_armed:
        # The live watchdog: its rules ride the per-block observation and
        # the shard flush tick; a firing rule writes its evidence bundle
        # into the directory, and without one still signals (event,
        # counter, the shard's open incidents).
        from . import chainwatch
        chainwatch.install(incident_dir or None)
        chainwatch_armed = True
        if incident_dir:
            print(f"chainwatch: armed, incident bundles -> {incident_dir}",
                  file=sys.stderr, flush=True)
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
        exit_status = rc
        return rc
    except FaultPlanError as e:
        # Before ConfigError, which it subclasses: "bad or unexhausted
        # fault plan" (3) is told apart from a bad config (2).
        print(json.dumps({"event": "error", "kind": "fault_plan",
                          "error": str(e)}, sort_keys=True))
        exit_status = 3
        return 3
    except RetryExhausted as e:
        # Every attempt on every rung failed: a clean failure, not a
        # traceback.
        print(json.dumps({"event": "error", "kind": "retry_exhausted",
                          "site": e.site, "error": str(e)},
                         sort_keys=True))
        exit_status = 2
        return 2
    except KernelError as e:
        # A kernel that failed to build or launch: never retried, never
        # stepped over.
        print(json.dumps({"event": "error", "kind": "kernel",
                          "error": str(e)}, sort_keys=True))
        exit_status = 2
        return 2
    except ConfigError as e:
        # Config errors (no card, bad kernel/device pair, an invalid
        # checkpoint, ...) surface as one clean JSON line; any other
        # exception keeps its traceback.
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        exit_status = 2
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
        # The final shard says goodbye and how it went: rc 0 reads as
        # `finished` in the mesh view, any other rc (or "error") as
        # `failed`. It is written here, before main returns: a process
        # that joined a world then leaves through os._exit
        # (parallel.distributed.exit_process).
        if shard_armed:
            from .meshwatch import shard as mesh_shard
            mesh_shard.uninstall(status=exit_status)
        # After the final shard, which still carries any open incidents.
        if chainwatch_armed:
            from . import chainwatch
            chainwatch.uninstall()
        # The endpoint releases its port on every exit path.
        if metrics_server is not None:
            metrics_server.close()


if __name__ == "__main__":
    sys.exit(main())
