"""CLI: python -m mpi_blockchain_tpu_torch.meshwatch
        {merge,report,watch,smoke,bubble,pipeline-smoke,skew-smoke}

The port's copy of the reference's meshwatch CLI.

    # one mesh-wide view of a shard directory (counters summed,
    # gauges/histograms per-rank), with rank liveness
    python -m mpi_blockchain_tpu_torch.meshwatch merge --dir /tmp/mesh

    # dispatch pipeline report (+ wall-clock Perfetto trace) from the
    # shards' profiler records
    python -m mpi_blockchain_tpu_torch.meshwatch report --dir /tmp/mesh \\
        --trace pipeline_trace.json

    # serve the mesh-aware /healthz /metrics /ranks /incidents until
    # interrupted
    python -m mpi_blockchain_tpu_torch.meshwatch watch --dir /tmp/mesh

``smoke`` launches a 4-rank ``--mesh-obs`` world of ``mine`` processes,
SIGKILLs one rank mid-run, then proves every rank mined on the device's
rung with no retry or step-down, the merged view sums the per-rank
counters, names exactly the killed rank as stale, has every rank's
heartbeat, and renders a non-empty pipeline report and trace. Its ranks
mine on the card unless ``--device cpu`` asks for the C++ sweep. The
victim must still be sweeping when the kill lands, so its chain is sized
by the device (``VICTIM``): the reference's d20 on the C++ sweep, d28 on
the card, where a d20 block takes well under a millisecond and a d28 one
tens of milliseconds.

``pipeline-smoke``: the fixed-seed instrumented mine's pipelined
``bubble_fraction`` stays inside the SECTION_BOUNDS budget (<= 0.15), the
pipelined chain is byte-identical to the sequential oracle, and ``device``
dominates every block's critical path; ``bubble`` prints the raw
measurement payload. Both run the reference's audit on the C++ sweep
(``bubble.py`` says why).

``skew-smoke``: two same-seed 4-rank ``--elastic`` worlds must join the
same (site, round, rank) skew shape (the structural half of the report is
deterministic; the millisecond values are weather), and the report's
``max_skew_ms`` must pass the ``collective_skew`` absolute budget through
the perfwatch detector. Its ranks mine on the card unless ``--device
cpu``, each held to its rung with no retry or step-down.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..config import ConfigError
from .aggregate import merge_shards, mesh_health, read_shards, \
    render_mesh_prometheus
from .pipeline import pipeline_report, to_chrome_trace
from .world import DEVICES

#: The smoke's world: ranks, the one killed, the survivors' chain
#: (difficulty, blocks) and the victim's, by device.
SMOKE_WORLD, SMOKE_VICTIM = 4, 2
SURVIVOR_CHAIN = (10, 20)
VICTIM = {"cpu": (20, 4000), "cuda": (28, 4000)}


def _shard_pipeline_records(shards: list[dict]) -> list[dict]:
    """Every shard's profiler-record tail, concatenated (records carry
    their rank, so cross-rank analysis needs no extra bookkeeping)."""
    records: list[dict] = []
    for shard in shards:
        records.extend(shard.get("pipeline") or [])
    return records


def cmd_merge(args) -> int:
    shards = read_shards(args.dir)
    code, health = mesh_health(args.dir, stall_s=args.stall_s,
                               shards=shards)
    view = merge_shards(shards)
    if args.prometheus:
        sys.stdout.write(render_mesh_prometheus(view, health))
    else:
        print(json.dumps({"event": "meshwatch_merge",
                          "dir": str(args.dir),
                          "health": health, "view": view},
                         sort_keys=True, default=str))
    if args.check and code != 200:
        return 1
    return 0


def cmd_report(args) -> int:
    if args.dir:
        records = _shard_pipeline_records(read_shards(args.dir))
    else:
        from .pipeline import profiler
        records = profiler().records()
    report = pipeline_report(records)
    out = {"event": "meshwatch_report",
           "source": str(args.dir) if args.dir else "in-process",
           "pipeline": report}
    if args.trace:
        trace = to_chrome_trace(records)
        pathlib.Path(args.trace).write_text(
            json.dumps(trace, sort_keys=True))
        out["trace"] = {"path": str(args.trace),
                        "events": len(trace["traceEvents"])}
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_watch(args) -> int:
    if args.once:
        code, payload = mesh_health(args.dir, stall_s=args.stall_s)
        print(json.dumps(payload, sort_keys=True))
        return 0 if code == 200 else 1
    from .server import MeshServer

    srv = MeshServer(args.dir, port=args.port, host=args.host,
                     stall_s=args.stall_s)
    port = srv.start()
    print(json.dumps({"event": "meshwatch_watch", "dir": str(args.dir),
                      "host": args.host, "port": port,
                      "endpoints": ["/healthz", "/incidents", "/metrics",
                                    "/ranks"]}),
          flush=True)
    try:
        import threading
        threading.Event().wait()            # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


# ---- smoke ----------------------------------------------------------------


def cmd_smoke(args) -> int:
    """The 4-rank world, one SIGKILLed."""
    import signal
    import tempfile
    import time

    from .shard import shard_path
    from .world import check_device, reap, rung_fault, spawn_rank

    check_device(args.device)
    world, victim = SMOKE_WORLD, SMOKE_VICTIM

    def chain(difficulty, blocks):
        return ["--difficulty", str(difficulty), "--blocks", str(blocks)]

    with tempfile.TemporaryDirectory() as tmp:
        obs = str(pathlib.Path(tmp) / "mesh")
        survivors = {r: spawn_rank(r, world, obs, chain(*SURVIVOR_CHAIN),
                                   args.device)
                     for r in range(world) if r != victim}
        # The victim mines a long chain so it is still sweeping when the
        # signal lands — a real mid-run death, not a post-exit one.
        victim_proc = spawn_rank(victim, world, obs,
                                 chain(*VICTIM[args.device]), args.device)
        try:
            deadline = time.monotonic() + 120
            vpath = shard_path(obs, victim)
            while time.monotonic() < deadline:
                shards = {s["rank"]: s for s in read_shards(obs)}
                beats = shards.get(victim, {}).get("heartbeats", {})
                # Kill only once the victim's shard PROVES it was mining
                # (a heartbeat in flight) — the mid-run death the stale
                # detection exists for, not a pre-start one.
                if vpath.exists() and any("miner_heartbeat" in k
                                          for k in beats):
                    break
                if victim_proc.poll() is not None:
                    print(f"meshwatch-smoke: victim exited rc="
                          f"{victim_proc.returncode} before the kill",
                          file=sys.stderr)
                    return 1
                time.sleep(0.1)
            else:
                print("meshwatch-smoke: victim never heartbeat",
                      file=sys.stderr)
                return 1
            victim_proc.send_signal(signal.SIGKILL)
            victim_proc.wait(timeout=30)
            outs: dict[int, str | None] = {victim: None}
            for r, p in survivors.items():
                outs[r], err = p.communicate(timeout=180)
                if p.returncode != 0:
                    print(f"meshwatch-smoke: survivor rank failed "
                          f"rc={p.returncode}: {err[-800:]}",
                          file=sys.stderr)
                    return 1
        finally:
            reap([*survivors.values(), victim_proc])
        time.sleep(0.6)    # let the victim's shard age past the budget
        shards = read_shards(obs)
        view = merge_shards(shards)
        code, health = mesh_health(obs, stall_s=0.5, shards=shards)

        # 0. every rank, the victim too, mined on the device's rung with
        #    no retry and no step-down.
        for shard in shards:
            fault = rung_fault(shard["rank"], args.device, shard,
                               outs[shard["rank"]])
            if fault:
                print(f"meshwatch-smoke: {fault}", file=sys.stderr)
                return 1

        # 1. counters sum: merged hashes_tried_total == sum of per-rank.
        hashed = [v for k, v in view["counters"].items()
                  if v["name"] == "hashes_tried_total"]
        if not hashed or any(
                v["total"] != sum(v["by_rank"].values()) for v in hashed):
            print(f"meshwatch-smoke: counter sum broken: {hashed}",
                  file=sys.stderr)
            return 1
        rank_set = {r for v in hashed for r in v["by_rank"]}
        if not {"0", "1", "3"} <= rank_set:
            print(f"meshwatch-smoke: survivor counters missing: "
                  f"{sorted(rank_set)}", file=sys.stderr)
            return 1

        # 2. the killed rank — and ONLY it — reads stale; survivors
        #    finished (final shards are not stale).
        if code != 503 or health["stale_ranks"] != [victim]:
            print(f"meshwatch-smoke: expected stale rank [{victim}], "
                  f"got {health['stale_ranks']} (code {code})",
                  file=sys.stderr)
            return 1
        finished = [r for r, v in health["ranks"].items()
                    if v["status"] == "finished"]
        if sorted(int(r) for r in finished) != [0, 1, 3]:
            print(f"meshwatch-smoke: survivors not finished: {finished}",
                  file=sys.stderr)
            return 1

        # 3. per-rank heartbeats individually visible in the merged view.
        beats = {r for r, b in view["heartbeats"].items()
                 if any("miner_heartbeat" in k for k in b)}
        if not {"0", "1", "2", "3"} <= beats:
            print(f"meshwatch-smoke: heartbeats missing: {sorted(beats)}",
                  file=sys.stderr)
            return 1

        # 4. the pipeline report renders with real dispatch segments.
        records = _shard_pipeline_records(shards)
        report = pipeline_report(records)
        if not report["dispatch_count"] or report["bubble_fraction"] is None:
            print(f"meshwatch-smoke: empty pipeline report: {report}",
                  file=sys.stderr)
            return 1
        trace = to_chrome_trace(records)
        pids = {e["pid"] for e in trace["traceEvents"]
                if e["ph"] in ("X", "b")}
        if len(pids) < 2:
            print(f"meshwatch-smoke: trace rows missing: {sorted(pids)}",
                  file=sys.stderr)
            return 1

    print(json.dumps({
        "event": "meshwatch_smoke", "ok": True,
        "ranks": sorted(int(r) for r in rank_set),
        "stale_ranks": health["stale_ranks"],
        "hashes_total": sum(v["total"] for v in hashed),
        "pipeline_dispatches": report["dispatch_count"],
        "bubble_fraction": report["bubble_fraction"],
    }, sort_keys=True))
    return 0


def cmd_bubble(args) -> int:
    """Measure the pipeline_bubble bench payload (before/after
    bubble_fraction of the fixed-seed instrumented mine) and print it."""
    import logging

    from .bubble import measure_pipeline_bubble

    # The audit mines through the real checkpoint seam: its
    # block_mined/checkpoint_saved log lines are noise on a
    # measurement's stdout.
    logging.getLogger("mpi_blockchain_tpu_torch").setLevel(logging.WARNING)
    payload = measure_pipeline_bubble()
    print(json.dumps({"event": "pipeline_bubble", **payload},
                     sort_keys=True))
    return 0


def cmd_pipeline_smoke(args) -> int:
    """The pipeline-smoke gate:

    1. the fixed-seed instrumented mine's PIPELINED ``bubble_fraction``
       passes the SECTION_BOUNDS absolute budget (<= 0.15), judged
       through the perfwatch detector like every bounded section
       (best-of-<=3: a real regression cannot produce a clean read, a
       scheduler-weather spike cannot produce three dirty ones);
    2. the pipelined chain is byte-identical to the sequential oracle's
       (``chain_identical`` — the determinism half of the acceptance);
    3. ``device`` is the dominant per-block critical-path stage on
       every mined block of the pipelined leg (the blocktrace form:
       host work hides behind the in-flight dispatch).
    """
    import logging

    from ..perfwatch.detector import check_candidate
    from ..perfwatch.history import DEFAULT_HISTORY_NAME, HistoryStore
    from .bubble import measure_pipeline_bubble

    logging.getLogger("mpi_blockchain_tpu_torch").setLevel(logging.WARNING)
    repo_root = pathlib.Path(__file__).resolve().parent.parent.parent
    store = HistoryStore(repo_root / DEFAULT_HISTORY_NAME)
    for attempt in range(3):
        payload = measure_pipeline_bubble()
        finding = check_candidate(store, "pipeline_bubble", payload)
        if not payload["chain_identical"]:
            # Determinism is not weather: one broken chain fails the
            # gate outright, no retry.
            print(f"pipeline-smoke: pipelined chain diverged from the "
                  f"sequential oracle: {payload}", file=sys.stderr)
            return 1
        ok = (finding.verdict != "regression"
              and payload["device_dominant_blocks"] == payload["blocks"])
        if ok:
            break
        print(f"pipeline-smoke: read {attempt + 1} dirty "
              f"(bubble {payload['bubble_fraction']}, device-dominant "
              f"{payload['device_dominant_blocks']}/{payload['blocks']})",
              file=sys.stderr)
    if finding.verdict == "regression":
        print(f"pipeline-smoke: bubble over budget: {finding.render()}",
              file=sys.stderr)
        return 1
    if payload["device_dominant_blocks"] != payload["blocks"]:
        print(f"pipeline-smoke: device not dominant on every block "
              f"({payload['device_dominant_blocks']}/"
              f"{payload['blocks']})", file=sys.stderr)
        return 1
    print(json.dumps({
        "event": "pipeline_smoke", "ok": True,
        "bubble_fraction": payload["bubble_fraction"],
        "bubble_fraction_sequential":
            payload["bubble_fraction_sequential"],
        "host_overlapped_fraction": payload["host_overlapped_fraction"],
        "device_dominant_blocks": payload["device_dominant_blocks"],
        "blocks": payload["blocks"],
        "verdict": finding.verdict,
    }, sort_keys=True))
    return 0


#: The skew smoke's world: ranks, blocks and difficulty (the reference's).
SKEW_WORLD, SKEW_BLOCKS, SKEW_DIFFICULTY = 4, 8, 8


def _skew_world(device: str) -> list[dict]:
    """One same-seed ``--elastic`` world: every rank steps the same
    heights in lockstep (the ``block.step`` skew spans), mines its stripe
    on ``device``'s rung with no retry or step-down, writes its shard and
    exits 0. Returns the final shards."""
    import tempfile

    from .world import reap, rung_fault, spawn_rank

    with tempfile.TemporaryDirectory() as tmp:
        obs = str(pathlib.Path(tmp) / "mesh")
        procs = [spawn_rank(r, SKEW_WORLD, obs,
                            ["--elastic", "--difficulty",
                             str(SKEW_DIFFICULTY), "--blocks",
                             str(SKEW_BLOCKS)], device)
                 for r in range(SKEW_WORLD)]
        try:
            outs = []
            for p in procs:
                out, err = p.communicate(timeout=180)
                if p.returncode != 0:
                    raise RuntimeError(
                        f"skew-smoke rank failed rc={p.returncode}: "
                        f"{err[-800:]}")
                outs.append(out)
        finally:
            reap(procs)
        shards = read_shards(obs)
        for shard in shards:
            fault = rung_fault(shard["rank"], device, shard,
                               outs[shard["rank"]])
            if fault:
                raise RuntimeError(f"skew-smoke: {fault}")
        return shards


def cmd_skew_smoke(args) -> int:
    """The skew-smoke gate (meshprof):

    1. **determinism**: two same-seed 4-rank elastic worlds give mesh-skew
       reports of the same structural shape (world, per-site rounds x
       ranks; the millisecond values are weather and left out), and
       re-analyzing one shard set twice gives the same report
       (``analyze_skew`` is a pure function). A determinism failure fails
       outright, never retried;
    2. **bound**: the report's ``max_skew_ms`` passes the
       ``collective_skew`` SECTION_BOUNDS budget through the perfwatch
       detector, best of at most 3 (clock offsets are normalized out, so
       a failure means a rank stalled seconds inside the lockstep step).
    """
    from ..meshprof.analyzer import analyze_skew, skew_shape
    from ..perfwatch.detector import check_candidate
    from ..perfwatch.history import DEFAULT_HISTORY_NAME, HistoryStore
    from .world import RUNG, check_device

    check_device(args.device)
    world, blocks = SKEW_WORLD, SKEW_BLOCKS
    repo_root = pathlib.Path(__file__).resolve().parent.parent.parent
    store = HistoryStore(repo_root / DEFAULT_HISTORY_NAME)
    try:
        shard_runs = [_skew_world(args.device) for _ in range(2)]
    except RuntimeError as e:
        print(f"skew-smoke: {e}", file=sys.stderr)
        return 1
    reports = [analyze_skew(s) for s in shard_runs]

    # 1a. pure re-analysis: same shards, the same report.
    if json.dumps(analyze_skew(shard_runs[0]), sort_keys=True) != \
            json.dumps(reports[0], sort_keys=True):
        print("skew-smoke: analyze_skew is not deterministic over the "
              "same shards", file=sys.stderr)
        return 1
    # 1b. cross-run structural determinism.
    shapes = [json.dumps(skew_shape(r), sort_keys=True) for r in reports]
    if shapes[0] != shapes[1]:
        print(f"skew-smoke: same-seed runs joined different shapes:\n"
              f"  {shapes[0]}\n  {shapes[1]}", file=sys.stderr)
        return 1
    step = reports[0]["sites"].get("block.step")
    if (step is None or step["ranks"] != list(range(world))
            or step["rounds"] < blocks or reports[0]["straggler_rank"] < 0):
        print(f"skew-smoke: block.step did not join all {world} ranks "
              f"x {blocks} rounds: {skew_shape(reports[0])}",
              file=sys.stderr)
        return 1

    # 2. bound gate, best of at most 3 (the first two runs count as reads).
    report = None
    for attempt, rep in enumerate(reports + [None]):
        if rep is None:
            try:
                rep = analyze_skew(_skew_world(args.device))
            except RuntimeError as e:
                print(f"skew-smoke: {e}", file=sys.stderr)
                return 1
        report = rep
        payload = {"max_skew_ms": rep["max_skew_ms"],
                   "straggler_rank": rep["straggler_rank"],
                   "backend": RUNG[args.device].split(":")[0],
                   "mesh": f"elastic{world}", "n_blocks": blocks,
                   "world": world}
        finding = check_candidate(store, "collective_skew", payload)
        if finding.verdict != "regression":
            break
        print(f"skew-smoke: read {attempt + 1} dirty "
              f"(max_skew_ms {rep['max_skew_ms']})", file=sys.stderr)
    if finding.verdict == "regression":
        print(f"skew-smoke: skew over budget: {finding.render()}",
              file=sys.stderr)
        return 1
    step = report["sites"]["block.step"]
    print(json.dumps({
        "event": "skew_smoke", "ok": True,
        "world": world, "blocks": blocks,
        "site": "block.step",
        "rounds": step["rounds"],
        "straggler_rank": step["straggler_rank"],
        "straggler_lag_ms": step["straggler_lag_ms"],
        "max_skew_ms": report["max_skew_ms"],
        "idle_chip_ms": step["idle_chip_ms"],
        "verdict": finding.verdict,
    }, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.meshwatch",
        description="per-rank telemetry shards, mesh aggregation, and "
                    "the dispatch pipeline profiler")
    sub = parser.add_subparsers(dest="command", required=True)

    p_mrg = sub.add_parser("merge", help="merge a shard directory into "
                                         "one mesh view + health")
    p_mrg.add_argument("--dir", required=True, metavar="DIR",
                       help="the --mesh-obs shard directory")
    p_mrg.add_argument("--stall-s", type=float, default=None,
                       help="rank staleness budget (default "
                            "MPIBT_MESH_STALL or 10)")
    p_mrg.add_argument("--prometheus", action="store_true",
                       help="emit the merged Prometheus text instead of "
                            "JSON")
    p_mrg.add_argument("--check", action="store_true",
                       help="exit 1 when any rank is stale/missing")
    p_mrg.set_defaults(fn=cmd_merge)

    p_rep = sub.add_parser("report", help="dispatch pipeline report "
                                          "(overlap/bubble) + Perfetto "
                                          "trace")
    p_rep.add_argument("--dir", default=None, metavar="DIR",
                       help="shard directory (default: the in-process "
                            "profiler)")
    p_rep.add_argument("--trace", default=None, metavar="PATH",
                       help="also write a wall-clock Chrome trace "
                            "(one track per rank and stage; view at "
                            "ui.perfetto.dev)")
    p_rep.set_defaults(fn=cmd_report)

    p_wch = sub.add_parser("watch", help="serve the mesh-aware /healthz "
                                         "/metrics /ranks /incidents")
    p_wch.add_argument("--dir", required=True, metavar="DIR")
    p_wch.add_argument("--port", type=int, default=0,
                       help="0 = ephemeral (announced on stdout)")
    p_wch.add_argument("--host", default="127.0.0.1")
    p_wch.add_argument("--stall-s", type=float, default=None)
    p_wch.add_argument("--once", action="store_true",
                       help="print the health JSON once and exit 0/1")
    p_wch.set_defaults(fn=cmd_watch)

    p_smk = sub.add_parser("smoke", help="a 4-rank world, one rank "
                                         "SIGKILLed: exactly it reads "
                                         "stale")
    p_smk.add_argument("--device", choices=DEVICES, default="cuda",
                       help="where the ranks mine: the CUDA sweep on the "
                            "card, or the C++ sweep; the CPU only when "
                            "asked for")
    p_smk.set_defaults(fn=cmd_smoke)

    p_bub = sub.add_parser("bubble", help="measure the pipeline_bubble "
                                          "bench payload (before/after "
                                          "bubble_fraction of the fixed-"
                                          "seed instrumented mine)")
    p_bub.set_defaults(fn=cmd_bubble)

    p_psm = sub.add_parser("pipeline-smoke",
                           help="the bubble budget, the oracle-identical "
                                "chain and device-dominant blocks, on the "
                                "C++ sweep")
    p_psm.set_defaults(fn=cmd_pipeline_smoke)

    p_ssm = sub.add_parser("skew-smoke",
                           help="deterministic 4-rank --elastic mesh-skew "
                                "join + the collective_skew absolute "
                                "budget")
    p_ssm.add_argument("--device", choices=DEVICES, default="cuda",
                       help="where the ranks mine: the CUDA sweep on the "
                            "card, or the C++ sweep; the CPU only when "
                            "asked for")
    p_ssm.set_defaults(fn=cmd_skew_smoke)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        sys.stderr.close()
        return 0
    except ConfigError as e:
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2


if __name__ == "__main__":
    sys.exit(main())
