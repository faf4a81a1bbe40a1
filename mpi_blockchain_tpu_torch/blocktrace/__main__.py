"""CLI: python -m mpi_blockchain_tpu_torch.blocktrace {smoke,overhead}

``smoke``, the port's copy of the reference's trace smoke: a 2-rank
``--mesh-obs`` world mines with tracing on, on the device's rung with no
retry or step-down, then the smoke proves

1. every mined height yields a COMPLETE critical path with gap_pct < 5
   (block headline and every per-rank waterfall);
2. the analyzer is deterministic: the same record set, in any order,
   gives a byte-identical report;
3. the Perfetto export round-trips through JSON with the critical-path
   slices and flow chain present;
4. the telemetry self-overhead audit passes its absolute budget (< 3%);
5. the per-block critical-path observation passes its own (< 300 us).

``overhead`` runs the telemetry self-overhead audit and prints its
payload, ``{"event": "trace_overhead", ...}`` (``--block-observe`` for
the per-block observation's, ``trace_block_observe``), and exits 1 when
``overhead_pct`` is over the reference's 3% bound. Both run on the card
unless ``--device cpu`` asks for the C++ sweep (the smoke's ranks mine
there too; its audits' round is a 2^24 sweep on the card).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

#: The smoke's world: (ranks, blocks, difficulty), the reference's.
SMOKE_WORLD = (2, 6, 12)
#: The overhead reads the smoke may take until one is inside the bound,
#: and the pause after a miss (the reference's trace smoke).
OVERHEAD_ATTEMPTS = ({}, {"seconds": 1.5, "reps": 5},
                     {"seconds": 1.5, "reps": 5}, {"seconds": 2.0, "reps": 5})
OVERHEAD_PAUSE_S = 5.0


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


def cmd_smoke(args) -> int:
    """The two-rank trace smoke."""
    import tempfile

    from ..meshwatch.aggregate import read_shards
    from ..meshwatch.world import check_device, reap, rung_fault, spawn_rank
    from ..perfwatch.detector import SECTION_BOUNDS
    from .critical_path import COMPLETE_GAP_PCT, critical_path_report
    from .export import CRITICAL_PID, to_critical_path_trace
    from .overhead import measure_block_observe, measure_trace_overhead

    check_device(args.device)
    world, blocks, difficulty = SMOKE_WORLD
    with tempfile.TemporaryDirectory() as tmp:
        obs = str(pathlib.Path(tmp) / "mesh")
        ranks = [spawn_rank(r, world, obs,
                            ["--difficulty", str(difficulty),
                             "--blocks", str(blocks)], args.device)
                 for r in range(world)]
        # Every exit path reaps every rank: a failed (or hung) rank
        # must not leave a sibling mining into the tmp dir while
        # TemporaryDirectory cleanup walks it, or burning CPU after
        # the gate already failed.
        outs = []
        try:
            for p in ranks:
                out, err = p.communicate(timeout=180)
                outs.append(out)
                if p.returncode != 0:
                    print(f"trace-smoke: rank failed rc={p.returncode}: "
                          f"{err[-800:]}", file=sys.stderr)
                    return 1
        finally:
            reap(ranks)
        shards = read_shards(obs)
        # 0. both ranks mined on the device's rung, no retry or step-down.
        for shard in shards:
            fault = rung_fault(shard["rank"], args.device, shard,
                               outs[shard["rank"]])
            if fault:
                print(f"trace-smoke: {fault}", file=sys.stderr)
                return 1
        records = [r for s in shards for r in s.get("pipeline") or []]
        report = critical_path_report(records)

        # 1. every mined height has a complete critical path, gap < 5%
        #    — block headline AND every rank's own waterfall.
        if report["heights"] != list(range(1, blocks + 1)):
            print(f"trace-smoke: heights missing: {report['heights']}",
                  file=sys.stderr)
            return 1
        for h in report["heights"]:
            b = report["blocks"][str(h)]
            if not b["complete"] or b["gap_pct"] >= COMPLETE_GAP_PCT:
                print(f"trace-smoke: block {h} incomplete: gap "
                      f"{b['gap_pct']}%, path {b['critical_path']}",
                      file=sys.stderr)
                return 1
            if set(b["ranks"]) != {"0", "1"}:
                print(f"trace-smoke: block {h} missing ranks: "
                      f"{sorted(b['ranks'])}", file=sys.stderr)
                return 1
            for rank, wf in b["ranks"].items():
                if wf["gap_pct"] >= COMPLETE_GAP_PCT:
                    print(f"trace-smoke: block {h} rank {rank} gap "
                          f"{wf['gap_pct']}%", file=sys.stderr)
                    return 1

        # 2. analyzer determinism: record order must not matter, and the
        #    same inputs must produce byte-identical JSON.
        again = json.dumps(critical_path_report(list(reversed(records))),
                           sort_keys=True)
        if json.dumps(report, sort_keys=True) != again:
            print("trace-smoke: report not deterministic across record "
                  "order", file=sys.stderr)
            return 1

        # 3. the Perfetto export loads and carries the highlighted flow.
        trace = json.loads(json.dumps(to_critical_path_trace(report,
                                                             records)))
        cp = [e for e in trace["traceEvents"]
              if e.get("pid") == CRITICAL_PID]
        slices = [e for e in cp if e["ph"] == "X"]
        flows = [e for e in cp if e["ph"] in ("s", "t", "f")]
        if not slices or ({e["ph"] for e in flows} - {"t"}) != {"s", "f"}:
            print(f"trace-smoke: critical-path trace rows broken "
                  f"({len(slices)} slices, {len(flows)} flow events)",
                  file=sys.stderr)
            return 1

    # 4. the observer-effect budget (< 3%), best of up to four reads,
    #    longer after a miss, with a pause before each retry: a real
    #    regression (a true cost over 3%) cannot read under the bound,
    #    while host weather right after the mining phase can read over
    #    it. The first clean read ends it.
    bound = SECTION_BOUNDS["trace_overhead"]
    for attempt, kwargs in enumerate(OVERHEAD_ATTEMPTS):
        if attempt:
            time.sleep(OVERHEAD_PAUSE_S)
        payload = measure_trace_overhead(device=args.device, **kwargs)
        if payload["overhead_pct"] <= bound:
            break
        print(f"trace-smoke: overhead read {attempt + 1} over budget "
              f"({payload['overhead_pct']}%)", file=sys.stderr)
    else:
        print(f"trace-smoke: telemetry overhead over the {bound}% "
              f"budget: {payload}", file=sys.stderr)
        return 1

    # 5. the per-block observation budget (best of up to three reads).
    observe_bound = SECTION_BOUNDS["trace_block_observe"]
    for attempt in range(3):
        obs_payload = measure_block_observe(device=args.device)
        if obs_payload["block_observe_us"] <= observe_bound:
            break
        print(f"trace-smoke: block-observe read {attempt + 1} over "
              f"budget ({obs_payload['block_observe_us']} us)",
              file=sys.stderr)
    else:
        print(f"trace-smoke: per-block observation over the "
              f"{observe_bound} us budget: {obs_payload}", file=sys.stderr)
        return 1

    print(json.dumps({
        "event": "trace_smoke", "ok": True,
        "heights": report["heights"],
        "max_gap_pct": max(report["blocks"][str(h)]["gap_pct"]
                           for h in report["heights"]),
        "trace_events": len(trace["traceEvents"]),
        "critical_slices": len(slices),
        "overhead_pct": payload["overhead_pct"],
        "block_observe_us": obs_payload["block_observe_us"],
    }, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    from ..config import ConfigError
    from ..meshwatch.world import DEVICES

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.blocktrace",
        description="per-block critical-path attribution: the two-rank "
                    "smoke and the telemetry self-overhead audit")
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
    p_ovh.add_argument("--device", choices=DEVICES, default="cuda",
                       help="the round's sweep: the CUDA kernel on the card "
                            "or the C++ sweep; the CPU only when asked for")
    p_ovh.set_defaults(fn=cmd_overhead)
    p_smk = sub.add_parser("smoke", help="two --mesh-obs ranks: complete "
                                         "critical paths, a deterministic "
                                         "report, the Perfetto flow and "
                                         "both overhead bounds")
    p_smk.add_argument("--device", choices=DEVICES, default="cuda",
                       help="where the ranks mine and the audits' round "
                            "runs: the card, or the C++ sweep; the CPU "
                            "only when asked for")
    p_smk.set_defaults(fn=cmd_smoke)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ConfigError as e:
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2


if __name__ == "__main__":
    sys.exit(main())
