"""CLI: python -m mpi_blockchain_tpu_torch.perfwatch
{record,check,report,critical-path,mesh-skew,incidents,compiles,serve,smoke}

The port's copy of the reference's perf sentinel, with its flags, JSON
keys, text lines and exit codes:

    # seed a history from the repo's bench round records (the reference's,
    # taken on a TPU), then record the card's own payloads beside them
    python -m mpi_blockchain_tpu_torch.perfwatch record \\
        --history /tmp/h.jsonl --seed-bench-rounds
    python -m mpi_blockchain_tpu_torch.perfwatch record \\
        --history /tmp/h.jsonl --section sweep --payload sweep.json

    # judge the newest entry of every series; exit 1 on a regression
    python -m mpi_blockchain_tpu_torch.perfwatch check --history /tmp/h.jsonl

    # judge a fresh payload WITHOUT recording it (measure -> gate -> record)
    python -m mpi_blockchain_tpu_torch.perfwatch check --section sweep \\
        --candidate sweep.json

    # trajectory + the card's roofline + pipeline and memory axes
    python -m mpi_blockchain_tpu_torch.perfwatch report

    # the mesh views over a --mesh-obs shard directory
    python -m mpi_blockchain_tpu_torch.perfwatch critical-path \\
        --mesh-dir /tmp/mesh --height 3 --json
    python -m mpi_blockchain_tpu_torch.perfwatch mesh-skew \\
        --mesh-dir /tmp/mesh --json
    python -m mpi_blockchain_tpu_torch.perfwatch incidents \\
        --mesh-dir /tmp/mesh --bundle-dir /tmp/incidents --json
    python -m mpi_blockchain_tpu_torch.perfwatch compiles \\
        --mesh-dir /tmp/mesh --json

    # standalone endpoint; serves until interrupted
    python -m mpi_blockchain_tpu_torch.perfwatch serve --port 0

Where the port differs from the reference, on purpose:

* ``record`` writes only to a history named by ``--history``; without it
  it exits 2. The repo's ``PERF_HISTORY.jsonl`` holds the reference's
  records, which the port reads (``check`` and ``report`` default to it)
  and never appends to.
* The ``roofline`` of ``check`` and ``report`` is the card's: the newest
  ``sweep`` entry that carries ``bound_ms`` (a card record of
  ``bench_lib.bench_cuda``), priced against that bound
  (``attribution.utilization``). With none, the key is left out.
* ``compiles``' probe is the card's cost probe
  (``dispatchwatch.__main__.cost_probe``), not XLA's cost analysis.
* ``smoke`` runs its instrumented run (``telemetry.__main__``) on the card
  unless ``--device cpu`` asks for the C++ sweep; with no card it exits 2.
  It scrapes ``/metrics`` and ``/healthz`` live, then holds the detector
  to an injected 20% drop (flags) and within-spread noise (does not).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..config import DEVICES
from .attribution import (attribute_pipeline, attribute_spans, memory_axis,
                          payload_utilization)
from .detector import (DEFAULT_SPREAD_K, DEFAULT_THRESHOLD_PCT,
                       check_candidate, check_history, regressions)
from .history import (DEFAULT_HISTORY_NAME, HistoryStore, SECTION_METRICS,
                      seed_from_bench_rounds)


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent.parent


def _store(args) -> HistoryStore:
    path = (pathlib.Path(args.history) if args.history
            else _repo_root() / DEFAULT_HISTORY_NAME)
    return HistoryStore(path)


def cmd_record(args) -> int:
    if not args.history:
        print(f"perfwatch record: --history PATH is required: the repo's "
              f"{DEFAULT_HISTORY_NAME} holds the reference package's "
              f"records, which the port reads and never appends to",
              file=sys.stderr)
        return 2
    store = _store(args)
    out: dict = {"event": "perfwatch_record", "history": str(store.path)}
    if args.seed_bench_rounds:
        out.update(seed_from_bench_rounds(store, args.root or _repo_root()))
    elif args.section and args.payload:
        try:
            payload = json.loads(pathlib.Path(args.payload).read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"perfwatch record: cannot read payload: {e}",
                  file=sys.stderr)
            return 2
        entry = store.record(args.section, payload, source=args.source)
        if entry is None:
            print(f"perfwatch record: section {args.section!r} unknown or "
                  f"payload lacks its metric "
                  f"{SECTION_METRICS.get(args.section, ('?',))[0]!r}",
                  file=sys.stderr)
            return 2
        out.update(recorded=1, key=entry.key)
    else:
        print("perfwatch record: need --seed-bench-rounds or "
              "--section + --payload", file=sys.stderr)
        return 2
    print(json.dumps(out, sort_keys=True))
    return 0


def current_roofline(store: HistoryStore) -> dict | None:
    """The card's roofline: ``utilization`` of the newest ``sweep`` entry
    that carries its bound (``bound_ms``, a card record), by
    ``recorded_at`` and then file order; None when no entry does."""
    priced = [(i, e) for i, e in enumerate(store.entries("sweep"))
              if payload_utilization(e.payload) is not None]
    if not priced:
        return None
    newest = max(priced, key=lambda t: (t[1].recorded_at, t[0]))[1]
    return payload_utilization(newest.payload)


def cmd_check(args) -> int:
    store = _store(args)
    if args.candidate:
        if not args.section:
            print("perfwatch check: --candidate needs --section",
                  file=sys.stderr)
            return 2
        try:
            payload = json.loads(pathlib.Path(args.candidate).read_text())
            findings = [check_candidate(store, args.section, payload,
                                        threshold_pct=args.threshold_pct,
                                        k=args.k)]
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(f"perfwatch check: {e}", file=sys.stderr)
            return 2
    else:
        findings = check_history(store, threshold_pct=args.threshold_pct,
                                 k=args.k)
    bad = regressions(findings)
    roofline = current_roofline(store)
    # Incident context: a regression verdict reads differently when the
    # run it judges fired chainwatch incidents. Context only, never the
    # gate.
    incidents = _mesh_open_incidents(args.mesh_dir) \
        if getattr(args, "mesh_dir", None) else None
    try:
        if args.as_json:
            doc = {"event": "perfwatch_check",
                   "history": str(store.path),
                   "regressions": len(bad),
                   "findings": [f.to_dict() for f in findings]}
            if roofline:
                doc["roofline"] = roofline
            if incidents is not None:
                doc["incidents"] = incidents
                doc["incident_count"] = len(incidents)
            print(json.dumps(doc, sort_keys=True))
        else:
            for f in findings:
                print(f.render())
            if roofline:
                print(f"perfwatch: newest card sweep "
                      f"{roofline['measured_mhs']:.1f} MH/s = "
                      f"{roofline['bound_utilization_pct']}% of its bound "
                      f"({roofline['bound_ms']:g} ms a call of "
                      f"{roofline['nonces_per_call']} nonces)",
                      file=sys.stderr)
            if incidents:
                for line in _render_incidents(incidents):
                    print(line, file=sys.stderr)
            if incidents is not None:
                print(f"perfwatch: {len(incidents)} open chainwatch "
                      f"incident(s) in the judged mesh", file=sys.stderr)
            print(f"perfwatch: {len(bad)} regression(s) across "
                  f"{len(findings)} series", file=sys.stderr)
    except BrokenPipeError:
        # `check | head` truncating the report is the reader's choice;
        # the gate's verdict below must survive it either way.
        sys.stderr.close()
    return 1 if bad else 0


def cmd_report(args) -> int:
    store = _store(args)
    series = {}
    for key, entries in sorted(store.by_key().items()):
        metric, direction = entries[0].metric
        vals = [e.value for e in entries]
        series[key] = {
            "metric": metric, "direction": direction,
            "count": len(entries),
            "latest": vals[-1], "latest_at": entries[-1].recorded_at,
            "best": (max(vals) if direction == "higher"
                     else min(vals) if direction == "lower" else None),
            "trajectory": [round(v, 3) for v in vals],
        }
    report = {"event": "perfwatch_report", "history": str(store.path),
              "series": series,
              "findings": [f.to_dict() for f in check_history(
                  store, threshold_pct=args.threshold_pct, k=args.k)]}
    roofline = current_roofline(store)
    if roofline:
        report["roofline"] = roofline
    # Dispatch pipeline overlap and bubble. The report CLI is its own
    # process, so the records of a finished run come from its --mesh-obs
    # shards; only a non-empty record set is reported (an empty row
    # would read as "no bubble").
    records = None
    shards = None
    if args.mesh_dir:
        from ..meshwatch.aggregate import read_shards
        shards = read_shards(args.mesh_dir)
        records = [r for s in shards for r in s.get("pipeline") or []]
    pipeline = attribute_pipeline(records)
    if pipeline["dispatch_count"]:
        report["pipeline"] = pipeline
    # The memory axis, only when some device reported (an empty axis
    # would read as "zero bytes used" instead of "no data").
    memory = memory_axis(shards)
    if memory["device_count"]:
        report["memory"] = memory
    print(json.dumps(report, sort_keys=True))
    return 0


def cmd_mesh_skew(args) -> int:
    """Mesh-wide rendezvous skew (meshprof): joins the skew spans of a
    --mesh-obs shard directory into per-(site, round) arrival deltas,
    names the per-site straggler rank, its lag and the implied idle
    time, and publishes the result to the live registry."""
    from ..meshprof.analyzer import analyze_skew, publish_skew
    from ..meshwatch.aggregate import read_shards

    shards = read_shards(args.mesh_dir)
    if not shards:
        print(f"mesh-skew: no shards under {args.mesh_dir}",
              file=sys.stderr)
        return 2
    report = analyze_skew(shards)
    publish_skew(report)
    if args.as_json:
        print(json.dumps({"event": "perfwatch_mesh_skew",
                          "source": str(args.mesh_dir), **report},
                         sort_keys=True))
    else:
        print(f"mesh-skew: {len(shards)} shard(s), "
              f"{report['site_count']} joined site(s), world "
              f"{report['world']}")
        for site, v in sorted(report["sites"].items()):
            d = v["skew_ms"]
            print(f"  {site}: {v['rounds']} round(s) x "
                  f"{len(v['ranks'])} rank(s)  skew ms "
                  f"mean={d['mean']:g} p50={d['p50']:g} "
                  f"p95={d['p95']:g} max={d['max']:g}")
            print(f"    straggler rank {v['straggler_rank']} "
                  f"(+{v['straggler_lag_ms']:g} ms mean lag), idle "
                  f"chip-time {v['idle_chip_ms']:g} ms")
            offsets = ", ".join(f"r{rk}={ms:+g}" for rk, ms in
                                sorted(v["clock_offset_ms"].items(),
                                       key=lambda t: int(t[0])))
            print(f"    clock offsets ms (normalized out): {offsets}")
        if report["site_count"]:
            print(f"mesh-skew: straggler rank "
                  f"{report['straggler_rank']}, max skew "
                  f"{report['max_skew_ms']:g} ms")
        else:
            print("mesh-skew: no joinable spans (need >= 2 ranks at "
                  "one (site, round))")
    return 0


def _mesh_open_incidents(mesh_dir) -> list[dict]:
    """Rank-stamped open chainwatch incidents from a --mesh-obs shard
    directory (the same merge the mesh server's ``/incidents`` serves)."""
    from ..meshwatch.aggregate import mesh_incidents, read_shards

    return mesh_incidents(read_shards(mesh_dir))


def _render_incidents(incidents: list[dict]) -> list[str]:
    lines = []
    for inc in incidents:
        heights = inc.get("heights") or []
        at = ("@" + ",".join(str(h) for h in heights)) if heights else ""
        lines.append(
            f"  [{inc.get('severity', '?'):>8}] rank "
            f"{inc.get('rank', '?')} {inc.get('rule', '?')}{at} "
            f"(seq {inc.get('incident_seq', '?')}, "
            f"source {inc.get('source', '')!r})")
    return lines


def cmd_incidents(args) -> int:
    """Open chainwatch incidents of a mesh (from --mesh-dir shards, or
    this process's open table), plus the evidence bundles under
    --bundle-dir. Exit 0 always: reporting, not gating."""
    if args.mesh_dir:
        incidents = _mesh_open_incidents(args.mesh_dir)
        source = str(args.mesh_dir)
    else:
        from ..chainwatch import open_incidents
        incidents = open_incidents()
        source = "in-process"
    bundles = []
    if args.bundle_dir:
        bundles = sorted(str(p.name) for p in
                         pathlib.Path(args.bundle_dir).glob(
                             "incident_*.json"))
    if args.as_json:
        print(json.dumps({"event": "perfwatch_incidents",
                          "source": source, "count": len(incidents),
                          "incidents": incidents, "bundles": bundles},
                         sort_keys=True))
    else:
        print(f"incidents: {len(incidents)} open ({source})")
        for line in _render_incidents(incidents):
            print(line)
        if args.bundle_dir:
            print(f"bundles: {len(bundles)} under {args.bundle_dir}")
            for name in bundles:
                print(f"  {name}")
    return 0


def cmd_compiles(args) -> int:
    """The compile census (dispatchwatch). Three views: this process's
    census, the mesh view off a --mesh-obs shard directory's ``compiles``
    carriage (per-rank totals and the divergence flag), and, unless
    --no-probe, the card's cost probe. Exit 0 always: reporting, not
    gating (``dispatchwatch smoke`` is the gate)."""
    from ..dispatchwatch import compile_census, recompiles

    census = compile_census()
    out: dict = {"event": "perfwatch_compiles",
                 "local": {"sites": census,
                           "recompiles": recompiles(census)}}
    if args.mesh_dir:
        from ..meshwatch.aggregate import mesh_compiles, read_shards
        out["mesh"] = mesh_compiles(read_shards(args.mesh_dir))
        out["source"] = str(args.mesh_dir)
    if not args.no_probe:
        from ..dispatchwatch.__main__ import probe_or_error
        out["cost"] = probe_or_error()
    if args.as_json:
        print(json.dumps(out, sort_keys=True))
        return 0
    if census:
        print("local compile census:")
        for site, st in census.items():
            print(f"  {site:>14}: {st['compiles']} compile(s), "
                  f"{st['compile_ms']:.1f} ms, cache "
                  f"{st['cache_entries']}")
        print(f"  recompiles past cache: {out['local']['recompiles']}")
    else:
        print("local compile census: empty (nothing observed "
              "in this process)")
    mesh = out.get("mesh")
    if mesh:
        flag = " DIVERGENT" if mesh.get("divergent") else ""
        print(f"mesh compiles (min {mesh['min']}, max {mesh['max']})"
              f"{flag}:")
        for rank, v in mesh["by_rank"].items():
            sites = ", ".join(f"{s}={n}" for s, n in v["sites"].items())
            print(f"  rank {rank}: {v['total']} ({sites})")
    elif args.mesh_dir:
        print(f"mesh compiles: no census in shards under "
              f"{args.mesh_dir}")
    cost = out.get("cost")
    if cost is not None:
        if "error" in cost:
            print(f"measured cost: unavailable ({cost['error']})")
        else:
            print(f"measured cost ({cost['kernel']}, dbits "
                  f"{cost['difficulty_bits']}): "
                  f"{cost['loop_instructions_per_nonce']:g} loop "
                  f"instructions/nonce | source {cost['source_adds']} "
                  f"adds/nonce (ratio {cost['instructions_over_adds']}), "
                  f"bound {cost['bound_sm_clocks_per_nonce']} SM "
                  f"clocks/nonce")
    return 0


def cmd_critical_path(args) -> int:
    """Per-block critical-path attribution (blocktrace): joins pipeline
    records mesh-wide (from --mesh-dir shards, or the in-process
    profiler) into per-block waterfalls."""
    from ..blocktrace.critical_path import critical_path_report, render_text

    skew_spans: dict = {}
    incidents: list = []
    compiles: dict = {}
    if args.mesh_dir:
        from ..meshwatch.aggregate import mesh_incidents, read_shards
        shards = read_shards(args.mesh_dir)
        records = [r for s in shards for r in s.get("pipeline") or []]
        skew_spans = {str(s["rank"]): s["skew_spans"] for s in shards
                      if s.get("skew_spans") and s.get("rank") is not None}
        incidents = mesh_incidents(shards)
        compiles = {str(s["rank"]): (s.get("compiles") or {}).get("events")
                    for s in shards
                    if (s.get("compiles") or {}).get("events")
                    and s.get("rank") is not None}
    else:
        from ..chainwatch import open_incidents
        from ..dispatchwatch import compile_events_tail
        from ..meshwatch.pipeline import profiler
        records = profiler().records()
        incidents = open_incidents()
        events = compile_events_tail()
        if events:
            compiles = {"0": events}
    report = critical_path_report(records, height=args.height)
    if args.trace:
        from ..blocktrace.export import to_critical_path_trace
        trace = to_critical_path_trace(report, records,
                                       skew_spans=skew_spans,
                                       incidents=incidents,
                                       compiles=compiles)
        pathlib.Path(args.trace).write_text(
            json.dumps(trace, sort_keys=True))
    if args.as_json:
        out = {"event": "perfwatch_critical_path",
               "source": str(args.mesh_dir) if args.mesh_dir
               else "in-process", **report}
        if args.trace:
            out["trace"] = {"path": str(args.trace),
                            "events": len(trace["traceEvents"])}
        print(json.dumps(out, sort_keys=True))
    else:
        print(render_text(report))
        if args.trace:
            print(f"perfetto trace -> {args.trace} "
                  f"({len(trace['traceEvents'])} events)",
                  file=sys.stderr)
    if args.height is not None and not report["blocks"]:
        print(f"critical-path: no attributable segments for height "
              f"{args.height}", file=sys.stderr)
        return 1
    return 0


def cmd_serve(args) -> int:
    from .server import MetricsServer

    srv = MetricsServer(port=args.port, host=args.host,
                        stall_s=args.stall_s)
    port = srv.start()
    print(json.dumps({"event": "perfwatch_serve", "host": args.host,
                      "port": port,
                      "endpoints": ["/metrics", "/healthz", "/events"]}),
          flush=True)
    try:
        import threading
        threading.Event().wait()            # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


#: The needles the smoke's live ``/metrics`` scrape must show.
SMOKE_NEEDLES = ("mining_rounds_total", "sim_heartbeat", "miner_heartbeat",
                 "# TYPE")


def cmd_smoke(args) -> int:
    """The perf smoke, in-process (no port leaks on failure)."""
    import threading
    import urllib.request

    from ..telemetry import clear_events, reset
    from ..telemetry.__main__ import run_instrumented
    from .server import MetricsServer

    if args.device != "cpu":
        from ..backend.cuda import resolve_device
        resolve_device(args.device)     # no card: a clean ConfigError
    launches = _sweep_launches(args.device)
    reset()
    clear_events()
    run: dict = {}
    srv = MetricsServer(port=0, stall_s=60.0)
    try:
        srv.start()

        def work():
            try:
                run.update(run_instrumented(
                    steps=2, sim_target=4, partition_steps=12,
                    drop_rate_pct=25, device=args.device))
            except Exception as e:  # reported below as the smoke's failure
                run["error"] = f"{type(e).__name__}: {e}"

        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        worker.join(timeout=120)
        if worker.is_alive():
            print("perf-smoke: instrumented run wedged", file=sys.stderr)
            return 1
        if "error" in run:
            print(f"perf-smoke: instrumented run failed: {run['error']}",
                  file=sys.stderr)
            return 1
        with urllib.request.urlopen(srv.url("/metrics"), timeout=10) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(srv.url("/healthz"), timeout=10) as r:
            health = json.loads(r.read().decode())
        for needle in SMOKE_NEEDLES:
            if needle not in metrics:
                print(f"perf-smoke: /metrics missing {needle!r}",
                      file=sys.stderr)
                return 1
        if not health["healthy"]:
            print(f"perf-smoke: /healthz unhealthy: {health}",
                  file=sys.stderr)
            return 1
    finally:
        srv.close()
    want = "cpu" if args.device == "cpu" else "cuda:cuda"
    rungs = [run["rung"], *run["sim_rungs"]]
    if any(r != want for r in rungs):
        print(f"perf-smoke: a backend left its rung {want!r}: {rungs}",
              file=sys.stderr)
        return 1
    launches = _sweep_launches(args.device) - launches
    if args.device != "cpu" and launches <= 0:
        print("perf-smoke: no sweep kernel launch on the card",
              file=sys.stderr)
        return 1

    # Detector leg: an injected 20% drop must flag, within-spread noise
    # must not, against a synthetic 2-entry history per series.
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        store = HistoryStore(pathlib.Path(tmp) / "hist.jsonl")
        base = {"kernel": "cuda", "backend": "cuda", "batch_pow2": 28,
                "n_miners": 1, "spread_pct": 0.5, "reps": 2}
        store.record("sweep", {**base, "hashes_per_sec_per_chip": 7.6e9},
                     source="smoke")
        store.record("sweep", {**base, "hashes_per_sec_per_chip": 6.08e9},
                     source="smoke")       # -20%: must regress
        flagged = regressions(check_history(store))
        store2 = HistoryStore(pathlib.Path(tmp) / "hist2.jsonl")
        store2.record("sweep", {**base, "hashes_per_sec_per_chip": 7.6e9},
                      source="smoke")
        store2.record("sweep", {**base, "hashes_per_sec_per_chip": 7.58e9},
                      source="smoke")      # -0.3%: within spread
        clean = regressions(check_history(store2))
        if len(flagged) != 1 or clean:
            print(f"perf-smoke: detector wrong (flagged={len(flagged)}, "
                  f"clean={len(clean)})", file=sys.stderr)
            return 1
    attribution = attribute_spans()
    print(json.dumps({"event": "perfwatch_smoke", "ok": True,
                      "healthz": health["status"],
                      "metrics_lines": len(metrics.splitlines()),
                      "span_attribution_dominant": attribution["dominant"],
                      "span_buckets": {b: v["seconds"] for b, v in
                                       attribution["buckets"].items()},
                      "device": args.device, "rungs": rungs,
                      "sweep_launches": launches},
                     sort_keys=True))
    return 0


def _sweep_launches(device: str) -> int:
    """The sweep kernel's launch count so far (0 off the card)."""
    if device == "cpu":
        return 0
    from ..ops import sha256_cuda

    return sha256_cuda.launches


def main(argv: list[str] | None = None) -> int:
    from ..config import ConfigError

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.perfwatch",
        description="live metrics endpoint + perf-regression sentinel")
    sub = parser.add_subparsers(dest="command", required=True)

    def _common(p, reads: bool = True):
        p.add_argument("--history", metavar="PATH", default=None,
                       help=(f"history JSONL (default: repo-root "
                             f"{DEFAULT_HISTORY_NAME}, read only)"
                             if reads else
                             "history JSONL to append to (required: the "
                             f"repo's {DEFAULT_HISTORY_NAME} is never "
                             "written)"))

    p_rec = sub.add_parser("record", help="append a measurement / seed "
                                          "from BENCH_r0*.json")
    _common(p_rec, reads=False)
    p_rec.add_argument("--section", choices=sorted(SECTION_METRICS))
    p_rec.add_argument("--payload", metavar="FILE",
                       help="JSON payload file (a bench section payload)")
    p_rec.add_argument("--source", default="cli")
    p_rec.add_argument("--seed-bench-rounds", action="store_true",
                       help="import BENCH_r0*.json + BENCH_CACHE.json")
    p_rec.add_argument("--root", default=None,
                       help="where the BENCH_r0*.json files live "
                            "(default: repo root)")
    p_rec.set_defaults(fn=cmd_record)

    p_chk = sub.add_parser("check", help="judge newest entries (or a "
                                         "--candidate payload); exit 1 "
                                         "on regression")
    _common(p_chk)
    p_chk.add_argument("--threshold-pct", type=float,
                       default=DEFAULT_THRESHOLD_PCT,
                       help="minimum drop considered a regression "
                            "(default %(default)s)")
    p_chk.add_argument("--k", type=float, default=DEFAULT_SPREAD_K,
                       help="spread multiplier: allowed = max(threshold, "
                            "k*spread_pct) (default %(default)s)")
    p_chk.add_argument("--section", choices=sorted(SECTION_METRICS))
    p_chk.add_argument("--candidate", metavar="FILE",
                       help="judge this payload against history without "
                            "recording it")
    p_chk.add_argument("--json", action="store_true", dest="as_json")
    p_chk.add_argument("--mesh-dir", metavar="DIR", default=None,
                       help="also report the open chainwatch incidents "
                            "of this --mesh-obs shard directory as "
                            "verdict context (never the gate)")
    p_chk.set_defaults(fn=cmd_check)

    p_rep = sub.add_parser("report", help="trajectory + roofline + "
                                          "pipeline and memory JSON report")
    _common(p_rep)
    p_rep.add_argument("--threshold-pct", type=float,
                       default=DEFAULT_THRESHOLD_PCT)
    p_rep.add_argument("--k", type=float, default=DEFAULT_SPREAD_K)
    p_rep.add_argument("--mesh-dir", metavar="DIR", default=None,
                       help="read dispatch pipeline records from this "
                            "--mesh-obs shard directory (the report CLI "
                            "is its own process, so overlap/bubble "
                            "numbers of a finished run live in its "
                            "shards)")
    p_rep.set_defaults(fn=cmd_report)

    p_cp = sub.add_parser(
        "critical-path",
        help="per-block critical-path waterfall: per-stage wall, the "
             "longest dependency chain, device/collective/host split, "
             "gap accounting (blocktrace)")
    p_cp.add_argument("--height", type=int, default=None,
                      help="restrict to one block height")
    p_cp.add_argument("--mesh-dir", metavar="DIR", default=None,
                      help="read pipeline records from this --mesh-obs "
                           "shard directory (default: the in-process "
                           "profiler)")
    p_cp.add_argument("--json", action="store_true", dest="as_json")
    p_cp.add_argument("--trace", metavar="PATH", default=None,
                      help="also write a Perfetto trace with the "
                           "critical path as a highlighted flow")
    p_cp.set_defaults(fn=cmd_critical_path)

    p_skw = sub.add_parser(
        "mesh-skew",
        help="mesh-wide rendezvous-skew report from a --mesh-obs shard "
             "directory: per-(site, round) arrival deltas, straggler "
             "rank, lag, idle chip-time (meshprof)")
    p_skw.add_argument("--mesh-dir", metavar="DIR", required=True,
                       help="the --mesh-obs shard directory whose "
                            "skew_spans to join")
    p_skw.add_argument("--json", action="store_true", dest="as_json")
    p_skw.set_defaults(fn=cmd_mesh_skew)

    p_inc = sub.add_parser(
        "incidents",
        help="open chainwatch incidents (from a --mesh-obs shard "
             "directory or this process) + evidence bundle listing")
    p_inc.add_argument("--mesh-dir", metavar="DIR", default=None,
                       help="the --mesh-obs shard directory whose open "
                            "incidents to merge (default: in-process)")
    p_inc.add_argument("--bundle-dir", metavar="DIR", default=None,
                       help="also list incident bundles written here "
                            "(mine --incident-dir)")
    p_inc.add_argument("--json", action="store_true", dest="as_json")
    p_inc.set_defaults(fn=cmd_incidents)

    p_cmp = sub.add_parser(
        "compiles",
        help="compile census (dispatchwatch): local + per-rank mesh "
             "counts, and the card's cost probe")
    p_cmp.add_argument("--mesh-dir", metavar="DIR", default=None,
                       help="also merge the compiles carriage of this "
                            "--mesh-obs shard directory (per-rank "
                            "totals + divergence flag)")
    p_cmp.add_argument("--no-probe", action="store_true",
                       help="skip the cost probe (it builds the kernel "
                            "library and disassembles its loop)")
    p_cmp.add_argument("--json", action="store_true", dest="as_json")
    p_cmp.set_defaults(fn=cmd_compiles)

    p_srv = sub.add_parser("serve", help="standalone metrics endpoint "
                                         "(until interrupted)")
    p_srv.add_argument("--port", type=int, default=0,
                       help="0 = ephemeral (announced on stdout)")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--stall-s", type=float, default=None,
                       help="healthz stall budget (default "
                            "MPIBT_HEALTHZ_STALL or 30)")
    p_srv.set_defaults(fn=cmd_serve)

    p_smk = sub.add_parser("smoke", help="the perf smoke: live scrape of "
                                         "an instrumented run + detector "
                                         "check")
    p_smk.add_argument("--device", choices=DEVICES, default="cuda",
                       help="where the instrumented run mines: the card, "
                            "or the C++ sweep; the CPU only when asked for")
    p_smk.set_defaults(fn=cmd_smoke)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ConfigError as e:
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2
    except BrokenPipeError:
        # `perfwatch check | head` is normal usage for a multi-line
        # report; a closed pipe is the reader's choice, not a regression.
        sys.stderr.close()
        return 0


if __name__ == "__main__":
    sys.exit(main())
