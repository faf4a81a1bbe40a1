"""CLI: python -m mpi_blockchain_tpu_torch.forensics

Point it at a causal event dump (``sim --events-dump PATH``, ``mine
--elastic --events-dump PATH``, or a flight recorder artifact's ``causal``
section re-wrapped) and it reconstructs the cross-node story: merged
causal order, fork tree, reorg audit, convergence stats, the attack
audit of an adversarial dump, and optionally a Perfetto-viewable Chrome
trace.

    python -m mpi_blockchain_tpu_torch.forensics --events causal.json
    python -m mpi_blockchain_tpu_torch.forensics --events causal.json --json
    python -m mpi_blockchain_tpu_torch.forensics --events causal.json \\
        --trace trace.json     # load at ui.perfetto.dev

The report is a pure function of the dump. An unreadable dump exits 2.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import analyze_dump, load_causal_dump, merge_events, to_chrome_trace


def _human_report(report: dict, out) -> None:
    tree = report["fork_tree"]
    conv = report["convergence"]
    print(f"nodes: {', '.join(report['nodes'])}", file=out)
    print(f"events merged: {report['events_merged']}", file=out)
    print(f"blocks: {len(tree['blocks'])} "
          f"(canonical {len(tree['canonical_chain'])}, "
          f"orphaned {len(tree['orphaned'])})", file=out)
    print(f"fork points: {len(tree['fork_points'])}", file=out)
    for prev, sibs in tree["fork_points"].items():
        print(f"  {prev} -> {', '.join(sibs)}", file=out)
    print(f"converged: {tree['converged']} "
          f"(canonical tip {tree['canonical_tip']}, "
          f"height {conv['canonical_height']})", file=out)
    print(f"tips: " + ", ".join(f"{n}={t}"
                                for n, t in tree["tips"].items()),
          file=out)
    lat = conv["delivery_latency_steps"]
    print(f"announcements: {conv['announcements']}, "
          f"deliveries: {conv['deliveries']}, "
          f"latency steps p50/max: {lat['p50']}/{lat['max']}", file=out)
    attacks = report.get("attack_audit") or {}
    if attacks:
        print("attacks:", file=out)
        for s in attacks.get("selfish", []):
            print(f"  selfish node {s['node']}: withheld "
                  f"{s['withheld_total']}, released {s['released_total']} "
                  f"in {len(s['releases'])} release(s), abandoned "
                  f"{s['abandoned_total']}; revenue {s['revenue_blocks']} "
                  f"canonical blocks ({s['revenue_share']:.1%})",
                  file=out)
            for r in s["releases"]:
                print(f"    release step {r['step']}: {r['count']} "
                      f"block(s) -> {r['reorgs_caused']} reorg(s), max "
                      f"depth {r['max_reorg_depth']} (tip {r['tip']})",
                      file=out)
        for e in attacks.get("eclipse", []):
            heal = e["post_heal_adopt"]
            heal_s = ("no post-heal adopt" if heal is None else
                      f"post-heal adopt at step {heal['step']} rolled "
                      f"back {heal['rolled_back']} for {heal['adopted']}")
            print(f"  eclipse {e['attacker']} -> victim {e['victim']} "
                  f"window {e['window']}: isolated fork "
                  f"{e['isolated_fork_len']} block(s) "
                  f"({','.join(e['isolated_fork']) or 'none'}); {heal_s}; "
                  f"victim tip canonical: {e['victim_tip_canonical']}",
                  file=out)
        for f in attacks.get("flood", []):
            paths = ", ".join(f"{k}={v}" for k, v in
                              f["rejections_by_path"].items())
            print(f"  flood node {f['node']}: {f['attacks']} attack(s), "
                  f"{f['rejections']} rejection(s) [{paths}]; chains "
                  f"untouched: {f['chains_untouched']}", file=out)
    print(f"reorgs: {conv['reorgs']}", file=out)
    for a in report["reorg_audit"]:
        loss = ("dropped=" + ",".join(a["announcements_dropped"])
                if a["announcements_dropped"] else "")
        defer = ("deferred=" + ",".join(
            a["announcements_partition_deferred"])
            if a["announcements_partition_deferred"] else "")
        why = " ".join(x for x in (loss, defer) if x) or "no recorded loss"
        print(f"  step {a['step']}: node {a['node']} rolled back "
              f"{a['rolled_back']} ({','.join(a['rolled_back_hashes'])}) "
              f"adopting {a['adopted']} -> {a['new_tip']}; {why} "
              f"[loss_explains_fork={a['loss_explains_fork']}]", file=out)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.forensics",
        description="merge per-node causal logs; reconstruct fork tree, "
                    "reorg audit, convergence stats; export Chrome trace")
    parser.add_argument("--events", required=True, metavar="PATH",
                        help="causal event dump (sim --events-dump PATH)")
    parser.add_argument("--trace", metavar="PATH", default=None,
                        help="also write Chrome trace-event JSON here "
                             "(view at ui.perfetto.dev)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the full report as sorted JSON")
    args = parser.parse_args(argv)

    try:
        dump = load_causal_dump(args.events)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"forensics: cannot read events dump: {e}", file=sys.stderr)
        return 2

    report = analyze_dump(dump)
    if args.trace:
        trace = to_chrome_trace(merge_events(dump))
        pathlib.Path(args.trace).write_text(
            json.dumps(trace, sort_keys=True))
        print(f"trace: {args.trace} ({len(trace['traceEvents'])} events)",
              file=sys.stderr)
    try:
        if args.as_json:
            print(json.dumps(report, sort_keys=True, indent=2))
        else:
            _human_report(report, sys.stdout)
    except BrokenPipeError:
        # `forensics ... | head` is normal usage for a multi-line report:
        # a closed pipe is the reader's choice, not a failure.
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
