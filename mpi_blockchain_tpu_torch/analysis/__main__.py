"""CLI: python -m mpi_blockchain_tpu_torch.analysis

Runs the port's chainlint pass families and exits non-zero on any
finding. See docs/static_analysis_torch.md for the rule catalogue. The
flags are the reference's (``python -m mpi_blockchain_tpu.analysis``)
where the port has the family behind them:

* ``--audit-suppressions`` — append a warning-only report of
  ``chainlint: disable=`` comments whose rule no longer fires, computed
  from the same analysis run (stale suppressions never affect the exit
  code).
* ``--since REV`` — git-diff-driven changed-files mode: only pass
  families whose scope holds a changed file run.
* ``--rebaseline-waits`` — write the current static blocking-wait census
  into the port's ``analysis/WAITBUDGET.json``; refuses to raise it (the
  ratchet). A justified raise goes through the mover, ``python -m
  mpi_blockchain_tpu_torch.analysis.thread_lint --write``.
* ``--rebaseline``, ``--rebaseline-transfers``, ``--rebaseline-shards`` —
  the same for the op, transfer and collective-site budgets
  (``analysis/OPBUDGET.json``, ``TRANSFERBUDGET.json``,
  ``SHARDBUDGET.json``); their movers are the ``opbudget``,
  ``transfer_budget`` and ``shard_budget`` modules' ``--write``.
* ``--jobs N`` — run pass families on a thread pool; per-pass wall times
  are always collected and emitted under ``pass_timings_ms`` in
  ``--json`` output (a JSON object: ``{"findings": [...],
  "pass_timings_ms": {...}}``).
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import subprocess
import sys

from . import (apply_suppressions, audit_from_raw, default_root,
               families_for_changed, pass_families, run_all)

OVERRIDE_KEYS = ("capi", "ctypes_binding", "cuda_src", "cuda_binding",
                 "chain_hpp", "chain_cpp", "core_init", "sha_sched",
                 "sha_block", "sha_torch", "header_test",
                 "sanitize_driver", "sim_py",
                 "telemetry_files", "resilience_files",
                 "adversary_files", "rank_scope_files",
                 "blocktrace_scope_files", "conc_files",
                 "hotpath_files", "sync_files",
                 "lock_files", "future_files", "thread_files",
                 "wait_files", "waitbudget_json",
                 "skew_scope_files", "incident_scope_files",
                 "compile_scope_files", "spmd_files", "elastic_files",
                 "opbudget_json", "kernel_src", "host_src",
                 "transferbudget_json", "transfer_files",
                 "shardbudget_json", "shard_files")


def _changed_files(root: pathlib.Path, rev: str) -> list[str] | None:
    """Repo-relative paths changed since ``rev`` — committed + worktree
    edits PLUS untracked files (`git diff` alone would let a brand-new
    file with a violation sail through lint-fast green); None when git
    cannot answer."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", rev, "--"],
            cwd=root, capture_output=True, text=True, timeout=60)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if diff.returncode != 0 or untracked.returncode != 0:
        return None
    names = {line.strip() for line in diff.stdout.splitlines()
             if line.strip()}
    names |= {line.strip() for line in untracked.stdout.splitlines()
              if line.strip()}
    return sorted(names)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.analysis",
        description="chainlint for the PyTorch/CUDA port: binding "
                    "contracts of the two C interfaces, header layout, "
                    "the CUDA library's compute-sanitizer matrix, "
                    "telemetry discipline, swallow-proof fault handling, "
                    "thread races, hot-path blocking, device-sync "
                    "provenance, lock order, future and thread "
                    "lifecycles, collective consistency over the worlds, "
                    "and the port's wait, op, transfer and "
                    "collective-site budget ratchets")
    parser.add_argument("--root", type=pathlib.Path, default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--passes", default=None,
                        help="comma-separated subset of pass families "
                             f"(default: all of {sorted(pass_families())})")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit a JSON object {findings, "
                             "pass_timings_ms}")
    parser.add_argument("--override", action="append", default=[],
                        metavar="KEY=PATH",
                        help="redirect one checked file (drift-fixture "
                             f"test seam); keys: {', '.join(OVERRIDE_KEYS)}")
    parser.add_argument("--jobs", type=int, default=1, metavar="N",
                        help="run pass families on an N-thread pool "
                             "(default 1)")
    parser.add_argument("--since", default=None, metavar="REV",
                        help="changed-files mode: only run families "
                             "whose scope holds a file changed since "
                             "the git rev")
    parser.add_argument("--audit-suppressions", action="store_true",
                        help="also report stale 'chainlint: disable=' "
                             "comments from the same run (warning-only: "
                             "never affects the exit code)")
    parser.add_argument("--rebaseline", action="store_true",
                        help="write the current static ALU census into "
                             "the port's analysis/OPBUDGET.json (refuses "
                             "to raise it)")
    parser.add_argument("--rebaseline-transfers", action="store_true",
                        help="write the current static transfer-site "
                             "census into the port's analysis/"
                             "TRANSFERBUDGET.json (refuses to raise it)")
    parser.add_argument("--rebaseline-waits", action="store_true",
                        help="write the current static blocking-wait "
                             "census into the port's analysis/"
                             "WAITBUDGET.json (refuses to raise it)")
    parser.add_argument("--rebaseline-shards", action="store_true",
                        help="write the current static collective-site "
                             "census into the port's analysis/"
                             "SHARDBUDGET.json (refuses to raise it)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress the summary/notes lines")
    args = parser.parse_args(argv)

    overrides: dict[str, pathlib.Path] = {}
    for item in args.override:
        key, _, value = item.partition("=")
        if key not in OVERRIDE_KEYS or not value:
            parser.error(f"bad --override {item!r}; keys: "
                         f"{', '.join(OVERRIDE_KEYS)}")
        overrides[key] = pathlib.Path(value)

    root = args.root if args.root is not None else default_root()

    for flag, module, name, what in (
            ("rebaseline", "opbudget", "rebaseline", "op"),
            ("rebaseline_transfers", "transfer_budget",
             "rebaseline_transfers", "transfer"),
            ("rebaseline_waits", "thread_lint", "rebaseline_waits", "wait"),
            ("rebaseline_shards", "shard_budget", "rebaseline_shards",
             "collective")):
        if not getattr(args, flag):
            continue
        move = getattr(importlib.import_module(f".{module}", __package__),
                       name)
        try:
            old, new, path = move(root, overrides)
        except (ValueError, OSError, SyntaxError) as e:
            print(f"chainlint: {flag.replace('_', '-')} refused: {e}",
                  file=sys.stderr)
            return 2
        print(f"chainlint: {what} budget rebaselined {old} -> {new} "
              f"({path})", file=sys.stderr)
        return 0

    passes = ([p.strip() for p in args.passes.split(",") if p.strip()]
              if args.passes else None)
    if passes is not None:
        # Validate BEFORE any --since filtering: a typo'd family must
        # error, never silently shrink to an empty (green) run.
        unknown = [p for p in passes if p not in pass_families()]
        if unknown:
            parser.error(f"unknown pass families {unknown}; "
                         f"have {sorted(pass_families())}")
    if args.since is not None:
        changed = _changed_files(root, args.since)
        if changed is None:
            print(f"chainlint: cannot git-diff against {args.since!r}",
                  file=sys.stderr)
            return 2
        since_families = families_for_changed(changed)
        passes = ([p for p in passes if p in since_families]
                  if passes is not None else since_families)

    notes: list[str] = []
    timings: dict[str, float] = {}
    try:
        # Raw findings once; suppressions applied in-process so the
        # same run can feed both the gate and the staleness audit.
        raw = run_all(root=root, passes=passes, overrides=overrides,
                      notes=notes, jobs=max(args.jobs, 1),
                      timings=timings, apply_suppress=False)
    except ValueError as e:
        parser.error(str(e))
    except OSError as e:
        # A typo'd --override or a checked file missing from this install
        # (e.g. a wheel without the C++ sources) is a clean usage error,
        # not a traceback.
        print(f"chainlint: cannot read a checked file: {e}",
              file=sys.stderr)
        return 2
    findings = apply_suppressions(raw, root)

    warnings: list[str] = []
    if args.audit_suppressions:
        ran = passes if passes is not None else list(pass_families())
        warnings = audit_from_raw(root, raw, ran)

    if args.as_json:
        payload = {
            "findings": [f.to_dict() for f in findings],
            "pass_timings_ms": timings,
        }
        if args.audit_suppressions:
            payload["stale_suppressions"] = warnings
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        for w in warnings:
            print(f"audit: {w}")
    if not args.quiet:
        for note in notes:
            print(f"note: {note}", file=sys.stderr)
        n_passes = len(passes) if passes is not None \
            else len(pass_families())
        print(f"chainlint: {len(findings)} finding(s) across "
              f"{n_passes} pass families",
              file=sys.stderr)
        if args.audit_suppressions:
            print(f"chainlint: {len(warnings)} stale suppression(s)",
                  file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
