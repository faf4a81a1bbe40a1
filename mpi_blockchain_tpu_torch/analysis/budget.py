"""Committed-ratchet plumbing for the port's budget family.

The port has one ratchet so far — its blocking-wait budget (TBW,
``analysis/WAITBUDGET.json`` inside this package; the reference's
root-level ratchet files belong to the reference and are never written
here). It rides the reference's contract: a JSON object committed in the
repo, a stdlib-only gate pass that recomputes a deterministic static
census and fails on growth, a ``--rebaseline-waits`` CLI that refuses to
move the budget UP, and one sanctioned mover that fully rewrites the
file. This module holds the load/validate/refusal/serialize mechanics;
the rule codes and the census stay in the family module.

Byte-level invariants the helpers pin:

* baselines serialize as ``json.dumps(data, indent=1, sort_keys=True)``
  plus a trailing newline, so a mover re-run on an unchanged tree is
  byte-identical;
* a rebaseline refusal is a ``ValueError`` starting with
  ``refusing to rebaseline upward:`` and an amend of a missing/corrupt
  baseline is a ``ValueError`` starting with
  ``no valid baseline to amend`` — the CLI (and the tests) match on
  those prefixes.
"""
from __future__ import annotations

import json
import pathlib


def read_json_object(path: pathlib.Path) -> tuple[dict | None, str]:
    """(object, error message) — object None iff the file is missing,
    unparseable, or not a JSON object. The error text names only the
    basename, so findings do not leak absolute paths."""
    try:
        data = json.loads(path.read_text())
    except OSError as e:
        return None, f"cannot read {path.name}: {e}"
    except ValueError as e:
        return None, f"{path.name} is not valid JSON: {e}"
    if not isinstance(data, dict):
        return None, f"{path.name} must hold a JSON object"
    return data, ""


def int_key_error(data: dict, baseline_name: str, key: str,
                  mover: str, *, positive: bool = False) -> str:
    """The validation error for a missing/non-integer budget key, or
    "" when the key holds a well-formed count. ``bool`` is rejected
    explicitly (it subclasses int and ``true`` in a hand-edited
    baseline must not arm the gate)."""
    v = data.get(key)
    ok = isinstance(v, int) and not isinstance(v, bool) and (
        v > 0 if positive else v >= 0)
    if ok:
        return ""
    kind = "positive" if positive else "non-negative"
    return (f"{baseline_name} lacks a {kind} integer {key!r} — "
            f"regenerate it with `{mover}`")


def require_amendable(old_data: dict | None, err: str,
                      mover: str) -> dict:
    """The rebaseline precondition: a valid committed baseline.
    Bootstrapping (and any justified raise) is the sanctioned mover's
    job — writing a fresh baseline here would just disarm the gate's
    traced/required sections on the next run."""
    if old_data is None:
        raise ValueError(
            f"no valid baseline to amend ({err}); bootstrap the budget "
            f"with `{mover}`")
    return old_data


def refuse_upward(current: int, old: int, *, census_label: str,
                  policy: str, mover: str, baseline_name: str) -> None:
    """The ratchet itself: raises ValueError when the fresh census
    exceeds the committed budget. ``policy`` is the family's one-line
    rationale ("Transfers only ratchet down", ...)."""
    if current > old:
        raise ValueError(
            f"refusing to rebaseline upward: {census_label} {current} "
            f"> committed budget {old}. {policy}; a justified increase "
            f"must go through `{mover}` and a reviewed "
            f"{baseline_name} diff")


def write_json_budget(path: pathlib.Path, data: dict) -> None:
    """The one sanctioned serialization (see module docstring)."""
    path.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")


def mover_main(argv, *, prog: str, description: str, write_help: str,
               label: str, writer) -> int:
    """The shared ``--write`` mover CLI: parses ``--write``/``--root``,
    calls ``writer(root)`` and reports ``{label}: wrote {path}`` (rc 0)
    or ``{label}: {error}`` (rc 2) on stderr."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(prog=prog, description=description)
    parser.add_argument("--write", action="store_true", help=write_help)
    parser.add_argument("--root", type=pathlib.Path, default=None)
    args = parser.parse_args(argv)
    if not args.write:
        parser.error("nothing to do: pass --write")
    try:
        path = writer(args.root)
    except (ValueError, OSError) as e:
        print(f"{label}: {e}", file=sys.stderr)
        return 2
    print(f"{label}: wrote {path}", file=sys.stderr)
    return 0
