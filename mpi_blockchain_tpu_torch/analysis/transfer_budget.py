"""TRB rules — the host-device transfer budget ratchet of the sweep path.

The counterpart of the reference's ``transfer_budget``: the port's
per-block search costs one 8-byte read-back a search (``read_result``),
and a k-block call of the fused miner one copy of its nonces, and
nothing else stops a refactor from adding a read-back or a sync to the
path. The port's budget, ``analysis/TRANSFERBUDGET.json`` inside this
package (the reference's root ``TRANSFERBUDGET.json`` is the reference's
and is never read or written here), pins a **static transfer-site
census** — a deterministic count of host-device transfer and sync call
sites in the sweep-path sources — and the gate fails when it grows.

The census counts, read for torch:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` (read-backs);
* ``.to(...)`` with a device (a ``device=`` keyword, or a positional
  argument that is not a ``torch.<dtype>``), and ``.copy_(...)`` that
  crosses devices as far as a static read can tell (``non_blocking=``,
  or a source made by ``.pin_memory()``/``.cpu()``/``.cuda()``/``.to()``);
  a same-device ``copy_`` and a dtype ``.to`` are not transfers;
* ``.synchronize()`` on any receiver (``torch.cuda.synchronize``,
  ``Event.synchronize``);
* the read-back seams: calls of ``read_result`` (``ops/sha256_cuda.py``)
  and ``.result()`` of a sweep from ``sweep_launch`` (``LaunchedSweep``)
  — a new seam call IS a new read-back.

The census is a monotone proxy; the physical numbers ride in the budget's
``traced`` section, taken on the card by the mover (``python -m
mpi_blockchain_tpu_torch.analysis.transfer_budget --write``; it imports
torch, and refuses to write a traced section without a card): the memcpy
and memset operations ``torch.profiler`` records on the card, by kind and
bytes, for one search of the per-block path (``CudaBackend.search``:
``sweep_launch`` and ``result``) and for a k-block call of ``FusedMiner``
(the data's upload, the extended midstate's ``cudaMemcpyToSymbolAsync``
for each block, the nonces' read-back), the port's counterpart of the
reference's jaxpr ``device_put`` count.

  TRB001  the static transfer-site census exceeds the committed budget —
          transfers on the sweep path only ratchet DOWN. A justified
          increase goes through the mover and a reviewed budget diff;
          ``--rebaseline-transfers`` only accepts a LOWER census.
  TRB002  the port's TRANSFERBUDGET.json is missing, unparseable, or
          lacks ``static_transfer_sites``/``traced`` — the ratchet is not
          armed.
  TRB003  the census scope resolves to no readable source file — the
          gate is counting nothing (update ``SWEEP_SCOPE`` alongside a
          refactor).

Override keys: ``transferbudget_json`` (budget path), ``transfer_files``
(census file set) — the drift-fixture seams.
"""
from __future__ import annotations

import ast
import pathlib

from . import REPO_PACKAGE, Finding, override_files, rel_path, \
    source_cached
from .budget import (int_key_error, read_json_object, refuse_upward,
                     require_amendable, write_json_budget)
from .callgraph import call_name, dotted

BASELINE_NAME = "TRANSFERBUDGET.json"
#: The port's budget lives in this package, beside the pass that reads it.
BASELINE_PATH = f"{REPO_PACKAGE}/analysis/{BASELINE_NAME}"
REQUIRED_KEYS = ("static_transfer_sites", "traced")
MOVER = "python -m mpi_blockchain_tpu_torch.analysis.transfer_budget --write"

_PKG = REPO_PACKAGE

#: The sweep-path sources whose transfer sites are budgeted: the
#: reference's list (``backend/tpu.py`` read as ``backend/cuda.py``), plus
#: the two files where the port's read-backs live.
SWEEP_SCOPE = (
    f"{_PKG}/models/miner.py",
    f"{_PKG}/models/fused.py",
    f"{_PKG}/backend/cuda.py",
    f"{_PKG}/backend/cpu.py",
    f"{_PKG}/parallel/mesh.py",
    f"{_PKG}/resilience/dispatch.py",
    f"{_PKG}/ops/sha256_cuda.py",
    f"{_PKG}/ops/sha256_block.py",
)

_READBACK_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_CROSSING_SOURCES = frozenset({"pin_memory", "cpu", "cuda", "to"})
_SEAM_CALLS = frozenset({"read_result"})
#: What a sweep launch returns is a ``LaunchedSweep``: its ``.result()``
#: is the read-back.
_SWEEP_LAUNCHES = frozenset({"sweep_launch"})
_DTYPES = frozenset({
    "bool", "uint8", "int8", "int16", "int32", "int64", "uint16", "uint32",
    "uint64", "float16", "bfloat16", "float32", "float64", "half", "float",
    "double", "long", "int", "short", "complex64", "complex128"})


def _is_dtype(node: ast.expr) -> bool:
    d = dotted(node)
    return d.startswith("torch.") and d.split(".")[-1] in _DTYPES


def _sweep_handles(tree: ast.Module) -> set[str]:
    """Names the module binds to a ``sweep_launch(...)`` result."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and call_name(node.value) in _SWEEP_LAUNCHES:
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names


def _site_label(node: ast.Call, handles: set[str]) -> str | None:
    """The census label when this call is a transfer/sync site."""
    name = call_name(node)
    if name in _SEAM_CALLS:
        return name
    if not isinstance(node.func, ast.Attribute):
        return None
    recv = node.func.value
    if name in _READBACK_METHODS:
        return f".{name}()"
    if name == "synchronize":
        return ".synchronize()"
    if name == "to":
        if any(k.arg == "device" for k in node.keywords) or any(
                not _is_dtype(a) for a in node.args):
            return ".to(device)"
        return None
    if name == "copy_":
        crossing = any(k.arg == "non_blocking" for k in node.keywords) or \
            any(isinstance(a, ast.Call)
                and call_name(a) in _CROSSING_SOURCES for a in node.args)
        return ".copy_(across devices)" if crossing else None
    if name == "result" and (
            (isinstance(recv, ast.Name) and recv.id in handles)
            or (isinstance(recv, ast.Call)
                and call_name(recv) in _SWEEP_LAUNCHES)):
        return "LaunchedSweep.result"
    return None


def static_transfer_census(
        root: pathlib.Path, files: list[pathlib.Path]
) -> tuple[int, dict[str, int], list[dict],
           list[tuple[str, int, str]]]:
    """(total, per-label counts, per-site records, syntax errors) over
    the scoped files."""
    total = 0
    by_label: dict[str, int] = {}
    sites: list[dict] = []
    errors: list[tuple[str, int, str]] = []
    for path in sorted(pathlib.Path(p) for p in files):
        rel = rel_path(path, root)
        try:
            _, tree, err = source_cached(path)
        except OSError:
            continue
        if tree is None:
            errors.append((rel, err[0], err[1]))
            continue
        handles = _sweep_handles(tree)
        found: list[tuple[int, str]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                label = _site_label(node, handles)
                if label is not None:
                    found.append((node.lineno, label))
        for lineno, label in sorted(found):
            total += 1
            by_label[label] = by_label.get(label, 0) + 1
            sites.append({"file": rel, "line": lineno, "label": label})
    return total, by_label, sites, errors


def _paths(root: pathlib.Path, overrides: dict
           ) -> tuple[pathlib.Path, list[pathlib.Path]]:
    baseline = pathlib.Path(overrides.get("transferbudget_json",
                                          root / BASELINE_PATH))
    files = override_files(overrides, "transfer_files",
                           lambda: [root / p for p in SWEEP_SCOPE])
    return baseline, files


def load_baseline(baseline: pathlib.Path) -> tuple[dict | None, str]:
    """(budget dict, error message) — dict None iff invalid."""
    data, err = read_json_object(baseline)
    if data is None:
        return None, err
    err = int_key_error(data, baseline.name, "static_transfer_sites",
                        MOVER)
    if err:
        return None, err
    if not isinstance(data.get("traced"), dict):
        return None, (f"{baseline.name} lacks the 'traced' memcpy census "
                      f"taken on the card — regenerate it with `{MOVER}`")
    return data, ""


def run_transfer_budget(root: pathlib.Path, overrides=None,
                        notes=None) -> list[Finding]:
    overrides = overrides or {}
    baseline_path, files = _paths(root, overrides)
    baseline, err = load_baseline(baseline_path)
    if baseline is None:
        return [Finding(rel_path(baseline_path, root), 1, "TRB002",
                        f"transfer-budget ratchet is not armed: {err}")]
    readable = [p for p in files if pathlib.Path(p).is_file()]
    if not readable:
        return [Finding(REPO_PACKAGE, 1, "TRB003",
                        "transfer-budget census scope resolves to no "
                        "readable source file — the gate is counting "
                        "nothing; update SWEEP_SCOPE in "
                        "analysis/transfer_budget.py alongside the "
                        "refactor")]
    total, by_label, sites, errors = static_transfer_census(root, readable)
    findings = [Finding(rel, lineno, "TRB000", f"syntax error: {msg}")
                for rel, lineno, msg in errors]
    budget = baseline["static_transfer_sites"]
    if total > budget:
        anchor = (sites[0]["file"], sites[0]["line"]) if sites else (
            rel_path(pathlib.Path(readable[0]), root), 1)
        breakdown = ", ".join(f"{k}×{v}" for k, v in sorted(by_label.items()))
        findings.append(Finding(
            anchor[0], anchor[1], "TRB001",
            f"static transfer-site census grew: {total} > budget "
            f"{budget} ({breakdown}). Host-device transfers and syncs on "
            f"the sweep path only ratchet DOWN; if this increase is "
            f"justified, re-census on the card with `{MOVER}` and commit "
            f"the {BASELINE_PATH} diff"))
    elif total < budget and notes is not None:
        notes.append(f"transfer_budget: static census {total} is below "
                     f"the budget {budget} — ratchet it down with "
                     f"--rebaseline-transfers (or the --write mover)")
    return findings


def rebaseline_transfers(root: pathlib.Path,
                         overrides=None) -> tuple[int, int, pathlib.Path]:
    """Writes the current static census into the budget, refusing to
    RAISE it (the ratchet). Returns (old, new, path). Raises ValueError
    when the census is higher, the scope is empty, or there is no valid
    budget to amend — bootstrapping (and any justified raise) is the
    mover's job on the card (``transfer_budget --write``, which takes the
    traced census too)."""
    baseline_path, _ = _paths(root, overrides or {})
    static = static_section(root, overrides)
    old_data, err = load_baseline(baseline_path)
    old_data = require_amendable(old_data, err, MOVER)
    old, total = old_data["static_transfer_sites"], \
        static["static_transfer_sites"]
    refuse_upward(total, old, census_label="static transfer census",
                  policy="Transfers only ratchet down",
                  mover=MOVER, baseline_name=BASELINE_NAME)
    write_json_budget(baseline_path, {**old_data, **static})
    return old, total, baseline_path


def static_section(root: pathlib.Path, overrides=None) -> dict:
    """The budget's static keys, as the gate computes them. Raises
    ValueError when the scope is empty or does not parse."""
    _, files = _paths(root, overrides or {})
    readable = [p for p in files if pathlib.Path(p).is_file()]
    if not readable:
        raise ValueError("transfer census scope resolves to no readable "
                         "source file — nothing to baseline")
    total, by_label, sites, errors = static_transfer_census(root, readable)
    if errors:
        raise ValueError(f"census scope has syntax errors: {errors[0]}")
    return {
        "static_transfer_sites": total,
        "static_by_site": dict(sorted(by_label.items())),
        "sites": sites,
        "scope": [rel_path(pathlib.Path(p), root) for p in readable],
    }


# ---- the mover (imports torch, needs the card; never run by the gate) ------

#: The traced census's shapes: one search of one 2^20 sweep at d20 (the
#: d20/n10/b20 pin's round), and fused calls of FUSED_K blocks at d16.
SEARCH_BATCH_POW2 = 20
SEARCH_DIFFICULTY = 20
FUSED_K = 4
FUSED_DIFFICULTY = 16


def memcpy_census(trace_path: str) -> dict[str, dict[str, int]]:
    """The device's memcpy and memset operations of a ``torch.profiler``
    chrome trace, by their name (``Memcpy DtoH (Device -> Pinned)``):
    their count and bytes."""
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, dict[str, int]] = {}
    for ev in events:
        if ev.get("cat") not in ("gpu_memcpy", "gpu_memset"):
            continue
        row = out.setdefault(ev["name"], {"bytes": 0, "count": 0})
        row["count"] += 1
        row["bytes"] += int(ev.get("args", {}).get("bytes", 0))
    return dict(sorted(out.items()))


def _profiled(fn) -> dict[str, dict[str, int]]:
    """The memcpy census of one run of ``fn`` on the card, in a capture
    window padded on both sides (``utils.profiling.padded_window``)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import padded_window

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            padded_window():
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return memcpy_census(path)
    finally:
        os.unlink(path)


def _difference(more: dict, less: dict) -> dict:
    """``more`` minus ``less``, by name and field; names that cancel out
    are dropped."""
    out = {}
    for name in sorted(set(more) | set(less)):
        row = {k: more.get(name, {}).get(k, 0) - less.get(name, {}).get(k, 0)
               for k in ("bytes", "count")}
        if any(row.values()):
            out[name] = row
    return out


def trace_transfer_census() -> dict:
    """The memcpy census of the sweep path on the card: one search of the
    per-block path (``per_search``), and ``FusedMiner`` spans of one and
    of two ``FUSED_K``-block calls, whose difference is one call
    (``per_call``) and whose rest is the span's own upload of its prev
    hash (``per_span``). Each is taken after a warm-up, so no first-use
    upload or build is in it. Refuses to run without a card."""
    import torch

    from .. import core
    from ..backend.cuda import CudaBackend
    from ..config import MinerConfig
    from ..models.fused import FusedMiner

    if not torch.cuda.is_available():
        raise ValueError("the traced transfer census is taken on a CUDA "
                         "device, and there is none here")
    cfg = MinerConfig(difficulty_bits=SEARCH_DIFFICULTY,
                      batch_pow2=SEARCH_BATCH_POW2, backend="cuda",
                      kernel="cuda")
    header = core.Node(SEARCH_DIFFICULTY).make_candidate(cfg.payload(1))
    backend = CudaBackend(batch_pow2=SEARCH_BATCH_POW2, kernel="cuda")

    def search():
        backend.search(header, SEARCH_DIFFICULTY, 0, backend.round_size)

    search()
    per_search = _profiled(search)

    fcfg = MinerConfig(difficulty_bits=FUSED_DIFFICULTY,
                       batch_pow2=SEARCH_BATCH_POW2, backend="cuda",
                       kernel="cuda")

    def span(calls: int):
        miner = FusedMiner(fcfg, blocks_per_call=FUSED_K,
                           log_fn=lambda record: None)
        miner.warmup()
        return lambda: miner.mine_chain(calls * FUSED_K)

    span(1)()
    one, two = _profiled(span(1)), _profiled(span(2))
    per_call = _difference(two, one)
    return {
        "fused": {"blocks_per_call": FUSED_K,
                  "difficulty_bits": FUSED_DIFFICULTY,
                  "per_call": per_call,
                  "per_span": _difference(one, per_call)},
        "per_search": {"batch_pow2": SEARCH_BATCH_POW2,
                       "difficulty_bits": SEARCH_DIFFICULTY,
                       "memcpy": per_search},
    }


def write_budget(root: pathlib.Path | None = None,
                 overrides=None) -> pathlib.Path:
    """The one sanctioned mover: full rewrite of the port's
    TRANSFERBUDGET.json — the static census and, from the card, the
    traced memcpy census (the committed diff is the review surface)."""
    from . import default_root

    root = root if root is not None else default_root()
    baseline_path, _ = _paths(root, overrides or {})
    data = static_section(root, overrides)
    data["traced"] = trace_transfer_census()
    data["writer"] = MOVER
    write_json_budget(baseline_path, data)
    return baseline_path


def check_budget(root: pathlib.Path | None = None, overrides=None) -> int:
    """On the card: recomputes the static census and the traced memcpy
    census and requires both to reproduce the committed budget. Growth is
    a RATCHET INCREASE (rc 1 with the delta), other drift staleness (rc
    1); a budget not armed or no card is rc 2. One line starting
    ``transfer_budget:`` on stderr per verdict, and the traced census as
    a JSON object on stdout when it was taken."""
    import json
    import sys

    from . import default_root

    root = root if root is not None else default_root()
    baseline_path, _ = _paths(root, overrides or {})
    committed, err = load_baseline(baseline_path)
    if committed is None:
        print(f"transfer_budget: not armed: {err}", file=sys.stderr)
        return 2
    static = static_section(root, overrides)
    try:
        traced = trace_transfer_census()
    except ValueError as e:
        print(f"transfer_budget: {e}", file=sys.stderr)
        return 2
    print(json.dumps(traced, sort_keys=True))
    cur, old = (static["static_transfer_sites"],
                committed["static_transfer_sites"])
    if cur > old:
        print(f"transfer_budget: RATCHET INCREASE: static transfer census "
              f"{cur} > committed {old} (delta +{cur - old})",
              file=sys.stderr)
        return 1
    if any(committed.get(k) != v for k, v in static.items()):
        print(f"transfer_budget: {BASELINE_NAME}'s static census is stale "
              f"— re-run `{MOVER}` and review the diff", file=sys.stderr)
        return 1
    if traced != committed["traced"]:
        print(f"transfer_budget: the traced memcpy census drifted: "
              f"{json.dumps(traced, sort_keys=True)} against the committed "
              f"{json.dumps(committed['traced'], sort_keys=True)}",
              file=sys.stderr)
        return 1
    print(f"transfer_budget: {BASELINE_NAME} reproduces ({cur} static "
          f"sites; a search {traced['per_search']['memcpy']}; a "
          f"{FUSED_K}-block call {traced['fused']['per_call']})",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.analysis.transfer_budget",
        description="the sanctioned mover of the port's "
                    "TRANSFERBUDGET.json (in mpi_blockchain_tpu_torch/"
                    "analysis/): profiles the sweep path's copies on the "
                    "card (imports torch) and rewrites or checks the "
                    "committed budget; the chainlint gate itself stays "
                    "stdlib-only")
    parser.add_argument("--write", action="store_true",
                        help="re-census on the card and rewrite the budget")
    parser.add_argument("--check", action="store_true",
                        help="verify the committed budget reproduces on "
                             "the card")
    parser.add_argument("--baseline", type=pathlib.Path, default=None,
                        metavar="PATH",
                        help="check/write against another "
                             "TRANSFERBUDGET.json (the drift-fixture seam)")
    parser.add_argument("--root", type=pathlib.Path, default=None)
    args = parser.parse_args(argv)
    if args.write == args.check:
        parser.error("pass exactly one of --write and --check")
    overrides = ({"transferbudget_json": args.baseline}
                 if args.baseline is not None else None)
    if args.check:
        return check_budget(args.root, overrides)
    try:
        path = write_budget(args.root, overrides)
    except (ValueError, OSError) as e:
        print(f"transfer_budget: {e}", file=sys.stderr)
        return 2
    print(f"transfer_budget: wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
