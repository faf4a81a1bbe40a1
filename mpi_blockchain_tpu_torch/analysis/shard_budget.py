"""SBD rules — the collective-site budget ratchet of the port's worlds.

The counterpart of the reference's ``shard_budget``: a world of the port
lives or dies on exactly two collectives a round — ``winner_select``'s
all-reduces over the gloo group (``parallel/mesh.py``: SUM of the counts,
then MIN of the lowest nonces) — and nothing else stops a refactor from
adding a gather or an extra rendezvous to the round. The port's budget,
``analysis/SHARDBUDGET.json`` inside this package (the reference's root
``SHARDBUDGET.json`` is the reference's and is never read or written
here), pins a **static collective-site census**: the ``torch.distributed``
collective call sites of the SPMD pass's vocabulary (``spmd_lint``) plus
the calls of the ``winner_select`` seam, over ``SHARD_SCOPE``, each site
recorded by file, line and label. The gate fails when the census grows.

The census is a monotone proxy; the physical numbers ride in the budget's
``traced`` section, taken by RUNNING one round, not by reading it: the
mover joins a world of one gloo process and runs one round of each
flavor — the per-block world search (``CudaBackend`` with a group) and
the fused world's call (``_WorldCall``), on the card unless it is given
``--device cpu``, where both sweep with the plain version — under a
counting ``TorchDispatchMode``, which sees every ``c10d`` op a
collective dispatches (the profiler's ``record_param_comms`` events are
not emitted for gloo here). It records each op, its reduce op, its
dtype and its payload bytes, in order. Today: two ``allreduce_`` a
round, SUM then MIN, over int64, 16 payload bytes. The reference pins one
psum and one pmin over uint32 (8 bytes); the port's collectives carry
int64 because the "none" nonce 0xFFFFFFFF is negative as int32 and MIN
would pick it. Collectives a round do not depend on the world's size or
its device, so the CPU's census is the card's, tier-1 reproduces the
whole file, and the same census holds for two ranks on a card
(``--check`` with a world's flags; chip_smoke phase 17 c).

  SBD001  the static collective-site census exceeds the committed budget
          — a RATCHET INCREASE: collective sites only ratchet DOWN. A
          justified increase goes through the mover and a reviewed
          SHARDBUDGET.json diff; ``--rebaseline-shards`` only accepts a
          LOWER census.
  SBD002  the port's SHARDBUDGET.json is missing, unparseable, or lacks
          ``static_collective_sites``/``traced`` — the ratchet is not
          armed.
  SBD003  the census scope resolves to no readable source file — the
          gate is counting nothing (update ``SHARD_SCOPE`` alongside a
          refactor).

``--check`` re-runs the mover's whole census (static and traced) and
fails unless the committed budget reproduces byte for byte, calling out
growth as a RATCHET INCREASE with its delta.

Override keys: ``shardbudget_json`` (budget path), ``shard_files``
(census file set) — the drift-fixture seams.
"""
from __future__ import annotations

import ast
import pathlib

from . import REPO_PACKAGE, Finding, override_files, rel_path, \
    source_cached
from .budget import (int_key_error, read_json_object, refuse_upward,
                     require_amendable, write_json_budget)
from .callgraph import call_name
from .spmd_lint import COLLECTIVES, _Vocabulary

BASELINE_NAME = "SHARDBUDGET.json"
#: The port's budget lives in this package, beside the pass that reads it.
BASELINE_PATH = f"{REPO_PACKAGE}/analysis/{BASELINE_NAME}"
REQUIRED_KEYS = ("static_collective_sites", "traced")
MOVER = "python -m mpi_blockchain_tpu_torch.analysis.shard_budget --write"

_PKG = REPO_PACKAGE

#: The world-scope sources whose collective call sites are budgeted: the
#: reference's list, its ``backend/tpu.py`` read as ``backend/cuda.py``.
SHARD_SCOPE = (
    f"{_PKG}/parallel/mesh.py",
    f"{_PKG}/parallel/distributed.py",
    f"{_PKG}/backend/cuda.py",
    f"{_PKG}/models/fused.py",
    f"{_PKG}/models/miner.py",
)

#: Calls of the winner-select seam count as collective sites: a new seam
#: call site IS a new per-round collective pair.
_SEAM_CALLS = {"winner_select"}

#: The traced census's round shape on the CPU: small, so one plain sweep
#: takes milliseconds; the collectives a round do not depend on it.
TRACE_BATCH_POW2 = 8
TRACE_DIFFICULTY = 12


def static_collective_census(
        root: pathlib.Path, files: list[pathlib.Path]
) -> tuple[int, dict[str, int], list[dict],
           list[tuple[str, int, str]]]:
    """(total, per-label counts, per-site records, syntax errors) over
    the scoped files: ``torch.distributed`` collective calls plus
    ``winner_select`` seam calls (labels are the called name)."""
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
        vocab = _Vocabulary(tree)
        found: list[tuple[int, str]] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            op = vocab.op(node)
            if name in _SEAM_CALLS or op in COLLECTIVES:
                found.append((node.lineno, name if op is None else op))
        for lineno, label in sorted(found):
            total += 1
            by_label[label] = by_label.get(label, 0) + 1
            sites.append({"file": rel, "line": lineno, "label": label})
    return total, by_label, sites, errors


def _paths(root: pathlib.Path, overrides: dict
           ) -> tuple[pathlib.Path, list[pathlib.Path]]:
    baseline = pathlib.Path(overrides.get("shardbudget_json",
                                          root / BASELINE_PATH))
    files = override_files(overrides, "shard_files",
                           lambda: [root / p for p in SHARD_SCOPE])
    return baseline, files


def load_baseline(baseline: pathlib.Path) -> tuple[dict | None, str]:
    """(budget dict, error message) — dict None iff invalid."""
    data, err = read_json_object(baseline)
    if data is None:
        return None, err
    err = int_key_error(data, baseline.name, "static_collective_sites",
                        MOVER)
    if err:
        return None, err
    if not isinstance(data.get("traced"), dict):
        return None, (f"{baseline.name} lacks the 'traced' per-flavor "
                      f"collective census — regenerate it with "
                      f"`{MOVER}`")
    return data, ""


def run_shard_budget(root: pathlib.Path, overrides=None,
                     notes=None) -> list[Finding]:
    overrides = overrides or {}
    baseline_path, files = _paths(root, overrides)
    baseline, err = load_baseline(baseline_path)
    if baseline is None:
        return [Finding(rel_path(baseline_path, root), 1, "SBD002",
                        f"collective-site ratchet is not armed: {err}")]
    readable = [p for p in files if pathlib.Path(p).is_file()]
    if not readable:
        return [Finding(REPO_PACKAGE, 1, "SBD003",
                        "collective-site census scope resolves to no "
                        "readable source file — the gate is counting "
                        "nothing; update SHARD_SCOPE in "
                        "analysis/shard_budget.py alongside the "
                        "refactor")]
    total, by_label, sites, errors = static_collective_census(
        root, readable)
    findings = [Finding(rel, lineno, "SBD000", f"syntax error: {msg}")
                for rel, lineno, msg in errors]
    budget = baseline["static_collective_sites"]
    if total > budget:
        anchor = (sites[0]["file"], sites[0]["line"]) if sites else (
            rel_path(pathlib.Path(readable[0]), root), 1)
        breakdown = ", ".join(f"{k}×{v}"
                              for k, v in sorted(by_label.items()))
        findings.append(Finding(
            anchor[0], anchor[1], "SBD001",
            f"RATCHET INCREASE: static collective-site census grew: "
            f"{total} > budget {budget} (delta +{total - budget}; "
            f"{breakdown}). A round of a world carries exactly the "
            f"collectives {BASELINE_PATH} pins — an extra gather or "
            f"rendezvous here is paid by every rank every round; if this "
            f"increase is justified, re-census with `{MOVER}` and commit "
            f"the diff"))
    elif total < budget and notes is not None:
        notes.append(f"shard_budget: static census {total} is below "
                     f"the budget {budget} — ratchet it down with "
                     f"--rebaseline-shards (or the --write mover)")
    return findings


def rebaseline_shards(root: pathlib.Path,
                      overrides=None) -> tuple[int, int, pathlib.Path]:
    """Writes the current static collective census into the budget,
    refusing to RAISE it (the ratchet). Returns (old, new, path). Raises
    ValueError when the census is higher, the scope is empty, or there is
    no valid budget to amend — bootstrapping (and any justified raise) is
    the mover's job (``shard_budget --write``, which takes the traced
    census too)."""
    baseline_path, _ = _paths(root, overrides or {})
    static = static_section(root, overrides)
    old_data, err = load_baseline(baseline_path)
    old_data = require_amendable(old_data, err, MOVER)
    old, total = old_data["static_collective_sites"], \
        static["static_collective_sites"]
    refuse_upward(total, old, census_label="static collective census",
                  policy="Collective sites only ratchet down",
                  mover=MOVER, baseline_name=BASELINE_NAME)
    write_json_budget(baseline_path, {**old_data, **static})
    return old, total, baseline_path


def static_section(root: pathlib.Path, overrides=None) -> dict:
    """The budget's static keys, as the gate computes them. Raises
    ValueError when the scope is empty or does not parse."""
    _, files = _paths(root, overrides or {})
    readable = [p for p in files if pathlib.Path(p).is_file()]
    if not readable:
        raise ValueError("collective census scope resolves to no "
                         "readable source file — nothing to baseline")
    total, by_label, sites, errors = static_collective_census(
        root, readable)
    if errors:
        raise ValueError(f"census scope has syntax errors: {errors[0]}")
    return {
        "static_collective_sites": total,
        "static_by_site": dict(sorted(by_label.items())),
        "sites": sites,
        "scope": [rel_path(pathlib.Path(p), root) for p in readable],
    }


# ---- the mover (imports torch; never run by the gate) ----------------------


def _collective_counter():
    """A ``TorchDispatchMode`` that records every ``c10d`` op dispatched
    inside it: (op, reduce op or None, dtypes, payload bytes)."""
    import torch
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode

    def tensors(args):
        for a in args:
            if isinstance(a, torch.Tensor):
                yield a
            elif isinstance(a, (list, tuple)):
                yield from tensors(a)

    class CollectiveCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls: list[tuple[str, str | None, list[str], int]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "c10d":
                reduce = None
                for a in args:
                    if isinstance(a, torch.ScriptObject) and \
                            a._has_method("op"):
                        reduce = dist.ReduceOp.RedOpType(a.op()).name
                # The first argument holds the tensors the op reduces,
                # or those an all-gather fills: the bytes it carries.
                sent = list(tensors(args[:1]))
                self.calls.append((
                    func._schema.name.split("::")[-1], reduce,
                    sorted({str(t.dtype).removeprefix("torch.")
                            for t in sent}),
                    sum(t.numel() * t.element_size() for t in sent)))
            return func(*args, **(kwargs or {}))

    return CollectiveCounter()


def _census(calls) -> dict:
    ops: dict[str, int] = {}
    for op, _, _, _ in calls:
        ops[op] = ops.get(op, 0) + 1
    return {
        "collective_total": len(calls),
        "collectives": dict(sorted(ops.items())),
        "payload_bytes": sum(c[3] for c in calls),
        "sequence": [{"op": op, "reduce_op": reduce, "dtypes": dtypes,
                      "bytes": nbytes}
                     for op, reduce, dtypes, nbytes in calls],
    }


def trace_collective_census(device: str = "cpu",
                            batch_pow2: int = TRACE_BATCH_POW2,
                            difficulty_bits: int = TRACE_DIFFICULTY
                            ) -> dict[str, dict]:
    """The collectives one round of each world flavor issues, observed
    by running the round in the default process group, which the caller
    has joined (``world``): ``cuda_world``, one search of exactly one
    round through ``CudaBackend`` with the group (its slice, then
    ``winner_select``), and ``fused_world``, a one-block ``_WorldCall``
    capped at one round. On ``device`` "cpu" both sweep with the plain
    version; on a card, with the CUDA kernels."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import core
    from ..backend.cuda import CudaBackend
    from ..config import MinerConfig
    from ..models.fused import make_fused_miner

    group = dist.group.WORLD
    n = dist.get_world_size()
    cfg = MinerConfig(difficulty_bits=difficulty_bits)
    header = core.Node(difficulty_bits).make_candidate(cfg.payload(1))
    kernel = "torch" if device == "cpu" else "auto"
    flavors: dict[str, dict] = {}

    backend = CudaBackend(batch_pow2=batch_pow2, kernel=kernel,
                          device=device, n_miners=n, group=group)
    with _collective_counter() as counter:
        backend.search(header, difficulty_bits, start_nonce=0,
                       max_count=backend.round_size)
    flavors["cuda_world"] = _census(counter.calls)

    fn = make_fused_miner(1, batch_pow2, difficulty_bits, kernel=kernel,
                          device=device, max_rounds=1, n_miners=n,
                          group=group)
    prev = torch.zeros(8, dtype=torch.uint32, device=device)
    data = torch.from_numpy(np.arange(8, dtype=np.uint32)).reshape(1, 8)
    with _collective_counter() as counter:
        call, _ = fn(prev, data.to(device), 0)
        call.wait()
    flavors["fused_world"] = _census(counter.calls)
    return flavors


def _world(coordinator: str | None, num_processes: int, process_id: int):
    """Joins the world the traced census runs in: the given one, or a
    world of one process on a free local port."""
    import socket

    import torch.distributed as dist

    if coordinator is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"
        num_processes, process_id = 1, 0
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _full_census(root: pathlib.Path, overrides=None, *,
                 device: str = "cuda", coordinator: str | None = None,
                 num_processes: int = 1, process_id: int = 0,
                 batch_pow2: int = TRACE_BATCH_POW2,
                 difficulty_bits: int = TRACE_DIFFICULTY) -> dict:
    import torch.distributed as dist

    from ..backend.cuda import resolve_device

    static = static_section(root, overrides)
    resolve_device(device)   # no card: a ConfigError, before any world
    _world(coordinator, num_processes, process_id)
    try:
        traced = trace_collective_census(device, batch_pow2,
                                         difficulty_bits)
    finally:
        dist.destroy_process_group()
    return {
        **static,
        "traced": traced,
        "writer": MOVER,
    }


def write_budget(root: pathlib.Path | None = None, overrides=None,
                 **world) -> pathlib.Path:
    """The one sanctioned mover: full rewrite of the port's
    SHARDBUDGET.json — static census plus the traced per-flavor census
    of the world ``world`` describes (``_full_census``'s keywords; one
    process on the card by default). The committed diff is the review
    surface."""
    from . import default_root

    root = root if root is not None else default_root()
    baseline_path, _ = _paths(root, overrides or {})
    write_json_budget(baseline_path, _full_census(root, overrides, **world))
    return baseline_path


def check_budget(root: pathlib.Path | None = None, overrides=None,
                 **world) -> int:
    """Recomputes the mover's whole census (in the world ``world``
    describes, ``_full_census``'s keywords; one process on the card by
    default)
    and requires the committed budget to reproduce it byte for byte.
    Growth is a RATCHET INCREASE (rc 1 with the delta); any other drift
    is staleness (rc 1); an unarmed budget is rc 2. Prints one line
    starting ``shard_budget:`` on stderr either way."""
    import sys

    from . import default_root

    root = root if root is not None else default_root()
    baseline_path, _ = _paths(root, overrides or {})
    committed, err = load_baseline(baseline_path)
    if committed is None:
        print(f"shard_budget: not armed: {err}", file=sys.stderr)
        return 2
    current = _full_census(root, overrides, **world)
    cur, old = (current["static_collective_sites"],
                committed["static_collective_sites"])
    if cur > old:
        print(f"shard_budget: RATCHET INCREASE: static collective "
              f"census {cur} > committed {old} (delta +{cur - old}) — "
              f"collective sites only ratchet down; a justified increase "
              f"goes through `{MOVER}` and a reviewed {BASELINE_NAME} "
              f"diff", file=sys.stderr)
        return 1
    for flavor, traced in current["traced"].items():
        was = committed["traced"].get(flavor, {})
        t_cur = traced.get("collective_total", 0)
        t_old = was.get("collective_total", 0)
        if t_cur > t_old:
            print(f"shard_budget: RATCHET INCREASE: traced collective "
                  f"census for flavor '{flavor}' {t_cur} > committed "
                  f"{t_old} (delta +{t_cur - t_old}) — a round grew a "
                  f"collective; re-census with `{MOVER}` if justified",
                  file=sys.stderr)
            return 1
    if current != committed:
        print(f"shard_budget: {BASELINE_NAME} is stale — the mover "
              f"census no longer reproduces the committed budget; re-run "
              f"`{MOVER}` and review the diff", file=sys.stderr)
        return 1
    print(f"shard_budget: {BASELINE_NAME} reproduces ({cur} static "
          f"sites; a round of {sorted(current['traced'])}: "
          f"{[t['collective_total'] for t in current['traced'].values()]} "
          f"collectives, "
          f"{[t['payload_bytes'] for t in current['traced'].values()]} "
          f"payload bytes)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.analysis.shard_budget",
        description="the sanctioned mover of the port's SHARDBUDGET.json "
                    "(in mpi_blockchain_tpu_torch/analysis/): runs one "
                    "round of each world flavor in a gloo world (imports "
                    "torch) and rewrites or checks the committed "
                    "collective budget; the chainlint gate itself stays "
                    "stdlib-only")
    parser.add_argument("--write", action="store_true",
                        help="re-census and rewrite the budget")
    parser.add_argument("--check", action="store_true",
                        help="verify the committed budget reproduces "
                             "byte for byte")
    parser.add_argument("--baseline", type=pathlib.Path, default=None,
                        metavar="PATH",
                        help="check/write against another "
                             "SHARDBUDGET.json (the drift-fixture seam)")
    parser.add_argument("--root", type=pathlib.Path, default=None)
    parser.add_argument("--device", default="cuda",
                        help="run the rounds on this device (default "
                             "cuda: the CUDA kernels; cpu: the plain "
                             "sweep)")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="join this gloo world instead of a world of "
                             "one process")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--batch-pow2", type=int, default=TRACE_BATCH_POW2)
    parser.add_argument("--difficulty", type=int, default=TRACE_DIFFICULTY)
    args = parser.parse_args(argv)
    if args.write == args.check:
        parser.error("pass exactly one of --write and --check")
    overrides = ({"shardbudget_json": args.baseline}
                 if args.baseline is not None else None)
    world = dict(device=args.device, coordinator=args.coordinator,
                 num_processes=args.num_processes,
                 process_id=args.process_id, batch_pow2=args.batch_pow2,
                 difficulty_bits=args.difficulty)
    try:
        if args.check:
            return check_budget(args.root, overrides, **world)
        path = write_budget(args.root, overrides, **world)
    except (ValueError, OSError) as e:
        print(f"shard_budget: {e}", file=sys.stderr)
        return 2
    print(f"shard_budget: wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
