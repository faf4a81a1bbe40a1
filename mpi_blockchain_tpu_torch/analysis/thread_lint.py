"""THR/TBW rules — thread lifecycle + the port's blocking-wait budget ratchet.

This pass catches, before any run, a helper thread that outlives its run
and wedges interpreter shutdown, and it holds the port's own ratchet: a
census of every place the port's concurrent substrate can BLOCK, pinned in
``analysis/WAITBUDGET.json`` (inside this package; the reference's
root-level ``WAITBUDGET.json`` is the reference's and is never read or
written here), so the worlds of processes and the serving front door
cannot silently accrete new places to hang.

  THR001  non-daemon thread with no join on any exit path: a
          ``threading.Thread``/``Timer`` constructed without
          ``daemon=True`` (or a later ``t.daemon = True``) whose handle
          is never ``.join()``-ed / ``.cancel()``-ed in the module — it
          outlives the run and wedges interpreter shutdown.
  THR002  thread target writing instance/global state with no lock
          while the host side READS it: CONC001/2 require mutation on
          both sides; a thread-side unlocked write racing a host-side
          read is the same torn-value bug. Single-writer designs
          justify-suppress with the rationale inline.
  TBW001  the static blocking-wait census of the wait-scope sources —
          ``with lock:`` acquires, ``.result()``, ``.get()``,
          ``.join()``, ``.wait()``, ``.acquire()`` — exceeds the
          committed budget. Wait sites only ratchet DOWN; a justified
          increase goes through the sanctioned mover (``python -m
          mpi_blockchain_tpu_torch.analysis.thread_lint --write``) and a
          reviewed baseline diff, and the baseline's ``sites`` section
          records WHICH seam sanctions each site.
  TBW002  the port's ``WAITBUDGET.json`` missing, unparseable, or lacking
          ``static_wait_sites``/``sites`` — the ratchet is not armed.
  TBW003  the census scope resolves to no readable source file — the
          gate is counting nothing (update ``WAIT_SCOPE`` alongside a
          refactor).

Census counting rules (deterministic): ``.result(`` always counts
(bounded or not — a bounded wait is still a wait site); ``.get(``/
``.join(`` count only with no positional args (excusing ``dict.get(key)``
and ``str.join(seq)``); ``.wait(`` and ``.acquire(`` always count; each
lockish ``with`` item counts once (the CONC token rule).
``--rebaseline-waits`` (the CLI) refuses to move the budget UP.

Scope: THR rules run over the port's package, ``tools/`` included
(override key ``thread_files``); the TBW census runs over ``WAIT_SCOPE``
(override keys ``wait_files``, ``waitbudget_json``).
"""
from __future__ import annotations

import ast
import pathlib

from . import DOC, REPO_PACKAGE, Finding, override_files, rel_path, \
    source_cached
from .budget import (int_key_error, mover_main, read_json_object,
                     refuse_upward, require_amendable, write_json_budget)
from .callgraph import CallGraph, call_name, dotted
from .conc_lint import (_MutationCollector, _is_lockish,
                        _module_level_names, _scoped_files,
                        _thread_targets)

BASELINE_NAME = "WAITBUDGET.json"
#: The port's budget lives in this package, beside the pass that reads it.
BASELINE_PATH = f"{REPO_PACKAGE}/analysis/{BASELINE_NAME}"
REQUIRED_KEYS = ("static_wait_sites", "sites")
MOVER = "python -m mpi_blockchain_tpu_torch.analysis.thread_lint --write"

_PKG = REPO_PACKAGE

#: The concurrent-substrate sources whose blocking-wait sites are
#: budgeted: the reference's list mapped onto the port, plus the port's
#: threads the reference does not have (the CUDA library's locks, the
#: rank processes of a world).
WAIT_SCOPE = (
    f"{_PKG}/models/miner.py",
    f"{_PKG}/models/fused.py",
    f"{_PKG}/backend/__init__.py",
    f"{_PKG}/backend/cpu.py",
    f"{_PKG}/backend/cuda.py",
    f"{_PKG}/ops/sha256_cuda.py",
    f"{_PKG}/parallel/mesh.py",
    f"{_PKG}/resilience/dispatch.py",
    f"{_PKG}/resilience/elastic.py",
    f"{_PKG}/meshwatch/shard.py",
    f"{_PKG}/meshwatch/pipeline.py",
    f"{_PKG}/meshwatch/world.py",
    f"{_PKG}/perfwatch/server.py",
    f"{_PKG}/service/mempool.py",
    f"{_PKG}/service/frontdoor.py",
)

#: file -> the seam that sanctions its wait sites, recorded per site in
#: the committed baseline so every budget review names what it grows.
WAIT_SEAMS = {
    f"{_PKG}/models/miner.py":
        "pipelined consume (bounded by MPIBT_DISPATCH_TIMEOUT)",
    f"{_PKG}/models/fused.py":
        "one host wait a k-block call (the nonces' pinned copy event); "
        "the fused world's winner-select rounds",
    f"{_PKG}/backend/cpu.py":
        "the C++ search thread (waited on under the consume's deadline)",
    f"{_PKG}/backend/cuda.py":
        "the sweep's read-back on the card (polled ready first)",
    f"{_PKG}/ops/sha256_cuda.py":
        "the ext-symbol lock (a short critical section, no wait on the "
        "card held) and a sweep's read-back",
    f"{_PKG}/resilience/dispatch.py":
        "single-flight launch and resolve (ladder RLock; the wait on the "
        "card is outside it)",
    f"{_PKG}/resilience/elastic.py":
        "guarded_collective watchdog (timeout-bounded rendezvous)",
    f"{_PKG}/meshwatch/shard.py":
        "daemon shard flusher (interval wait + bounded close join)",
    f"{_PKG}/meshwatch/pipeline.py":
        "pipeline profiler ring lock (short critical sections)",
    f"{_PKG}/meshwatch/world.py":
        "rank processes of a world (reaped after a kill)",
    f"{_PKG}/perfwatch/server.py":
        "metrics server lifecycle (bounded close join)",
    f"{_PKG}/service/mempool.py":
        "mempool heap/index lock (short critical sections, no IO held)",
    f"{_PKG}/service/frontdoor.py":
        "template-feed lock + admission gate (handler-thread critical "
        "sections; retries bounded by the `service` policy leash)",
}
_UNSANCTIONED = "unsanctioned — justify in the WAITBUDGET.json review"

_WAIT_METHODS_ALWAYS = {"result", "wait", "acquire"}
_WAIT_METHODS_BARE = {"get", "join"}      # positional args = not a wait


def _census_label(node: ast.Call) -> str | None:
    name = call_name(node)
    if not isinstance(node.func, ast.Attribute):
        return None
    if name in _WAIT_METHODS_ALWAYS:
        return f".{name}()"
    if name in _WAIT_METHODS_BARE and not node.args:
        return f".{name}()"
    return None


def static_wait_census(
        root: pathlib.Path, files: list[pathlib.Path]
) -> tuple[int, dict[str, int], list[dict],
           list[tuple[str, int, str]]]:
    """(total, per-label counts, per-site records, syntax errors) over
    the scoped files. Site records carry the sanctioning seam."""
    total = 0
    by_label: dict[str, int] = {}
    sites: list[dict] = []
    errors: list[tuple[str, int, str]] = []
    for path in sorted(pathlib.Path(p) for p in files):
        rel = rel_path(path, root)
        seam = WAIT_SEAMS.get(rel.replace("\\", "/"), _UNSANCTIONED)
        try:
            _, tree, err = source_cached(path)
        except OSError:
            continue
        if tree is None:
            errors.append((rel, err[0], err[1]))
            continue
        found: list[tuple[int, str]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.With):
                for item in node.items:
                    if _is_lockish(item.context_expr):
                        found.append((node.lineno, "with-lock"))
            elif isinstance(node, ast.Call):
                label = _census_label(node)
                if label is not None:
                    found.append((node.lineno, label))
        for lineno, label in sorted(found):
            total += 1
            by_label[label] = by_label.get(label, 0) + 1
            sites.append({"file": rel, "line": lineno, "label": label,
                          "seam": seam})
    return total, by_label, sites, errors


def _paths(root: pathlib.Path, overrides: dict
           ) -> tuple[pathlib.Path, list[pathlib.Path]]:
    baseline = pathlib.Path(overrides.get("waitbudget_json",
                                          root / BASELINE_PATH))
    files = override_files(overrides, "wait_files",
                           lambda: [root / p for p in WAIT_SCOPE])
    return baseline, files


def load_baseline(baseline: pathlib.Path) -> tuple[dict | None, str]:
    """(budget dict, error message) — dict None iff invalid."""
    data, err = read_json_object(baseline)
    if data is None:
        return None, err
    err = int_key_error(data, baseline.name, "static_wait_sites", MOVER)
    if err:
        return None, err
    if not isinstance(data.get("sites"), list):
        return None, (f"{baseline.name} lacks the per-site 'sites' "
                      f"seam record — regenerate it with `{MOVER}`")
    return data, ""


# ---- THR001/THR002 ---------------------------------------------------------

_THREAD_CTORS = {"Thread", "Timer"}
_SPAWN_TOKENS = ("Thread(", "Timer(", ".submit(", ".map(")


def _truthy_const(expr: ast.expr | None) -> bool | None:
    """True/False for a constant; None when not statically known."""
    if expr is None:
        return None
    if isinstance(expr, ast.Constant):
        return bool(expr.value)
    return None


def _target_matches(expr: ast.expr, target: ast.expr) -> bool:
    """Does ``expr`` (a receiver) denote the same handle as the
    constructor's assignment ``target`` (Name or self.attr)?"""
    if isinstance(target, ast.Name):
        return isinstance(expr, ast.Name) and expr.id == target.id
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name):
        return (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == target.value.id
                and expr.attr == target.attr)
    return False


def _thr001(rel: str, tree: ast.Module) -> list[Finding]:
    findings: list[Finding] = []
    assigns: list[tuple[ast.expr | None, ast.Call]] = []
    daemon_sets: list[ast.Assign] = []
    reap_calls: list[ast.Call] = []
    for node in ast.walk(tree):          # one walk collects everything
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                call_name(node.value) in _THREAD_CTORS and \
                len(node.targets) == 1:
            assigns.append((node.targets[0], node.value))
        elif isinstance(node, ast.Assign) and \
                isinstance(node.targets[0], ast.Attribute) and \
                node.targets[0].attr == "daemon" and \
                _truthy_const(node.value):
            daemon_sets.append(node)
        elif isinstance(node, ast.Expr) and \
                isinstance(node.value, ast.Call):
            call = node.value
            # threading.Thread(...).start() — unassigned, unjoinable.
            recv = call.func.value if isinstance(call.func, ast.Attribute) \
                else None
            if isinstance(recv, ast.Call) and \
                    call_name(recv) in _THREAD_CTORS:
                assigns.append((None, recv))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("join", "cancel"):
            reap_calls.append(node)
    for target, ctor in assigns:
        d = dotted(ctor.func)
        if d and d.split(".")[0] not in ("threading", "Thread", "Timer"):
            continue    # some_module.Thread lookalike: out of scope
        daemon = None
        for kw in ctor.keywords:
            if kw.arg == "daemon":
                daemon = _truthy_const(kw.value)
                if daemon is None:
                    daemon = True    # dynamic: assume daemonish (polarity)
        reaped = False
        if target is not None:
            daemon = daemon or any(
                _target_matches(n.targets[0].value, target)
                for n in daemon_sets)
            reaped = any(_target_matches(n.func.value, target)
                         for n in reap_calls)
        if daemon or reaped:
            continue
        handle = ("it is never bound to a handle" if target is None else
                  "its handle is never .join()-ed or .cancel()-ed in "
                  "this module")
        findings.append(Finding(
            rel, ctor.lineno, "THR001",
            f"non-daemon {call_name(ctor)} and {handle} — it outlives "
            f"the run and wedges interpreter shutdown (the reaping bug "
            f"class); pass daemon=True, or join/cancel it "
            f"on every exit path ({DOC} §THR)"))
    return findings


def _lock_held_quals(rel: str, graph: CallGraph) -> set[str]:
    """Quals whose EVERY module-local call site sits lexically inside a
    ``with lock:`` extent (and that have at least one call site) — the
    single-flight-worker idiom: ``search()`` takes the ladder RLock and
    everything it calls (``_step_down``, ``_checked_search``) runs
    lock-held without spelling the ``with`` again. One lexical hop;
    deeper indirection is out of scope."""
    sites: dict[str, list[bool]] = {}
    for info in graph.functions.values():
        if info.module != rel:
            continue

        def walk(nodes, held: bool, info=info) -> None:
            for child in nodes:
                if isinstance(child,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(child, ast.With):
                    inner = held or any(_is_lockish(i.context_expr)
                                        for i in child.items)
                    walk(child.body, inner)
                    continue
                if isinstance(child, ast.Call):
                    for callee in graph.resolve_call(child, info):
                        if callee.module == rel:
                            sites.setdefault(callee.qual,
                                             []).append(held)
                walk(ast.iter_child_nodes(child), held)

        walk(ast.iter_child_nodes(info.node), False)
    return {qual for qual, flags in sites.items() if flags and all(flags)}


def _thr002(rel: str, tree: ast.Module,
            graph: CallGraph) -> list[Finding]:
    owners = graph.owner_map(rel)
    targets = _thread_targets(tree, graph, owners)
    if not targets:
        return []
    thread_quals = set(graph.reachable(targets))
    module_names = _module_level_names(tree)

    # Thread-side unlocked mutations and host-side mutation keys.
    thread_writes: list[tuple[tuple, int]] = []
    host_mutated: set[tuple] = set()
    host_infos = []
    for info in graph.functions.values():
        if info.module != rel or info.name == "__init__":
            continue
        in_thread = info.qual in thread_quals
        collector = _MutationCollector(info, module_names)
        collector.visit(info.node)
        for key, line, locked in collector.sites:
            if in_thread and not locked:
                thread_writes.append((key, line, info.qual))
            if not in_thread:
                host_mutated.add(key)
        if not in_thread:
            host_infos.append(info)
    if not thread_writes:
        return []
    # Only now pay for the expensive context: functions whose every
    # call site is lock-held (the single-flight idiom), and host-side
    # READS. A read that is part of a host-side MUTATION still keys
    # into host_mutated, which defers the pair to CONC below.
    held_quals = _lock_held_quals(rel, graph)
    thread_writes = [(key, line) for key, line, qual in thread_writes
                     if qual not in held_quals]
    if not thread_writes:
        return []
    host_read: set[tuple] = set()
    for info in host_infos:
        for n in ast.walk(info.node):
            if isinstance(n, ast.Name) and \
                    isinstance(n.ctx, ast.Load) and \
                    n.id in module_names:
                host_read.add(("global", n.id))
            elif isinstance(n, ast.Attribute) and \
                    isinstance(n.ctx, ast.Load) and \
                    isinstance(n.value, ast.Name) and \
                    n.value.id == "self" and info.cls is not None:
                host_read.add(("attr", info.cls, n.attr))
    findings = []
    for key, line in sorted(set(thread_writes)):
        if key in host_mutated:
            continue    # both-sides mutation is CONC001/CONC002's call
        if key not in host_read:
            continue
        name = (f"module global '{key[1]}'" if key[0] == "global"
                else f"instance state '{key[1]}.{key[2]}'")
        findings.append(Finding(
            rel, line, "THR002",
            f"{name} is written by a thread target with no lock while "
            f"the host side reads it — a torn read CONC cannot see "
            f"(it tracks mutation pairs, not read-vs-write); guard the "
            f"write and the read with one lock, or justify the "
            f"single-writer design inline "
            f"({DOC} §THR)"))
    return findings


# ---- the pass --------------------------------------------------------------


def run_thread_lint(root: pathlib.Path, overrides=None,
                    notes=None) -> list[Finding]:
    overrides = overrides or {}
    findings: list[Finding] = []
    for path in override_files(overrides, "thread_files",
                               lambda: _scoped_files(root)):
        path = pathlib.Path(path)
        rel = rel_path(path, root)
        try:
            text, tree, err = source_cached(path)
        except OSError:
            continue
        if not any(tok in text for tok in _SPAWN_TOKENS):
            continue
        if tree is None:
            findings.append(Finding(rel, err[0], "THR000",
                                    f"syntax error: {err[1]}"))
            continue
        graph = CallGraph()
        graph.add_module(rel, tree)
        findings.extend(_thr001(rel, tree))
        findings.extend(_thr002(rel, tree, graph))

    # ---- the TBW ratchet ----------------------------------------------
    baseline_path, files = _paths(root, overrides)
    baseline, err = load_baseline(baseline_path)
    if baseline is None:
        findings.append(Finding(rel_path(baseline_path, root), 1,
                                "TBW002",
                                f"blocking-wait ratchet is not armed: "
                                f"{err}"))
        return findings
    readable = [p for p in files if pathlib.Path(p).is_file()]
    if not readable:
        findings.append(Finding(
            REPO_PACKAGE, 1, "TBW003",
            "blocking-wait census scope resolves to no readable source "
            "file — the gate is counting nothing; update WAIT_SCOPE in "
            "analysis/thread_lint.py alongside the refactor"))
        return findings
    total, by_label, sites, errors = static_wait_census(root, readable)
    findings.extend(Finding(rel, lineno, "TBW000",
                            f"syntax error: {msg}")
                    for rel, lineno, msg in errors)
    budget = baseline["static_wait_sites"]
    if total > budget:
        anchor = (sites[0]["file"], sites[0]["line"]) if sites else (
            rel_path(pathlib.Path(readable[0]), root), 1)
        breakdown = ", ".join(f"{k}×{v}"
                              for k, v in sorted(by_label.items()))
        findings.append(Finding(
            anchor[0], anchor[1], "TBW001",
            f"static blocking-wait census grew: {total} > budget "
            f"{budget} ({breakdown}). Places the port's concurrent "
            f"substrate can hang only ratchet DOWN; if this increase is "
            f"justified, re-census with `{MOVER}` and commit the "
            f"{BASELINE_PATH} diff — the baseline's sites section must "
            f"name the sanctioning seam ({DOC} §TBW)"))
    elif total < budget and notes is not None:
        notes.append(f"thread_lint: static wait census {total} is below "
                     f"the budget {budget} — ratchet it down with "
                     f"--rebaseline-waits (or the --write mover)")
    return findings


# ---- the ratchet movers ----------------------------------------------------


def rebaseline_waits(root: pathlib.Path,
                     overrides=None) -> tuple[int, int, pathlib.Path]:
    """Writes the current static wait census into the baseline, refusing
    to RAISE it (the ratchet). Returns (old, new, path). Raises
    ValueError when the census is higher, the scope is empty, or there
    is no valid baseline to amend — bootstrapping (and any justified
    raise) is the sanctioned mover's job (``thread_lint --write``)."""
    overrides = overrides or {}
    baseline_path, files = _paths(root, overrides)
    readable = [p for p in files if pathlib.Path(p).is_file()]
    if not readable:
        raise ValueError("wait census scope resolves to no readable "
                         "source file — nothing to baseline")
    total, by_label, sites, errors = static_wait_census(root, readable)
    if errors:
        raise ValueError(f"census scope has syntax errors: {errors[0]}")
    old_data, err = load_baseline(baseline_path)
    old_data = require_amendable(old_data, err, MOVER)
    old = old_data["static_wait_sites"]
    refuse_upward(total, old, census_label="static wait census",
                  policy="Blocking-wait sites only ratchet down",
                  mover=MOVER, baseline_name=BASELINE_NAME)
    data = dict(old_data)
    data["static_wait_sites"] = total
    data["by_label"] = dict(sorted(by_label.items()))
    data["sites"] = sites
    # Same ordering as write_budget (WAIT_SCOPE declaration order), so
    # a ratchet-down never reorders the committed review surface.
    data["scope"] = [rel_path(pathlib.Path(p), root) for p in readable]
    write_json_budget(baseline_path, data)
    return old, total, baseline_path


def write_budget(root: pathlib.Path | None = None,
                 overrides=None) -> pathlib.Path:
    """The one sanctioned mover: full rewrite of the port's
    WAITBUDGET.json (the census may move either way; the committed diff —
    including the per-site seam records — is the review surface)."""
    from . import default_root

    root = root if root is not None else default_root()
    baseline_path, files = _paths(root, overrides or {})
    readable = [p for p in files if pathlib.Path(p).is_file()]
    total, by_label, sites, errors = static_wait_census(root, readable)
    if errors:
        raise ValueError(f"census scope has syntax errors: {errors[0]}")
    data = {
        "static_wait_sites": total,
        "by_label": dict(sorted(by_label.items())),
        "sites": sites,
        "scope": [rel_path(pathlib.Path(p), root) for p in readable],
        "writer": MOVER,
    }
    write_json_budget(baseline_path, data)
    return baseline_path


def main(argv=None) -> int:
    return mover_main(
        argv,
        prog="python -m mpi_blockchain_tpu_torch.analysis.thread_lint",
        description="the sanctioned mover of the port's WAITBUDGET.json "
                    "(in mpi_blockchain_tpu_torch/analysis/): re-censuses "
                    "the wait scope's blocking-wait sites (with their "
                    "sanctioning seams) and rewrites the committed budget",
        write_help=f"re-census and rewrite {BASELINE_PATH}",
        label="thread_lint", writer=write_budget)


if __name__ == "__main__":
    import sys
    sys.exit(main())
