"""CONC rules — thread-escape race detection over the threaded substrate.

The port's host is genuinely multi-threaded: the meshwatch shard
flusher, the perfwatch and front-door HTTP endpoints, bench's rank
threads, the C++ backend's search thread, the elastic mesh's guarded
collectives and the device-init watchdog all run threads beside the
miner loop.
The classic drift bug is a future edit mutating state from the main
thread that a daemon thread also mutates — a torn shard seq, a lost
ring record — with no lock, which no test catches until it flakes.

The pass is flow-aware: it finds every thread ENTRY POINT in a module
(``threading.Thread(target=...)``, ``threading.Timer(s, fn)``, executor
``submit``/``map``), takes the module-local call-graph closure of the
targets (the *thread body*), and classifies every mutation of shared
state as thread-side or host-side:

* module-global state — a name assigned at module top level and mutated
  via ``global`` re-assignment, subscript assignment, or a mutating
  method call (``append``/``update``/``pop``/...);
* instance state — ``self.attr`` assignment/augmentation/subscript, or
  a mutating method call on ``self.attr``. Mutations inside
  ``__init__`` are construction, not sharing, and are ignored.

A mutation site is *synchronized* when it sits lexically inside a
``with`` block whose context expression names a lock (``self._lock``,
``_active_lock``, ``rlock``, ``mutex``, ``cond``/``condition`` —
matched per name token, see ``_is_lockish``).
State handed through ``queue.Queue`` never trips the rules (put/get are
not in the mutator set), and the telemetry registry's thread-safe API
(``counter``/``gauge``/``histogram`` calls) is not a tracked mutation
at all — those are exactly the sanctioned alternatives the rules point
at.

  CONC001  state mutated both inside and outside a thread body with NO
           lock at any site — an unsynchronized cross-thread race.
  CONC002  state mutated both inside and outside a thread body where
           SOME sites hold a lock and the flagged one does not —
           inconsistent locking, which is as racy as none.

Known limits (docs/static_analysis_torch.md): module-local analysis (a thread
started in module A mutating module B's state crosses the horizon);
reads are not tracked (a racy read-vs-write pair is invisible); lock
identity is by name, not object (two different locks spelled ``_lock``
look synchronized).

Scope: every ``.py`` of the port's package, its ``tools/`` included
(override key ``conc_files``).
"""
from __future__ import annotations

import ast
import pathlib
import re

from . import REPO_PACKAGE, Finding, override_files, rel_path, \
    source_cached
from .callgraph import CallGraph, call_name, dotted

#: Method names whose call mutates the receiver in place.
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft",
    "appendleft", "clear", "add", "discard", "update", "setdefault",
    "sort", "reverse",
}

#: Executor methods whose first argument runs on a worker thread.
_EXECUTOR_SPAWNS = {"submit", "map"}


def _is_lockish(expr: ast.expr) -> bool:
    """True when a ``with`` context expression names a synchronizer.

    Matched per name TOKEN (split on ``.``/``_``), not by raw substring:
    ``self._lock``, ``_active_lock``, ``rlock``, ``mutex``, ``cond`` /
    ``condition`` all match, while ``deadline_seconds`` must not (its
    'cond' is an accident of 'seconds') and ``trace_block`` /
    ``_begin_block`` must not either (their 'block' ends in 'lock' by
    the same accident)."""
    text = dotted(expr)
    if not text and isinstance(expr, ast.Call):
        text = dotted(expr.func)
    tokens = re.split(r"[._]+", text.lower())
    return any(tok.startswith(("lock", "mutex", "cond"))
               or (tok.endswith(("lock", "mutex"))
                   and not tok.endswith("block"))
               for tok in tokens if tok)


def _module_level_names(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for stmt in tree.body:
        targets: list[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
    return names


def _thread_targets(tree: ast.Module, graph: CallGraph,
                    owner_of: dict[int, "object"]) -> list:
    """FuncInfos that run on a spawned thread (module-local resolution)."""
    targets = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        exprs: list[ast.expr] = []
        if name == "Thread":
            exprs += [kw.value for kw in node.keywords
                      if kw.arg == "target"]
        elif name == "Timer":
            if len(node.args) >= 2:
                exprs.append(node.args[1])
            exprs += [kw.value for kw in node.keywords
                      if kw.arg == "function"]
        elif name in _EXECUTOR_SPAWNS and node.args:
            # pool.submit(fn, ...) / pool.map(fn, xs): heuristic — any
            # `.submit`/`.map` attribute call; a dict's .map does not
            # exist, and a false resolve only adds benign closure.
            if isinstance(node.func, ast.Attribute):
                exprs.append(node.args[0])
        caller = owner_of.get(id(node))
        for expr in exprs:
            targets.extend(graph.resolve_ref(expr, caller))
    return targets


class _MutationCollector(ast.NodeVisitor):
    """Collects (state key, lineno, locked?) mutations in one function.

    State keys: ("global", name) for module-level state,
    ("attr", cls, name) for instance state.
    """

    def __init__(self, info, module_names: set[str]):
        self.info = info
        self.module_names = module_names
        self.globals_declared: set[str] = set()
        self.sites: list[tuple[tuple, int, bool]] = []
        self._with_depth = 0

    # -- lock scope --------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        lockish = any(_is_lockish(item.context_expr)
                      for item in node.items)
        if lockish:
            self._with_depth += 1
        self.generic_visit(node)
        if lockish:
            self._with_depth -= 1

    def _locked(self) -> bool:
        return self._with_depth > 0

    # -- declarations ------------------------------------------------------

    def visit_Global(self, node: ast.Global) -> None:
        self.globals_declared.update(node.names)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is self.info.node:
            self.generic_visit(node)
        # Nested defs are separate FuncInfos — don't double-count.

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- mutation forms ----------------------------------------------------

    def _key_for_target(self, target: ast.expr) -> tuple | None:
        if isinstance(target, ast.Name):
            if target.id in self.globals_declared:
                return ("global", target.id)
            return None
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name):
            if target.value.id == "self" and self.info.cls is not None:
                return ("attr", self.info.cls, target.attr)
            return None
        if isinstance(target, ast.Subscript):
            return self._key_for_receiver(target.value)
        return None

    def _key_for_receiver(self, recv: ast.expr) -> tuple | None:
        """State key for a mutated RECEIVER (subscript base / method
        owner): a module-level name or a self attribute."""
        if isinstance(recv, ast.Name) and recv.id in self.module_names:
            return ("global", recv.id)
        if isinstance(recv, ast.Attribute) and \
                isinstance(recv.value, ast.Name) and \
                recv.value.id == "self" and self.info.cls is not None:
            return ("attr", self.info.cls, recv.attr)
        return None

    def _record(self, key: tuple | None, lineno: int) -> None:
        if key is not None:
            self.sites.append((key, lineno, self._locked()))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record(self._key_for_target(t), node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(self._key_for_target(node.target), node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(self._key_for_target(node.target), node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            self._record(self._key_for_receiver(node.func.value),
                         node.lineno)
        self.generic_visit(node)


def _render_key(key: tuple) -> str:
    if key[0] == "global":
        return f"module global '{key[1]}'"
    return f"instance state '{key[1]}.{key[2]}'"


#: Cheap text prefilter: a module with none of these tokens cannot spawn
#: a thread, so the graph/closure work is skipped (keeps the grown pass
#: set inside the make-check time budget).
_SPAWN_TOKENS = ("Thread(", "Timer(", ".submit(", ".map(")


def _scan_module(root: pathlib.Path, path: pathlib.Path) -> list[Finding]:
    rel = rel_path(path, root)
    try:
        text, tree, err = source_cached(path)
    except OSError:
        return []
    if not any(tok in text for tok in _SPAWN_TOKENS):
        return []
    if tree is None:
        return [Finding(rel, err[0], "CONC000",
                        f"syntax error: {err[1]}")]

    graph = CallGraph()
    graph.add_module(rel, tree)
    owners = graph.owner_map(rel)
    targets = _thread_targets(tree, graph, owners)
    if not targets:
        return []
    thread_quals = set(graph.reachable(targets))

    module_names = _module_level_names(tree)
    # key -> list of (qual, lineno, locked, in_thread)
    by_key: dict[tuple, list[tuple[str, int, bool, bool]]] = {}
    for info in graph.functions.values():
        if info.module != rel:
            continue
        if info.name == "__init__":
            continue    # construction precedes sharing
        collector = _MutationCollector(info, module_names)
        collector.visit(info.node)
        in_thread = info.qual in thread_quals
        for key, lineno, locked in collector.sites:
            by_key.setdefault(key, []).append(
                (info.qual, lineno, locked, in_thread))

    findings: list[Finding] = []
    for key, sites in sorted(by_key.items()):
        inside = [s for s in sites if s[3]]
        outside = [s for s in sites if not s[3]]
        if not inside or not outside:
            continue
        any_locked = any(s[2] for s in sites)
        for qual, lineno, locked, in_thread in sites:
            if locked:
                continue
            side = "inside" if in_thread else "outside"
            if not any_locked:
                findings.append(Finding(
                    rel, lineno, "CONC001",
                    f"{_render_key(key)} is mutated both inside and "
                    f"outside a thread body with no lock — this "
                    f"({side}-thread) site races the other side; guard "
                    f"every mutation with one Lock/RLock, hand the data "
                    f"through a queue, or use the telemetry registry's "
                    f"thread-safe API"))
            else:
                findings.append(Finding(
                    rel, lineno, "CONC002",
                    f"{_render_key(key)} is lock-guarded at some sites "
                    f"but this ({side}-thread) mutation is not — "
                    f"inconsistent locking is as racy as none; take the "
                    f"same lock here"))
    return findings


def _scoped_files(root: pathlib.Path) -> list[pathlib.Path]:
    """The threaded-substrate scope (the port's package, whose ``tools/``
    plays the reference's ``experiments/``) — the ONE copy shared by the
    conc, lock, future, and thread families."""
    pkg = root / REPO_PACKAGE
    return sorted(p for p in pkg.rglob("*.py")
                  if "__pycache__" not in p.parts
                  and p.relative_to(pkg).parts[0] != "build")


def run_conc_lint(root: pathlib.Path, overrides=None,
                  notes=None) -> list[Finding]:
    files = override_files(overrides, "conc_files",
                           lambda: _scoped_files(root))
    findings: list[Finding] = []
    for path in files:
        findings.extend(_scan_module(root, path))
    return findings
