"""LCK rules — lock-order and hold-while-waiting discipline (deadlint).

The port's pipelined dispatch made the host genuinely concurrent: the
single-flight launch-and-resolve under ``ResilientBackend``'s RLock, the
C++ backend's search thread, ``guarded_collective`` worker pools behind
``_idle_lock``, the shard flusher and metrics server threads beside the
pipeline-profiler ring lock. CONC catches *unlocked* cross-thread
mutation; nothing caught the opposite failure class — code that locks
CORRECTLY in isolation and deadlocks in composition, or parks every other
taker of a lock behind a wait on the card. In a world of processes a
lock-order inversion between two ranks' helper threads is a silent mesh
hang, which is exactly the class ``guarded_collective`` exists to kill
dynamically — this pass kills it statically.

The pass builds a **lock-acquisition graph** per module: every
``with <lock>:`` scope (lock spelled per the shared CONC token rule —
``self._lock``, ``_idle_lock``, ``rlock``, ``mutex``, ``cond``) is an
acquisition of an identified lock (``self.X`` keys to the enclosing
class, a module-level name keys to the module, anything else is
function-local), and the module-local call-graph closure propagates
which locks / blocking waits / callback invocations are reachable
while each lock is held:

  LCK001  lock-order inversion: two locks acquired in BOTH orders on
          some pair of reachable paths (A held while taking B, and B
          held while taking A) — two threads interleaving those paths
          deadlock. One finding per lock pair, anchored at the first
          witness, naming both acquisition sites.
  LCK002  blocking wait while holding a lock: an unbounded
          ``.result()``/``.get()``/``.join()``/``.wait()``/
          ``.acquire()`` (no ``timeout=``), or any HOTPATH blocking
          primitive (file I/O, ``time.sleep``, sockets, subprocess),
          lexically inside a ``with lock:`` extent or reachable from
          one through module-local calls — every other taker of that
          lock stalls behind the wait, and if the waited-on work needs
          the same lock the process deadlocks.
  LCK003  callback invocation while holding a lock: calling a stored /
          registered callable (an ``on_*``/``*_callback``/``*_cb``/
          ``*_hook`` name, ``add_done_callback`` — which runs the
          callback INLINE when the future is already done, on this
          thread, under this lock) — the classic re-entrancy deadlock
          when the callback takes the same lock, and a lock-hold-time
          landmine even when it does not.

Timeout-bounded waits (``.get(timeout=...)``, ``.result(timeout=...)``)
are exempt from LCK002: a bounded wait under a lock is a latency bug,
not a deadlock, and the WAITBUDGET census (thread_lint) prices it.

Known limits (docs/static_analysis_torch.md §LCK): analysis is module-local
(an inversion whose two orders live in different modules crosses the
horizon) with the usual name-based lock identity (two locks spelled
``self._lock`` on DIFFERENT classes are distinct keys; two different
locks bound to one name are one key); same-key re-acquisition is
skipped (RLock reentrancy — a non-reentrant self-acquire is invisible);
callables passed as values are invisible past the LCK003 name tokens.

Scope: every ``.py`` of the port's package, its ``tools/`` included
(override key ``lock_files``).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib

from . import Finding, override_files, rel_path, source_cached
from .callgraph import CallGraph, FuncInfo, call_name, dotted
from .conc_lint import (_is_lockish, _module_level_names,
                        _scoped_files)
from .hotpath_lint import _banned_label

#: Wait methods that block their caller until another thread acts; a
#: ``timeout=`` keyword (or positional timeout for .wait/.join) bounds
#: them and exempts the site from LCK002.
_WAIT_METHODS = {"result", "get", "join", "wait", "acquire"}

#: Callback-ish callee name shapes (rightmost name): the stored-callable
#: idiom LCK003 exists for.
_CALLBACK_SUFFIXES = ("_callback", "_cb", "_hook")
_CALLBACK_NAMES = {"callback", "cb", "hook", "add_done_callback"}

#: Cheap text prefilter: a module with none of these tokens holds no
#: lock scope, so the graph/closure work is skipped.
_LOCK_TOKENS = ("Lock(", "RLock(", "Condition(", "Semaphore(",
                "_lock", "mutex")


def _wait_label(node: ast.Call) -> str | None:
    """Label when this call is an UNBOUNDED blocking wait (or any
    HOTPATH blocking primitive)."""
    name = call_name(node)
    if isinstance(node.func, ast.Attribute) and name in _WAIT_METHODS:
        # Positional args: str.join(seq)/dict.get(key)/wait(5.0) — a
        # bounded or non-wait spelling either way; kw timeout bounds.
        kws = {kw.arg for kw in node.keywords}
        if not node.args and "timeout" not in kws:
            return f".{name}()"
        return None
    return _banned_label(node)


def _callback_label(node: ast.Call, cls_methods: set[str]) -> str | None:
    """Label when this call invokes a stored/registered callable."""
    name = call_name(node)
    if name in _CALLBACK_NAMES or name.startswith("on_") or \
            name.endswith(_CALLBACK_SUFFIXES):
        return name
    # self.X(...) where X is not a method of the enclosing class in
    # this module: a stored callable attribute.
    if isinstance(node.func, ast.Attribute) and \
            isinstance(node.func.value, ast.Name) and \
            node.func.value.id == "self" and cls_methods and \
            name not in cls_methods:
        return f"self.{name}"
    return None


def _lock_key(expr: ast.expr, info: FuncInfo,
              module_names: set[str]) -> tuple:
    """Identity key of a lockish ``with`` context expression."""
    d = dotted(expr)
    if not d and isinstance(expr, ast.Call):
        d = dotted(expr.func)
    parts = d.split(".") if d else []
    if parts and parts[0] == "self" and info.cls is not None:
        return ("attr", info.cls, ".".join(parts[1:]) or d)
    if parts and parts[0] in module_names:
        return ("global", d)
    return ("local", info.qual, d or f"<line {expr.lineno}>")


def _render_lock(key: tuple) -> str:
    if key[0] == "attr":
        return f"self.{key[2]} ({key[1]})"
    if key[0] == "global":
        return key[1]
    return key[2]


@dataclasses.dataclass
class _FnSummary:
    """One function's direct lock behavior, before closure."""
    info: FuncInfo
    #: (held-keys tuple, acquired key, line)
    acquires: list = dataclasses.field(default_factory=list)
    #: (held-keys tuple, label, line) — only sites under >=1 lock
    waits: list = dataclasses.field(default_factory=list)
    #: (held-keys tuple, label, line)
    callbacks: list = dataclasses.field(default_factory=list)
    #: (held-keys tuple — possibly empty, callee FuncInfo, line):
    #: EVERY resolved module-local call, so the closure can derive the
    #: call-edge list without a second AST walk.
    calls: list = dataclasses.field(default_factory=list)
    #: any blocking wait anywhere in the fn: (label, line)
    any_waits: list = dataclasses.field(default_factory=list)
    #: any callback call anywhere in the fn: (label, line)
    any_callbacks: list = dataclasses.field(default_factory=list)
    #: every lock key this fn acquires directly
    direct_locks: set = dataclasses.field(default_factory=set)


def _summarize(info: FuncInfo, graph: CallGraph, module: str,
               module_names: set[str]) -> _FnSummary:
    s = _FnSummary(info)
    cls_methods = ({m for (c, m) in graph._by_method
                    if c == info.cls} if info.cls is not None else set())

    def walk(nodes, held: tuple) -> None:
        for child in nodes:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue    # a nested def runs later, not under the lock
            if isinstance(child, ast.With):
                inner = held
                for item in child.items:
                    if _is_lockish(item.context_expr):
                        key = _lock_key(item.context_expr, info,
                                        module_names)
                        s.acquires.append((inner, key, child.lineno))
                        s.direct_locks.add(key)
                        inner = inner + (key,)
                walk(child.body, inner)
                continue
            if isinstance(child, ast.Call):
                wl = _wait_label(child)
                if wl is not None:
                    s.any_waits.append((wl, child.lineno))
                    if held:
                        s.waits.append((held, wl, child.lineno))
                cl = _callback_label(child, cls_methods)
                if cl is not None:
                    s.any_callbacks.append((cl, child.lineno))
                    if held:
                        s.callbacks.append((held, cl, child.lineno))
                for callee in graph.resolve_call(child, info):
                    if callee.module == module:
                        s.calls.append((held, callee, child.lineno))
            walk(ast.iter_child_nodes(child), held)

    walk(ast.iter_child_nodes(info.node), ())
    return s


def _closure(summaries: dict[str, _FnSummary], graph: CallGraph,
             module: str) -> tuple[dict, dict, dict]:
    """Transitive (lock / wait / callback) reach per function qual:
    ``all_locks[q]`` = {key: chain}, ``all_waits[q]`` /
    ``all_callbacks[q]`` = (label, line, chain) of one witness."""
    all_locks: dict[str, dict] = {}
    all_waits: dict[str, tuple | None] = {}
    all_callbacks: dict[str, tuple | None] = {}
    # Module-local call edges, straight from the summaries (which record
    # every resolved call, lock-held or not) — no second AST walk.
    edges: dict[str, list[str]] = {}
    for qual, s in summaries.items():
        edges[qual] = [callee.qual for _, callee, _ in s.calls
                       if callee.qual in summaries]
        all_locks[qual] = {k: s.info.label for k in s.direct_locks}
        all_waits[qual] = ((s.any_waits[0][0], s.any_waits[0][1],
                            s.info.label) if s.any_waits else None)
        all_callbacks[qual] = ((s.any_callbacks[0][0],
                               s.any_callbacks[0][1], s.info.label)
                              if s.any_callbacks else None)
    changed = True
    while changed:
        changed = False
        for qual, callees in edges.items():
            for c in callees:
                for key, chain in all_locks[c].items():
                    if key not in all_locks[qual]:
                        all_locks[qual][key] = \
                            f"{summaries[qual].info.label} -> {chain}"
                        changed = True
                for table in (all_waits, all_callbacks):
                    if table[qual] is None and table[c] is not None:
                        label, line, chain = table[c]
                        table[qual] = (
                            label, line,
                            f"{summaries[qual].info.label} -> {chain}")
                        changed = True
    return all_locks, all_waits, all_callbacks


_MSG_LCK002 = ("blocking wait '{label}' while holding {lock}{via} — every "
               "other taker of the lock stalls behind it, and if the "
               "waited-on work needs the same lock the process deadlocks; "
               "release the lock before waiting, or bound the wait with "
               "timeout= (docs/static_analysis_torch.md §LCK)")
_MSG_LCK003 = ("callback '{label}' invoked while holding {lock}{via} — a "
               "callback that takes the same lock re-enters and "
               "deadlocks (add_done_callback runs the callback INLINE "
               "when the future is already done); invoke callbacks "
               "after releasing the lock (docs/static_analysis_torch.md §LCK)")


def _scan_module(root: pathlib.Path, path: pathlib.Path) -> list[Finding]:
    rel = rel_path(path, root)
    try:
        text, tree, err = source_cached(path)
    except OSError:
        return []
    if not any(tok in text for tok in _LOCK_TOKENS):
        return []
    if tree is None:
        return [Finding(rel, err[0], "LCK000",
                        f"syntax error: {err[1]}")]

    graph = CallGraph()
    graph.add_module(rel, tree)
    module_names = _module_level_names(tree)
    summaries = {info.qual: _summarize(info, graph, rel, module_names)
                 for info in graph.functions.values()
                 if info.module == rel}
    if not any(s.direct_locks for s in summaries.values()):
        return []
    all_locks, all_waits, all_callbacks = _closure(summaries, graph, rel)

    findings: list[Finding] = []
    #: (outer, inner) -> (line, description) first witness
    order_edges: dict[tuple, tuple[int, str]] = {}

    def add_edge(outer: tuple, inner: tuple, line: int,
                 desc: str) -> None:
        if outer == inner:
            return    # RLock reentrancy / name-identity limit
        if (outer, inner) not in order_edges:
            order_edges[(outer, inner)] = (line, desc)

    for qual in sorted(summaries):
        s = summaries[qual]
        for held, key, line in s.acquires:
            for outer in held:
                add_edge(outer, key, line,
                         f"{s.info.label} takes {_render_lock(key)} "
                         f"while holding {_render_lock(outer)}")
        for held, label, line in s.waits:
            findings.append(Finding(
                rel, line, "LCK002", _MSG_LCK002.format(
                    label=label, lock=_render_lock(held[-1]), via="")))
        for held, label, line in s.callbacks:
            findings.append(Finding(
                rel, line, "LCK003", _MSG_LCK003.format(
                    label=label, lock=_render_lock(held[-1]), via="")))
        for held, callee, line in s.calls:
            if not held or callee.qual not in all_locks:
                continue
            for key, chain in all_locks[callee.qual].items():
                for outer in held:
                    add_edge(outer, key, line,
                             f"{s.info.label} holds "
                             f"{_render_lock(outer)} and reaches "
                             f"{_render_lock(key)} via {chain}")
            w = all_waits[callee.qual]
            if w is not None:
                label, _, chain = w
                findings.append(Finding(
                    rel, line, "LCK002", _MSG_LCK002.format(
                        label=label, lock=_render_lock(held[-1]),
                        via=f" (reached via {chain})")))
            c = all_callbacks[callee.qual]
            if c is not None:
                label, _, chain = c
                findings.append(Finding(
                    rel, line, "LCK003", _MSG_LCK003.format(
                        label=label, lock=_render_lock(held[-1]),
                        via=f" (reached via {chain})")))

    seen_pairs: set = set()
    for (a, b), (line_ab, desc_ab) in sorted(
            order_edges.items(), key=lambda kv: kv[1][0]):
        if (b, a) not in order_edges:
            continue
        pair = tuple(sorted((a, b)))
        if pair in seen_pairs:
            continue
        seen_pairs.add(pair)
        line_ba, desc_ba = order_edges[(b, a)]
        first, second = ((line_ab, desc_ab), (line_ba, desc_ba))
        if line_ba < line_ab:
            first, second = second, first
        findings.append(Finding(
            rel, first[0], "LCK001",
            f"lock-order inversion between {_render_lock(a)} and "
            f"{_render_lock(b)}: {desc_ab} (line {line_ab}), but "
            f"{desc_ba} (line {line_ba}) — two threads interleaving "
            f"these paths deadlock; pick ONE acquisition order and "
            f"hold it everywhere (docs/static_analysis_torch.md §LCK)"))
    return findings


def run_lock_lint(root: pathlib.Path, overrides=None,
                  notes=None) -> list[Finding]:
    files = override_files(overrides, "lock_files",
                           lambda: _scoped_files(root))
    findings: list[Finding] = []
    for path in files:
        findings.extend(_scan_module(root, path))
    return findings
