"""FUT rules — future-lifecycle provenance (deadlint).

The pipelined miner made futures first-class on the hot path:
``search_async`` dispatches return ``concurrent.futures.Future``s that
are consumed out of order, cancelled, drained through done-callbacks,
and (in the failure paths) must NEVER be silently dropped — a dropped
future swallows its exception, and an unbounded ``.result()`` on a
wedged dispatch is exactly the hang class ``guarded_collective`` exists
to kill. This pass reuses the provenance idea SYNC proved (track what a
value IS, not what the call looks like), specialized to the future
lifecycle:

  FUT001  dropped future: a ``search_async``/``executor.submit`` result
          discarded outright (a bare expression statement) or bound to
          a name that is never used again in the function — no
          ``.result()``/``.exception()``, no ``add_done_callback``, not
          stored, passed, or returned. Its exception is silently lost
          (the lost-error class; a miner sweep that failed this way
          reads as "no winner" forever).
  FUT002  unbounded blocking consume: ``.result()`` with no ``timeout=``
          or a zero-argument ``.get()`` outside the sanctioned seams
          (``guarded_collective`` and the ``_GuardWorker._loop``
          dispatch-worker inbox — the watchdogged waits that exist so
          nothing else has to wait unbounded — and the port's
          ``CpuBackend`` finish, see below). A wedged device dispatch
          behind an unbounded wait is a silent hang of every rank of
          a world.
  FUT003  done-callback mutating shared state without the owning lock:
          a callable registered via ``add_done_callback`` whose body
          mutates ``self.attr`` / module-global state with no lock held
          — done-callbacks run on whatever thread completes (or
          cancels) the future, so this is a cross-thread write CONC
          cannot see (the callback edge is invisible to its
          thread-closure walk).

Consumption polarity (FUT001 is deliberately under-approximate): ANY
later use of the bound name — storing it on ``self``, appending it to
a container, passing it to a helper — counts as consumed; only a
future that provably goes nowhere fires. A false negative here is the
price of zero false positives on the deque-threading pipeline driver.

Read for the port:

* ``.result()`` on a sweep launched on the card — the ``LaunchedSweep``
  that ``sha256_cuda.sweep_launch`` returns, bound to a name or called
  directly — is the sweep's read-back from the device, the counterpart
  of the reference's ``np.asarray`` on a device array, which FUT002
  never sees. It is no future (nothing on another thread completes it),
  and on the hot path SYNC prices it.
* The started C++ search's finish (``CpuBackend.launch``'s ``finish``)
  reads its search thread's future: ``ResilientBackend`` calls it only
  after ``_wait_ready`` has waited for that future against the consume's
  deadline, so its wait is bounded by its caller's, and a caller with no
  deadline is itself a FUT002 site.

Known limits (docs/static_analysis_torch.md §FUT): producers are recognized
by name (``search_async``, ``.submit(``); FUT001 is per-function (a
future returned to a caller who drops it is the caller's finding only
if the caller is in scope); FUT002 is syntactic (any ``.result()`` —
future or not — with positional args exempt, which excuses
``dict.get(key)`` and ``str.join(seq)``); FUT003 resolves callbacks
one step (a name, ``self.method``, ``functools.partial(fn, ...)``, or
an inline lambda), not through further indirection.

Scope: every ``.py`` of the port's package, its ``tools/`` included
(override key ``future_files``).
"""
from __future__ import annotations

import ast
import pathlib

from . import Finding, override_files, rel_path, source_cached
from .callgraph import CallGraph, FuncInfo, call_name, dotted
from .conc_lint import (_MutationCollector, _module_level_names,
                        _scoped_files)

#: Calls whose result is a future (by rightmost name / method shape).
_FUTURE_CALLS = {"search_async"}
_FUTURE_METHODS = {"submit"}

#: (class or None = any, function) seams sanctioned to wait unbounded:
#: guarded_collective IS the watchdog (its waits are bounded by
#: construction or feed the watchdog queue), and the _GuardWorker loop
#: parks on its inbox BETWEEN dispatches by design (a daemon worker
#: with nothing to do must block; the watchdog guards the dispatch, not
#: the idle park).
SANCTIONED_WAITERS = {(None, "guarded_collective"),
                      ("_GuardWorker", "_loop"),
                      ("CpuBackend", "finish")}

#: Calls that return a sweep launched on the card: ``.result()`` on what
#: they return is a read-back from the device, not a future's consume.
DEVICE_HANDLE_PRODUCERS = {"sweep_launch", "LaunchedSweep"}

#: Consuming attribute accesses that settle a future's lifecycle (for
#: the message text only — ANY later use consumes, see module doc).
_CONSUMERS = "result/exception/add_done_callback/cancel"

_SPAWN_TOKENS = ("search_async", ".submit(", ".result(", ".get()",
                 "add_done_callback")


def _is_future_producer(node: ast.Call) -> bool:
    name = call_name(node)
    if name in _FUTURE_CALLS:
        return True
    return (name in _FUTURE_METHODS
            and isinstance(node.func, ast.Attribute))


def _is_sanctioned(info: FuncInfo) -> bool:
    return ((info.cls, info.name) in SANCTIONED_WAITERS
            or (None, info.name) in SANCTIONED_WAITERS)


def _device_handles(tree: ast.Module) -> set[str]:
    """Names bound anywhere in the module from a device-handle producer
    (module-wide: the bind may sit in the closure's enclosing function)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                call_name(node.value) in DEVICE_HANDLE_PRODUCERS:
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names


def _is_device_readback(recv: ast.expr, handles: set[str]) -> bool:
    if isinstance(recv, ast.Call):
        return call_name(recv) in DEVICE_HANDLE_PRODUCERS
    return isinstance(recv, ast.Name) and recv.id in handles


def _unbounded_wait_label(node: ast.Call,
                          handles: set[str] = frozenset()) -> str | None:
    name = call_name(node)
    if not isinstance(node.func, ast.Attribute):
        return None
    kws = {kw.arg for kw in node.keywords}
    if name == "result" and not node.args and "timeout" not in kws:
        if _is_device_readback(node.func.value, handles):
            return None
        return ".result()"
    if name == "get" and not node.args and not node.keywords:
        return ".get()"
    return None


def _name_loads(tree: ast.AST, skip: ast.AST | None = None) -> set:
    """Every Name id loaded anywhere under ``tree`` (excluding the
    ``skip`` subtree — the producing assignment's own target)."""
    loads: set[str] = set()
    skipped = {id(n) for n in ast.walk(skip)} if skip is not None else set()
    for n in ast.walk(tree):
        if id(n) in skipped:
            continue
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            loads.add(n.id)
    return loads


def _callback_mutations(cb: ast.expr, graph: CallGraph, owner: FuncInfo,
                        module_names: set) -> list[tuple]:
    """Unlocked shared-state mutation sites inside a registered
    callback: [(key, line)]. ``cb`` is the add_done_callback argument."""
    # functools.partial(fn, ...) -> the wrapped fn.
    if isinstance(cb, ast.Call) and call_name(cb) == "partial" and cb.args:
        cb = cb.args[0]
    sites: list[tuple] = []
    if isinstance(cb, ast.Lambda):
        # Lambdas cannot assign; only mutating method calls on shared
        # receivers count (the conc mutator set).
        from .conc_lint import _MUTATORS
        for n in ast.walk(cb.body):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in _MUTATORS:
                recv = n.func.value
                if isinstance(recv, ast.Name) and recv.id in module_names:
                    sites.append((("global", recv.id), n.lineno))
                elif isinstance(recv, ast.Attribute) and \
                        isinstance(recv.value, ast.Name) and \
                        recv.value.id == "self" and owner.cls is not None:
                    sites.append((("attr", owner.cls, recv.attr),
                                  n.lineno))
        return sites
    for target in graph.resolve_ref(cb, owner):
        collector = _MutationCollector(target, module_names)
        collector.visit(target.node)
        sites.extend((key, line) for key, line, locked in collector.sites
                     if not locked)
    return sites


def _render_key(key: tuple) -> str:
    if key[0] == "global":
        return f"module global '{key[1]}'"
    return f"instance state '{key[1]}.{key[2]}'"


def _scan_module(root: pathlib.Path, path: pathlib.Path) -> list[Finding]:
    rel = rel_path(path, root)
    try:
        text, tree, err = source_cached(path)
    except OSError:
        return []
    if not any(tok in text for tok in _SPAWN_TOKENS):
        return []
    if tree is None:
        return [Finding(rel, err[0], "FUT000",
                        f"syntax error: {err[1]}")]

    graph = CallGraph()
    graph.add_module(rel, tree)
    module_names = _module_level_names(tree)
    owners = graph.owner_map(rel)
    handles = _device_handles(tree)
    findings: list[Finding] = []

    # ---- FUT002 + FUT003: per call site -------------------------------
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        owner = owners.get(id(node))
        label = _unbounded_wait_label(node, handles)
        if label is not None and \
                not (owner is not None and _is_sanctioned(owner)):
            where = (f" in {owner.label}" if owner is not None else "")
            findings.append(Finding(
                rel, node.lineno, "FUT002",
                f"unbounded blocking consume '{label}'{where} — a wedged "
                f"dispatch behind it is a silent hang (the class "
                f"guarded_collective exists to kill); pass timeout= and "
                f"surface the stall, or route the wait through a "
                f"sanctioned watchdogged seam "
                f"(docs/static_analysis_torch.md §FUT)"))
        if call_name(node) == "add_done_callback" and node.args and \
                owner is not None:
            for key, line in _callback_mutations(
                    node.args[0], graph, owner, module_names):
                findings.append(Finding(
                    rel, line, "FUT003",
                    f"done-callback registered in {owner.label} mutates "
                    f"{_render_key(key)} with no lock — done-callbacks "
                    f"run on whatever thread completes the future, so "
                    f"this races every other toucher of that state "
                    f"(invisible to CONC's thread-closure walk); take "
                    f"the owning lock inside the callback "
                    f"(docs/static_analysis_torch.md §FUT)"))

    # ---- FUT001: dropped futures, per owning function -----------------
    for qual, info in sorted(graph.functions.items()):
        if info.module != rel:
            continue
        for stmt in ast.walk(info.node):
            if isinstance(stmt, ast.Expr) and \
                    isinstance(stmt.value, ast.Call) and \
                    _is_future_producer(stmt.value) and \
                    owners.get(id(stmt.value)) is info:
                findings.append(Finding(
                    rel, stmt.lineno, "FUT001",
                    f"future from "
                    f"'{dotted(stmt.value.func) or call_name(stmt.value)}'"
                    f" in {info.label} is discarded — its exception is "
                    f"silently lost; keep it and {_CONSUMERS} it (or "
                    f"hand it to a consumer) "
                    f"(docs/static_analysis_torch.md §FUT)"))
                continue
            if not isinstance(stmt, ast.Assign) or \
                    not isinstance(stmt.value, ast.Call) or \
                    not _is_future_producer(stmt.value) or \
                    owners.get(id(stmt.value)) is not info:
                continue
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            if len(targets) != len(stmt.targets):
                continue    # attr/subscript target = stored = consumed
            used = _name_loads(info.node, skip=stmt)
            for t in targets:
                if t.id not in used:
                    findings.append(Finding(
                        rel, stmt.lineno, "FUT001",
                        f"future bound to '{t.id}' in {info.label} is "
                        f"never consumed on any path — no "
                        f"{_CONSUMERS}, not stored or passed on; its "
                        f"exception is silently lost "
                        f"(docs/static_analysis_torch.md §FUT)"))
    return findings


def run_future_lint(root: pathlib.Path, overrides=None,
                    notes=None) -> list[Finding]:
    files = override_files(overrides, "future_files",
                           lambda: _scoped_files(root))
    findings: list[Finding] = []
    for path in files:
        findings.extend(_scan_module(root, path))
    return findings
