"""SPMD rules — collective consistency over the port's worlds of processes.

A world of the port is SPMD: every rank of a ``mine --coordinator`` world
runs the same program, and every ``torch.distributed`` collective over
its gloo group (``winner_select``'s two all-reduces, ``_agree_on_resume``'s
all-gather) and every rendezvous (``init_process_group``, the port's
``init_distributed``) must be entered by every rank in the same order. A
rank that skips one leaves its peers blocked in gloo until a timeout kills
the job: invisible to one-process tests, miserable to debug live. These
rules catch the lexical ways an edit makes ranks diverge, as the
reference's pass (``mpi_blockchain_tpu.analysis.spmd_lint``) does, read
for ``torch.distributed``:

  SPMD001  a collective/rendezvous call lexically guarded by a
           rank-identity conditional (``if dist.get_rank() == 0:``) —
           rank 0 enters the collective, every other rank never does: a
           world-wide hang, not an error.
  SPMD003  a collective/rendezvous reachable inside a ``try`` whose
           handler does not re-raise — a rank that catches and continues
           skips the collective its peers are blocked in (a one-rank
           retry is a world-wide hang). Handlers that re-raise (the
           cleanup idiom) are fine.
  SPMD004  a collective/rendezvous in an ELASTIC file (override key
           ``elastic_files``; default ``resilience/elastic.py``) that does
           not go through ``guarded_collective`` — elastic code is the
           rank-loss recovery path, so an unguarded rendezvous there hangs
           the survivors the supervisor exists to save. A collective is
           guarded inside a DEFERRED (lambda-wrapped) argument of a
           ``guarded_collective(...)`` call, or inside a function whose
           EVERY module-local call site is (one lexical hop, the
           ``_rendezvous`` idiom); an eager argument
           (``guarded_collective(self._rendezvous(n))``) runs before the
           guard and is flagged. Elastic files are exempt from SPMD001-003.

The reference's SPMD002 (a literal mesh axis name outside the canonical
set) has no counterpart: gloo collectives carry a process group, not an
axis name (docs/static_analysis_torch.md).

Vocabulary, read for torch (the reference's misses ``get_rank``, so its
rules see none of the port's rank tests):

* collectives — ``all_reduce``, ``all_gather``, ``broadcast``,
  ``barrier``, ``reduce``, ``gather``, ``scatter``, ``all_to_all`` and
  their ``_object``/``_tensor``/``_single`` forms, called on
  ``torch.distributed`` (``dist.``, ``torch.distributed.``, any alias the
  module binds to it, or a name imported from it: ``functools.reduce``
  and ``torch.gather`` are not collectives);
* rendezvous — ``init_process_group``, ``new_group``, the port's
  ``init_distributed`` and its per-round seam ``winner_select``;
* rank tests — ``get_rank``, ``rank`` (``group.rank()``, ``self.rank``),
  ``process_id``, ``process_index``, ``local_rank``, ``node_id``,
  ``mesh_rank``, ``is_coordinator`` and the CLI's ``is_main``, and any
  name a function assigns from an expression holding one (``last = rank
  == dist.get_world_size() - 1``). ``get_world_size`` alone is the same on
  every rank and is no rank test.

"Collective" also propagates module-locally, as in the reference: a
function whose body (transitively, within the module) calls a collective
is itself a collective site at its call sites.

Scope (override key ``spmd_files``): ``parallel/``, ``tools/``, and the
host code that drives a world's collectives — ``models/fused.py``
(``_WorldCall``), ``models/miner.py``, ``backend/cuda.py``
(``_start_world``) and ``cli.py`` (``_init_world``,
``_agree_on_resume``). The reference's worlds live inside a ``shard_map``
under ``parallel/``; the port's collectives run on the host beside the
code that calls them, so the scope follows them there.
"""
from __future__ import annotations

import ast
import pathlib

from . import REPO_PACKAGE, Finding, override_files, package_scope, \
    rel_path, source_cached
from .callgraph import call_name, dotted

#: Cross-rank collectives of ``torch.distributed``: skipping one on any
#: rank hangs the world.
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "broadcast", "barrier", "reduce", "gather",
    "scatter", "all_to_all", "all_gather_object", "all_gather_into_tensor",
    "broadcast_object_list", "gather_object", "scatter_object_list",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all_single"})

#: World rendezvous and the per-round seam: every rank must execute
#: these, in the same order. The names are the port's own, so any call
#: spelled so counts, whatever its receiver.
RENDEZVOUS = frozenset({"init_process_group", "new_group",
                        "init_distributed", "winner_select"})

#: Names in a conditional test that mark it rank-divergent.
RANK_TESTS = frozenset({"get_rank", "rank", "process_id", "process_index",
                        "local_rank", "node_id", "mesh_rank",
                        "is_coordinator", "is_main"})

#: Receivers that name ``torch.distributed`` with no import to read.
_DIST_RECEIVERS = frozenset({"dist", "torch.distributed"})

_SCOPE_FILES = ("models/fused.py", "models/miner.py", "backend/cuda.py",
                "cli.py")


class _Vocabulary:
    """A module's spellings of ``torch.distributed``: the aliases it binds
    to the package and the collectives it imports by name."""

    def __init__(self, tree: ast.Module):
        self.receivers = set(_DIST_RECEIVERS)
        self.bare: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch.distributed":
                        self.receivers.add(a.asname or a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "torch":
                    for a in node.names:
                        if a.name == "distributed":
                            self.receivers.add(a.asname or a.name)
                elif node.module == "torch.distributed":
                    for a in node.names:
                        if a.name in COLLECTIVES:
                            self.bare[a.asname or a.name] = a.name

    def op(self, node: ast.Call) -> str | None:
        """The op label when this call is directly a collective or a
        rendezvous."""
        name = call_name(node)
        if name in RENDEZVOUS:
            return name
        f = node.func
        if isinstance(f, ast.Attribute) and name in COLLECTIVES \
                and dotted(f.value) in self.receivers:
            return name
        if isinstance(f, ast.Name) and f.id in self.bare:
            return self.bare[f.id]
        return None


def _collective_funcs(tree: ast.Module, vocab: _Vocabulary) -> set[str]:
    """Names of module-local functions that (transitively, module-local)
    contain a collective — their call sites are collective sites too."""
    local: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local.setdefault(node.name, node)
    marked: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, fn in local.items():
            if name in marked:
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call) and (
                        vocab.op(sub) is not None
                        or call_name(sub) in marked):
                    marked.add(name)
                    changed = True
                    break
    return marked


def _rank_names_in(expr: ast.AST, derived: set[str]) -> set[str]:
    found: set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and (node.id in RANK_TESTS
                                           or node.id in derived):
            found.add(node.id)
        elif isinstance(node, ast.Attribute) and node.attr in RANK_TESTS:
            found.add(node.attr)
    return found


def _assigned_names(target: ast.expr) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for t in target.elts for n in _assigned_names(t)]
    return []


def _rank_derived(scope: ast.AST) -> set[str]:
    """Local names a scope assigns from an expression holding a rank
    test (to a fixed point, so a name derived from a derived name
    counts). Nested functions are their own scopes."""
    assigns: list[tuple[list[str], ast.expr]] = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Assign):
            assigns.append(([n for t in node.targets
                             for n in _assigned_names(t)], node.value))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and node.value is not None:
            assigns.append((_assigned_names(node.target), node.value))
        elif isinstance(node, ast.NamedExpr):
            assigns.append((_assigned_names(node.target), node.value))
        stack.extend(ast.iter_child_nodes(node))
    derived: set[str] = set()
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if set(names) <= derived or not _rank_names_in(value, derived):
                continue
            derived.update(names)
            changed = True
    return derived


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise)
               for stmt in handler.body for n in ast.walk(stmt))


class _ContextWalker(ast.NodeVisitor):
    """Tracks rank-conditional and swallowing-try lexical context."""

    def __init__(self, rel: str, vocab: _Vocabulary, propagated: set[str],
                 module: ast.Module, findings: list[Finding]):
        self.rel = rel
        self.vocab = vocab
        self.propagated = propagated
        self.findings = findings
        self._derived: list[set[str]] = [_rank_derived(module)]
        self._rank_if: list[tuple[int, set[str]]] = []
        self._swallow_try: list[int] = []

    # -- context ----------------------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        self._derived.append(_rank_derived(node))
        self.generic_visit(node)
        self._derived.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_If(self, node: ast.If) -> None:
        # The test runs on every rank that reaches the `if` (only the
        # ENCLOSING contexts apply to it): a rendezvous used AS the
        # condition must not escape both rules.
        self.visit(node.test)
        ranky = _rank_names_in(node.test, self._derived[-1])
        for branch in (node.body, node.orelse):
            # The else/elif branch of a rank test is equally divergent.
            if ranky:
                self._rank_if.append((node.lineno, ranky))
            for child in branch:
                self.visit(child)
            if ranky:
                self._rank_if.pop()

    def visit_Try(self, node: ast.Try) -> None:
        swallowing = any(not _handler_reraises(h) for h in node.handlers)
        if swallowing:
            self._swallow_try.append(node.lineno)
        for child in node.body:
            self.visit(child)
        if swallowing:
            self._swallow_try.pop()
        # A collective inside a NON-reraising handler is the literal
        # one-rank-retry pattern: only the rank that saw the exception
        # re-enters the rendezvous, its peers are not there.
        for handler in node.handlers:
            handler_swallows = not _handler_reraises(handler)
            if handler_swallows:
                self._swallow_try.append(node.lineno)
            for child in handler.body:
                self.visit(child)
            if handler_swallows:
                self._swallow_try.pop()
        for part in (node.orelse, node.finalbody):
            for child in part:
                self.visit(child)

    visit_TryStar = visit_Try

    # -- collective sites --------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        op = self.vocab.op(node)
        if op is None and call_name(node) in self.propagated:
            op = f"{call_name(node)} (contains a collective)"
        if op is not None:
            if self._rank_if:
                line, ranky = self._rank_if[-1]
                self.findings.append(Finding(
                    self.rel, node.lineno, "SPMD001",
                    f"collective/rendezvous '{op}' guarded by the "
                    f"rank-identity conditional on line {line} "
                    f"({sorted(ranky)}) — only some ranks enter it, the "
                    f"rest of the world blocks in gloo; run collectives "
                    f"unconditionally on every rank and branch on the "
                    f"RESULT instead"))
            if self._swallow_try:
                self.findings.append(Finding(
                    self.rel, node.lineno, "SPMD003",
                    f"collective/rendezvous '{op}' inside the try on "
                    f"line {self._swallow_try[-1]} whose handler does "
                    f"not re-raise — a rank that swallows the failure "
                    f"skips the collective its peers are blocked in "
                    f"(one-rank retry = world-wide hang); re-raise, or "
                    f"move the recovery outside the collective sequence"))
        self.generic_visit(node)


#: The sanctioned guard helpers SPMD004 recognizes (resilience/elastic).
ELASTIC_GUARDS = {"guarded_collective"}


class _ElasticWalker(ast.NodeVisitor):
    """Collects every call site's guard status in an elastic file:
    whether it sits inside a DEFERRED (lambda-wrapped) argument of a
    ``guarded_collective(...)`` call. In
    ``guarded_collective(self._rendezvous(n))`` the rendezvous runs
    eagerly in the caller's thread BEFORE the guard is entered —
    lexically inside the argument, unguarded at run time."""

    def __init__(self, vocab: _Vocabulary):
        self.vocab = vocab
        self._fn_stack: list[str] = []
        self._guard_depth = 0
        self._deferred_depth = 0
        #: (node, op label, innermost enclosing function, guarded)
        self.collectives: list[tuple[ast.Call, str, str | None, bool]] = []
        #: every call site: name -> [guarded?, ...]
        self.call_sites: dict[str, list[bool]] = {}

    def _guarded(self) -> bool:
        # Inside a guard argument AND behind a lambda since entering it:
        # only then does the code run on the guard's watchdogged worker.
        return self._guard_depth > 0 and self._deferred_depth > 0

    def visit_FunctionDef(self, node):
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        deferred = self._guard_depth > 0
        if deferred:
            self._deferred_depth += 1
        self.generic_visit(node)
        if deferred:
            self._deferred_depth -= 1

    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        self.call_sites.setdefault(name, []).append(self._guarded())
        op = self.vocab.op(node)
        if op is not None and not (set(self._fn_stack) & ELASTIC_GUARDS):
            self.collectives.append(
                (node, op, self._fn_stack[-1] if self._fn_stack else None,
                 self._guarded()))
        self.visit(node.func)
        if name in ELASTIC_GUARDS:
            self._guard_depth += 1
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)
        if name in ELASTIC_GUARDS:
            self._guard_depth -= 1


def _elastic_findings(rel: str, tree: ast.Module) -> list[Finding]:
    """SPMD004: unguarded collectives in an elastic file, with the
    reference's one lexical hop (see the module docstring)."""
    walker = _ElasticWalker(_Vocabulary(tree))
    walker.visit(tree)
    findings: list[Finding] = []
    for node, op, enclosing, guarded in walker.collectives:
        if guarded:
            continue
        if enclosing is not None:
            sites = walker.call_sites.get(enclosing, [])
            if sites and all(sites):
                continue   # only ever reached through the guard
        findings.append(Finding(
            rel, node.lineno, "SPMD004",
            f"collective/rendezvous '{op}' in an elastic file does not "
            f"go through guarded_collective — elastic code is the "
            f"rank-loss recovery path, and an unguarded rendezvous "
            f"there can hang the survivors the supervisor exists to "
            f"save; wrap the dispatch in guarded_collective(lambda: "
            f"...) (one lexical hop is recognized)"))
    return findings


def _default_elastic_files(root: pathlib.Path) -> list[pathlib.Path]:
    path = root / REPO_PACKAGE / "resilience" / "elastic.py"
    return [path] if path.is_file() else []


def _scoped_files(root: pathlib.Path) -> list[pathlib.Path]:
    return package_scope(root, ("parallel", "tools"), _SCOPE_FILES)


def _parse(path: pathlib.Path, rel: str, findings: list[Finding]
           ) -> ast.Module | None:
    try:
        _, tree, err = source_cached(path)
    except OSError:
        return None
    if tree is None:
        findings.append(Finding(rel, err[0], "SPMD000",
                                f"syntax error: {err[1]}"))
    return tree


def run_spmd_lint(root: pathlib.Path, overrides=None,
                  notes=None) -> list[Finding]:
    overrides = overrides or {}
    findings: list[Finding] = []
    for path in override_files(overrides, "spmd_files",
                               lambda: _scoped_files(root)):
        rel = rel_path(path, root)
        tree = _parse(path, rel, findings)
        if tree is None:
            continue
        vocab = _Vocabulary(tree)
        _ContextWalker(rel, vocab, _collective_funcs(tree, vocab), tree,
                       findings).visit(tree)
    # SPMD004 scope: the elastic files, which are deliberately EXEMPT
    # from SPMD001-003 (guarded_collective + watchdog recovery is their
    # sanctioned alternative to the re-raise discipline).
    for path in override_files(overrides, "elastic_files",
                               lambda: _default_elastic_files(root)):
        rel = rel_path(path, root)
        tree = _parse(path, rel, findings)
        if tree is not None:
            findings.extend(_elastic_findings(rel, tree))
    return findings
