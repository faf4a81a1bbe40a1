"""Best-effort Python call-graph builder shared by the flow-aware passes.

CONC (thread-escape races) and HOTPATH (blocking calls on the dispatch
critical path) both need the same primitive: "which functions are
reachable from this entry point?". This module builds that graph from
nothing but the AST — stdlib-only, no imports of the analyzed code — so
the rules stay runnable in any environment, at the cost of well-known
static limits:

* **Name calls** resolve to a function of that name in the same module
  first, then to any same-named function in the analyzed file set.
* **``self.x()``** resolves to a method ``x`` of the enclosing class
  (same module first, then any class of the same name in the set).
* **Other attribute calls** (``obj.search()``) resolve to EVERY analyzed
  function named ``search`` — the deliberately conservative
  approximation of dynamic dispatch. There is no type inference and no
  dynamic-dispatch resolution (docs/static_analysis_torch.md §Known limits).
* **Callables passed as values** (``on_block=...`` callbacks,
  ``functools.partial`` objects handed around) are invisible: a code
  path that only exists through a callback is out of the graph.

The approximation errs toward OVER-connecting (a rule sees more paths
than runtime has), which is the right polarity for drift lints: a false
edge can be suppressed inline with a justification, a missing edge would
rot silently.
"""
from __future__ import annotations

import ast
import collections
import dataclasses
import pathlib
from typing import Callable, Iterable

from . import rel_path

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass
class FuncInfo:
    """One analyzed function/method (nested defs included)."""
    module: str                    # repo-relative posix path
    cls: str | None                # enclosing class name, if any
    name: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    lineno: int

    @property
    def qual(self) -> str:
        owner = f"{self.cls}." if self.cls else ""
        return f"{self.module}::{owner}{self.name}"

    @property
    def label(self) -> str:
        """Human label for finding messages: ``Miner.mine_block``."""
        return f"{self.cls}.{self.name}" if self.cls else self.name


def call_name(node: ast.Call) -> str:
    """Rightmost name of the called expression (torch.cuda.synchronize ->
    synchronize)."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def dotted(node: ast.expr) -> str:
    """Best-effort dotted path; '' when not a plain attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class CallGraph:
    """Function table + name-based call resolution over a file set."""

    def __init__(self) -> None:
        self.functions: dict[str, FuncInfo] = {}
        self._by_name: dict[str, list[FuncInfo]] = {}
        self._by_method: dict[tuple[str, str], list[FuncInfo]] = {}

    # ---- construction ----------------------------------------------------

    def add_module(self, module: str, tree: ast.Module) -> None:
        """Records every function/method (including nested defs)."""
        def visit(node: ast.AST, cls: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                elif isinstance(child, _FUNC_NODES):
                    info = FuncInfo(module, cls, child.name, child,
                                    child.lineno)
                    self.functions.setdefault(info.qual, info)
                    self._by_name.setdefault(child.name, []).append(info)
                    if cls is not None:
                        self._by_method.setdefault(
                            (cls, child.name), []).append(info)
                    # Nested defs KEEP the enclosing class: a closure
                    # inside a method captures `self`, so its
                    # `self.attr` mutations and `self.method()` calls
                    # belong to that class (the thread-body-as-closure
                    # idiom CONC must see).
                    visit(child, cls)
                else:
                    visit(child, cls)
        visit(tree, None)

    @classmethod
    def from_files(cls, root: pathlib.Path,
                   files: Iterable[pathlib.Path]
                   ) -> tuple["CallGraph", list[tuple[str, int, str]]]:
        """(graph, [(rel, lineno, syntax-error message)]) for a file set."""
        graph = cls()
        errors: list[tuple[str, int, str]] = []
        for path in files:
            path = pathlib.Path(path)
            rel = rel_path(path, root)
            try:
                tree = ast.parse(path.read_text(), filename=str(path))
            except SyntaxError as e:
                errors.append((rel, e.lineno or 1, e.msg or "syntax error"))
                continue
            except OSError:
                continue
            graph.add_module(rel, tree)
        return graph, errors

    # ---- resolution ------------------------------------------------------

    def _prefer_module(self, candidates: list[FuncInfo],
                       module: str) -> list[FuncInfo]:
        local = [c for c in candidates if c.module == module]
        return local if local else candidates

    def resolve_ref(self, expr: ast.expr,
                    caller: FuncInfo | None) -> list[FuncInfo]:
        """Function(s) a callable REFERENCE may denote (thread targets,
        executor-submitted fns): ``fn`` / ``self.method`` forms only."""
        module = caller.module if caller is not None else ""
        if isinstance(expr, ast.Name):
            return self._prefer_module(
                self._by_name.get(expr.id, []), module)
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and caller is not None
                and caller.cls is not None):
            return self._prefer_module(
                self._by_method.get((caller.cls, expr.attr), []), module)
        return []

    def resolve_call(self, node: ast.Call,
                     caller: FuncInfo) -> list[FuncInfo]:
        """Callee candidates of one call site (see module docstring for
        the resolution rules and their limits)."""
        f = node.func
        if isinstance(f, (ast.Name, ast.Attribute)):
            via_ref = self.resolve_ref(f, caller)
            if via_ref:
                return via_ref
        if isinstance(f, ast.Attribute):
            # Dynamic-dispatch approximation: every analyzed function of
            # this name, wherever it lives.
            return self._by_name.get(f.attr, [])
        if isinstance(f, ast.Name):
            return self._by_name.get(f.id, [])
        return []

    # ---- traversal -------------------------------------------------------

    def resolve_roots(self, entry_points: Iterable[tuple[str, str]]
                      ) -> tuple[list["FuncInfo"], list[tuple[str, str]]]:
        """Resolves ``(class, method)`` entry points to their FuncInfos:
        ``(roots, missing)``. The one copy of the root-set lookup every
        hot-path-rooted pass (HOTPATH, SYNC) shares — a missing entry is
        the pass's "the lint is checking nothing" rule (HOT002/SYNC003),
        reported per pass so a ``--passes`` subset still fires it."""
        roots: list[FuncInfo] = []
        missing: list[tuple[str, str]] = []
        for cls, method in entry_points:
            matches = [f for f in self.functions.values()
                       if f.cls == cls and f.name == method]
            if matches:
                roots.extend(matches)
            else:
                missing.append((cls, method))
        return roots, missing

    def owner_map(self, module: str) -> dict[int, "FuncInfo"]:
        """id(ast node) -> FuncInfo of the innermost enclosing function,
        for every node in ``module``'s functions. Traversal stops at
        nested defs — each claims its own body. The one copy of the
        innermost-owner lookup the flow-aware passes (CONC thread
        spawns, LCK lock scopes, FUT future provenance) share."""
        owners: dict[int, FuncInfo] = {}
        for info in self.functions.values():
            if info.module != module:
                continue
            stack = list(ast.iter_child_nodes(info.node))
            while stack:
                sub = stack.pop()
                owners[id(sub)] = info
                if isinstance(sub, _FUNC_NODES):
                    continue
                stack.extend(ast.iter_child_nodes(sub))
        return owners

    def nested_parents(self) -> dict[str, str]:
        """{nested function qual: qual of its NEAREST enclosing analyzed
        function} for every closure/thread-body def. Passes that analyze
        whole function bodies inline (the provenance walk) use this to
        skip a nested def only when an ancestor is itself analyzed —
        a reachable closure whose enclosing function is NOT reachable
        still gets its own standalone walk. The walk switches parent at
        every function boundary, so starting from any ancestor yields
        the same nearest-parent answer."""
        by_node = {id(info.node): info.qual
                   for info in self.functions.values()}
        parents: dict[str, str] = {}

        def visit(node: ast.AST, parent_qual: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_NODES):
                    qual = by_node.get(id(child))
                    if qual is not None:
                        parents[qual] = parent_qual
                        visit(child, qual)
                        continue
                visit(child, parent_qual)

        for info in self.functions.values():
            visit(info.node, info.qual)
        return parents

    def reachable(self, roots: Iterable[FuncInfo],
                  prune: Callable[[FuncInfo], bool] | None = None
                  ) -> dict[str, list[str]]:
        """BFS closure from ``roots``: {qual: call chain of labels from
        the root, root first}. ``prune(info)`` True stops traversal AT
        that function (it is excluded from the result entirely — the
        sanctioned-seam mechanism)."""
        chains: dict[str, list[str]] = {}
        queue: collections.deque[FuncInfo] = collections.deque()
        for r in roots:
            if prune is not None and prune(r):
                continue
            if r.qual not in chains:
                chains[r.qual] = [r.label]
                queue.append(r)
        while queue:
            info = queue.popleft()
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in self.resolve_call(node, info):
                    if callee.qual in chains:
                        continue
                    if prune is not None and prune(callee):
                        continue
                    chains[callee.qual] = (chains[info.qual]
                                           + [callee.label])
                    queue.append(callee)
        return chains
