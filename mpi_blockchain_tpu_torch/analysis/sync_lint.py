"""SYNC rules — implicit host-device syncs on the port's dispatch hot path.

The pipelined miners live or die on one discipline: between sweeps, the
host may TOUCH a device tensor only at the sanctioned read-back seams.
Every other touch — ``.item()``, ``.tolist()``, ``.cpu()``, ``int()`` on
a CUDA tensor, an ``if`` branching on one — is an implicit
``torch.cuda.synchronize``: the host stalls until the card drains, the
pipeline serializes, and the bubble the meshwatch pipeline report prices
silently re-opens. HOT001 cannot see this class (the calls look pure);
this pass can, because it tracks *value provenance*.

Walking the call graph from the shared hot-path roots
(``hotpath_lint.ENTRY_POINTS``), a lightweight flow-sensitive provenance
pass tags device-origin values through assignments, tuple unpacking,
subscripts, and closure ``nonlocal`` writebacks, then flags:

  SYNC001  a blocking host sync applied to a device-origin value outside
           the sanctioned seams: ``.item()``/``.tolist()``/``.cpu()``/
           ``.numpy()``, ``int()``/``float()``/``bool()``,
           ``np.asarray``/``np.array``, formatting into an f-string —
           plus any explicit ``torch.cuda.synchronize()`` or
           ``.synchronize()`` of an event or a stream on the hot path
           (definitionally a sync, device-origin or not).
  SYNC002  a device-origin value escaping into Python control flow (an
           ``if``/``while``/``assert``/ternary test, a ``for`` iterating
           a device tensor) — forces the same sync.
  SYNC003  a configured hot-path entry point does not exist in the
           analyzed file set (mirrors HOT002; the root set is shared).

Read for PyTorch:

* Device-origin values are the results of a backend's ``search`` and
  ``search_async``, of ``sha256_cuda.sweep_launch`` and
  ``LaunchedSweep``, of dispatching a built k-block program
  (``self._fn(k)(...)``, the factory-call-then-call shape), and of
  ``torch.*`` constructors and ``.to(...)``/``.cuda()`` moves onto a
  device other than the CPU (a ``device=`` keyword that is not the
  literal ``"cpu"``).
* ``isinstance`` and the other type tests (``issubclass``, ``type``,
  ``callable``, ``hasattr``) read the Python object, never the tensor's
  data: they do not sync, and their result is host-origin.

Sanctioned seams:

* the module seams HOTPATH prunes (telemetry/, meshwatch/, perfwatch/,
  blocktrace/, resilience policy/injection, utils/logging, service/,
  core/build.py) — host work inside them is their own reviewed
  contract;
* the port's read-back points: ``LaunchedSweep.result`` and
  ``read_result`` (ops/sha256_cuda.py; one 8-byte copy after the sweep's
  event), the fused call's ``_Readback`` (models/fused.py; a pinned copy
  and one event wait a k-block call) and ``winner_select``
  (parallel/mesh.py; the round's epilogue over gloo). A call to one is
  the sanctioned sync, and its result is host-origin.

Known limits (docs/static_analysis_torch.md §SYNC): provenance is
per-function (module-local call *names* mark producers; returns propagate
only through tuple unpacking at the call site); attribute access launders
(``res.nonce`` on a ``SearchResult`` is a materialized host field by the
backend contract); values routed through containers lose their tag.

Scope (override key ``sync_files``): ``models/``, ``backend/``,
``parallel/``, ``core/*.py``, ``ops/sha256_cuda.py``, ``utils/``,
``config.py``, ``resilience/dispatch.py``, ``resilience/elastic.py`` —
the host-side sweep loop and the wrapper that launches and reads back the
CUDA sweep.
"""
from __future__ import annotations

import ast
import pathlib

from . import DOC, REPO_PACKAGE, Finding, override_files, package_scope, \
    rel_path
from .callgraph import CallGraph, FuncInfo, call_name, dotted
from .hotpath_lint import ENTRY_POINTS, SANCTIONED_SEAMS

#: Calls whose RESULT is device-origin (by rightmost name).
#: ``search_async`` is the pipeline's future-returning dispatch seam: the
#: future wraps a device value, so touching it with a sync primitive is the
#: same stall — consuming it through ``.result()`` and reading a field
#: (attribute access) launders, per the SearchResult materialized-field
#: contract. ``sweep_launch`` / ``LaunchedSweep`` are a sweep on the card.
DEVICE_PRODUCING_CALLS = {"search", "search_async", "sweep_launch",
                          "LaunchedSweep"}

#: ``search`` sites that are NOT device dispatches (dotted prefixes).
_SEARCH_EXEMPT_PREFIXES = ("re.", "regex.")

#: Receiver name tokens marking a regex object's ``.search`` (the
#: compiled-pattern spelling: ``pat.search(line)``); token-matched on
#: the receiver's rightmost name split on ``_``.
_SEARCH_EXEMPT_RECEIVER_TOKENS = {"re", "regex", "pattern", "pat", "rx",
                                  "matcher"}


def _regex_receiver(d: str) -> bool:
    """True when the dotted receiver of a ``.search`` call reads as a
    compiled regex (``pat.search`` / ``self._tip_pattern.search``)."""
    parts = d.split(".")
    if len(parts) < 2:
        return False
    tokens = set(parts[-2].lower().replace("_", " ").split())
    return bool(tokens & _SEARCH_EXEMPT_RECEIVER_TOKENS)

#: Inner-callee names whose factory-call-then-call shape
#: (``self._fn(k)(...)``) dispatches a built device program.
DEVICE_FACTORIES = {"_fn"}
_FACTORY_PREFIXES = ("make_",)

#: ``torch.<name>(...)`` constructors: device-origin when their
#: ``device=`` keyword is anything but the literal "cpu".
_TORCH_CONSTRUCTORS = {"tensor", "as_tensor", "zeros", "ones", "empty",
                       "full", "arange", "zeros_like", "ones_like",
                       "empty_like", "full_like", "randint", "from_numpy"}

#: Moves onto a device: ``x.to(dev)`` (unless the literal "cpu") and
#: ``x.cuda()``.
_DEVICE_MOVES = {"to", "cuda"}

#: The sanctioned read-back seams: a call is allowed AND its result is
#: host-origin (provenance laundered); their own bodies are pruned.
SANCTIONED_SYNC_FUNCS = {"winner_select", "read_result"}
#: Classes whose methods are the sanctioned read-back (pruned, and a
#: method call on one of their instances launders).
SANCTIONED_SYNC_CLASSES = {"LaunchedSweep", "_Readback"}
#: Calls that return such an instance (a name bound from one is a handle).
_HANDLE_PRODUCERS = {"sweep_launch", "LaunchedSweep", "_Readback"}

#: np-namespace converters that force a D2H copy of a device argument.
_NP_SYNC_DOTTED = {"np.asarray", "np.array", "numpy.asarray",
                   "numpy.array"}
_NP_SYNC_BARE = {"asarray"}          # from-import form; bare array() is
#                                      too generic a name to claim

#: Builtin conversions that force a device scalar to host.
_BUILTIN_SYNCS = {"int", "float", "bool"}

#: Method calls that sync/transfer their receiver.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}

#: Type tests: they read the Python object, never the tensor's data.
_TYPE_TESTS = {"isinstance", "issubclass", "type", "callable", "hasattr"}


def _kw(node: ast.Call, name: str) -> ast.expr | None:
    return next((k.value for k in node.keywords if k.arg == name), None)


def _is_cpu_literal(e: ast.expr | None) -> bool:
    return isinstance(e, ast.Constant) and e.value == "cpu"


def _is_device_producer(node: ast.Call) -> bool:
    name = call_name(node)
    d = dotted(node.func)
    if name in DEVICE_PRODUCING_CALLS:
        if not any(d.startswith(p) for p in _SEARCH_EXEMPT_PREFIXES) \
                and not _regex_receiver(d):
            return True
    if d.startswith("torch.") and d.count(".") == 1 and \
            name in _TORCH_CONSTRUCTORS:
        device = _kw(node, "device")
        return device is not None and not _is_cpu_literal(device)
    if isinstance(node.func, ast.Attribute) and name in _DEVICE_MOVES:
        if name == "cuda":
            return True
        target = node.args[0] if node.args else _kw(node, "device")
        return target is not None and not _is_cpu_literal(target)
    if isinstance(node.func, ast.Call):
        inner = call_name(node.func)
        if inner in DEVICE_FACTORIES or \
                any(inner.startswith(p) for p in _FACTORY_PREFIXES):
            return True
    return False


class _Provenance:
    """One function's flow-sensitive taint walk (statement order, loop
    bodies twice for loop-carried taint, nested defs inline with
    ``nonlocal`` writeback)."""

    def __init__(self, rel: str, chain: str, sink: set):
        self.rel = rel
        self.chain = chain
        #: names bound to a read-back seam's instance in this function
        self.handles: set[str] = set()
        self.sink = sink          # {(line, rule, detail)} — dedup across
        #                           the two passes and shared scopes

    # -- findings ----------------------------------------------------------

    def _flag(self, node: ast.AST, rule: str, detail: str) -> None:
        self.sink.add((self.rel, node.lineno, rule, detail, self.chain))

    # -- expression taint (side effect: sync-site detection) ---------------

    def taint(self, e: ast.expr | None, env: set[str]) -> bool:
        if e is None or isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Name):
            return e.id in env
        if isinstance(e, ast.Attribute):
            # Attribute access LAUNDERS: the backend contract's
            # SearchResult fields are materialized host values (known
            # limit — see module docstring). Still visit the receiver
            # so sync sites inside it are seen.
            self.taint(e.value, env)
            return False
        if isinstance(e, ast.Subscript):
            t = self.taint(e.value, env)
            self.taint(e.slice, env)
            return t
        if isinstance(e, ast.BinOp):
            lt = self.taint(e.left, env)
            rt = self.taint(e.right, env)
            return lt or rt
        if isinstance(e, ast.UnaryOp):
            return self.taint(e.operand, env)
        if isinstance(e, ast.BoolOp):
            return any([self.taint(v, env) for v in e.values])
        if isinstance(e, ast.Compare):
            parts = [self.taint(e.left, env)] + \
                [self.taint(c, env) for c in e.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                # Identity checks (`res is None`) compare object
                # identity on the host — they never materialize a
                # device value, so they are not a sync and branching
                # on them is safe.
                return False
            return any(parts)
        if isinstance(e, ast.IfExp):
            if self.taint(e.test, env):
                self._flag(e.test, "SYNC002", "ternary test")
            bt = self.taint(e.body, env)
            ot = self.taint(e.orelse, env)
            return bt or ot
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any([self.taint(x, env) for x in e.elts])
        if isinstance(e, ast.Dict):
            return any([self.taint(v, env)
                        for v in list(e.keys) + list(e.values)
                        if v is not None])
        if isinstance(e, ast.Starred):
            return self.taint(e.value, env)
        if isinstance(e, ast.JoinedStr):
            for v in e.values:
                if isinstance(v, ast.FormattedValue) and \
                        self.taint(v.value, env):
                    self._flag(v, "SYNC001",
                               "device value formatted into a string "
                               "(forces materialization)")
            return False
        if isinstance(e, ast.Lambda):
            # Evaluate the body for sync sites with the current env;
            # the lambda's own params are unknown (untainted).
            inner = env - {a.arg for a in e.args.args}
            self.taint(e.body, inner)
            return False
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            inner = set(env)
            for gen in e.generators:
                it_t = self.taint(gen.iter, inner)
                if it_t:
                    self._flag(gen.iter, "SYNC002",
                               "device array driving Python iteration")
                for n in ast.walk(gen.target):
                    if isinstance(n, ast.Name):
                        inner.add(n.id) if it_t else inner.discard(n.id)
                for cond in gen.ifs:
                    if self.taint(cond, inner):
                        self._flag(cond, "SYNC002", "comprehension filter")
            if isinstance(e, ast.DictComp):
                kt = self.taint(e.key, inner)
                vt = self.taint(e.value, inner)
                return kt or vt
            return self.taint(e.elt, inner)
        if isinstance(e, ast.Call):
            return self._call(e, env)
        # Structural fallback: any tainted child expression taints.
        return any([self.taint(c, env) for c in ast.iter_child_nodes(e)
                    if isinstance(c, ast.expr)])

    def _call(self, node: ast.Call, env: set[str]) -> bool:
        name = call_name(node)
        d = dotted(node.func)
        arg_taints = [self.taint(a, env) for a in node.args] + \
            [self.taint(k.value, env) for k in node.keywords]
        any_tainted = any(arg_taints)
        # The sanctioned seam: allowed, and the result is host-origin.
        if name in SANCTIONED_SYNC_FUNCS or name in _TYPE_TESTS:
            return False
        if isinstance(node.func, ast.Attribute) and (
                (isinstance(node.func.value, ast.Name)
                 and node.func.value.id in self.handles)
                or (isinstance(node.func.value, ast.Call)
                    and call_name(node.func.value) in _HANDLE_PRODUCERS)):
            # A method of a read-back seam's instance (the sweep's
            # .result(), the fused call's .wait()).
            if isinstance(node.func.value, ast.Call):
                self._call(node.func.value, env)
            return False
        # Explicit sync: always a pipeline stall on the hot path
        # (torch.cuda.synchronize(), event.synchronize(),
        # stream.synchronize()).
        if isinstance(node.func, ast.Attribute) and \
                name == "synchronize":
            self.taint(node.func.value, env)
            self._flag(node, "SYNC001", f"{d or name}()")
            return False
        recv_tainted = (isinstance(node.func, ast.Attribute)
                        and self.taint(node.func.value, env))
        if isinstance(node.func, ast.Attribute) and name in _SYNC_METHODS \
                and recv_tainted:
            self._flag(node, "SYNC001", f".{name}()")
            return False
        if isinstance(node.func, ast.Name) and name in _BUILTIN_SYNCS \
                and any_tainted:
            self._flag(node, "SYNC001", f"{name}()")
            return False
        if (d in _NP_SYNC_DOTTED
                or (isinstance(node.func, ast.Name)
                    and name in _NP_SYNC_BARE)) and any_tainted:
            self._flag(node, "SYNC001", d or name)
            return False
        if _is_device_producer(node):
            if isinstance(node.func, ast.Call):
                self._call(node.func, env)
            return True
        # Unknown call: conservative propagation — a device value
        # threaded through a helper stays device until the seam.
        return any_tainted or recv_tainted


    # -- statements --------------------------------------------------------

    def _bind(self, target: ast.expr, tainted: bool, env: set[str]) -> None:
        if isinstance(target, ast.Name):
            env.add(target.id) if tainted else env.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tainted, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted, env)
        else:
            # self.attr / x[i] targets: visit for sync sites only.
            self.taint(target, env)

    def exec_block(self, stmts: list[ast.stmt], env: set[str]) -> None:
        for s in stmts:
            self._stmt(s, env)

    def _stmt(self, s: ast.stmt, env: set[str]) -> None:
        if isinstance(s, ast.Assign):
            t = self.taint(s.value, env)
            for target in s.targets:
                self._bind(target, t, env)
            handle = isinstance(s.value, ast.Call) and \
                call_name(s.value) in _HANDLE_PRODUCERS
            for target in s.targets:
                if isinstance(target, ast.Name):
                    (self.handles.add if handle
                     else self.handles.discard)(target.id)
        elif isinstance(s, ast.AnnAssign):
            t = self.taint(s.value, env) if s.value is not None else False
            self._bind(s.target, t, env)
        elif isinstance(s, ast.AugAssign):
            t = self.taint(s.value, env) or \
                (isinstance(s.target, ast.Name) and s.target.id in env)
            self._bind(s.target, t, env)
        elif isinstance(s, ast.If):
            if self.taint(s.test, env):
                self._flag(s.test, "SYNC002", "if test")
            then_env, else_env = set(env), set(env)
            self.exec_block(s.body, then_env)
            self.exec_block(s.orelse, else_env)
            env.clear()
            env.update(then_env | else_env)
        elif isinstance(s, ast.While):
            if self.taint(s.test, env):
                self._flag(s.test, "SYNC002", "while test")
            for _ in range(2):          # loop-carried taint
                self.exec_block(s.body, env)
                if self.taint(s.test, env):
                    self._flag(s.test, "SYNC002", "while test")
            self.exec_block(s.orelse, env)
        elif isinstance(s, ast.For):
            it = self.taint(s.iter, env)
            if it:
                self._flag(s.iter, "SYNC002",
                           "device array driving Python iteration")
            self._bind(s.target, it, env)
            for _ in range(2):          # loop-carried taint
                self.exec_block(s.body, env)
            self.exec_block(s.orelse, env)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.taint(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, False, env)
            self.exec_block(s.body, env)
        elif isinstance(s, ast.Try):
            self.exec_block(s.body, env)
            for h in s.handlers:
                self.exec_block(h.body, env)
            self.exec_block(s.orelse, env)
            self.exec_block(s.finalbody, env)
        elif isinstance(s, ast.Assert):
            if self.taint(s.test, env):
                self._flag(s.test, "SYNC002", "assert test")
        elif isinstance(s, (ast.Return, ast.Expr)):
            self.taint(getattr(s, "value", None), env)
        elif isinstance(s, ast.Raise):
            self.taint(s.exc, env)
            self.taint(s.cause, env)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    env.discard(t.id)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Closure/thread-body idiom: the nested body runs with a
            # copy of the enclosing taint; names it declares nonlocal
            # and taints flow BACK (the `nonlocal res; res =
            # backend.search(...)` shape the fused dispatcher uses).
            nonlocals: set[str] = set()
            for n in ast.walk(s):
                if isinstance(n, ast.Nonlocal):
                    nonlocals.update(n.names)
            params = {a.arg for a in s.args.args + s.args.posonlyargs
                      + s.args.kwonlyargs}
            inner = set(env) - params
            self.exec_block(s.body, inner)
            for name in nonlocals:
                if name in inner:
                    env.add(name)
        else:
            for e in ast.iter_child_nodes(s):
                if isinstance(e, ast.expr):
                    self.taint(e, env)


def _scoped_files(root: pathlib.Path) -> list[pathlib.Path]:
    return package_scope(
        root, subdirs=("models", "backend", "parallel", "utils"),
        extras=("config.py", "ops/sha256_cuda.py", "resilience/dispatch.py",
                "resilience/elastic.py"),
        core_glob=True)


def _pruned(info: FuncInfo) -> bool:
    mod = info.module.replace("\\", "/")
    if any(mod.startswith(seam) for seam in SANCTIONED_SEAMS):
        return True
    # The read-back seams' own bodies ARE the sanctioned sync.
    return info.name in SANCTIONED_SYNC_FUNCS or \
        info.cls in SANCTIONED_SYNC_CLASSES


_MESSAGES = {
    "SYNC001": ("implicit host sync '{detail}' on a device-origin value, "
                "reachable on the dispatch hot path via {chain} — the "
                "host stalls until the card drains, serializing the "
                "sweep pipeline; read back through a sanctioned seam "
                "(LaunchedSweep.result, _Readback, winner_select), or "
                "move the touch off the critical path "
                f"({DOC} §SYNC)"),
    "SYNC002": ("device-origin value escapes into Python control flow "
                "({detail}) via {chain} — branching forces a blocking "
                "sync; keep the decision on the card or branch on a "
                "value read back at a sanctioned seam "
                f"({DOC} §SYNC)"),
}


def run_sync_lint(root: pathlib.Path, overrides=None,
                  notes=None) -> list[Finding]:
    files = override_files(overrides, "sync_files",
                           lambda: _scoped_files(root))
    graph, errors = CallGraph.from_files(root, files)
    findings: list[Finding] = [
        Finding(rel, lineno, "SYNC000", f"syntax error: {msg}")
        for rel, lineno, msg in errors]

    anchor = (rel_path(files[0], root) if files else REPO_PACKAGE)
    roots, missing = graph.resolve_roots(ENTRY_POINTS)
    for cls, method in missing:
        findings.append(Finding(
            anchor, 1, "SYNC003",
            f"hot-path entry point {cls}.{method} not found in the "
            f"analyzed file set — the device-sync lint is checking "
            f"nothing for it; update ENTRY_POINTS in "
            f"analysis/hotpath_lint.py (the shared root set) alongside "
            f"the rename ({DOC} §SYNC)"))

    chains = graph.reachable(roots, prune=_pruned)
    parents = graph.nested_parents()

    def covered_inline(qual: str) -> bool:
        # A nested def is analyzed inline by its enclosing function —
        # but only when SOME ancestor is itself reachable; a reachable
        # closure in unreachable setup code still needs its own walk.
        p = parents.get(qual)
        while p is not None:
            if p in chains:
                return True
            p = parents.get(p)
        return False

    sink: set = set()
    for qual in sorted(chains):
        if covered_inline(qual):
            continue
        info = graph.functions[qual]
        walker = _Provenance(info.module, " -> ".join(chains[qual]), sink)
        env: set[str] = set()
        # Two passes over the body: taint discovered late in pass 1
        # (a loop-carried or closure-written name) is live from the
        # top in pass 2; the sink set dedups the findings.
        for _ in range(2):
            walker.exec_block(info.node.body, env)
    for rel, lineno, rule, detail, chain in sorted(sink):
        findings.append(Finding(
            rel, lineno, rule,
            _MESSAGES[rule].format(detail=detail, chain=chain)))
    return findings
