"""SHD003 — rank-divergent values into the sizes and round counts of a world.

The counterpart of the reference's ``shard_lint`` SHD003
(``mpi_blockchain_tpu.analysis.shard_lint``), read for ``torch.distributed``.
A world of the port is SPMD (``spmd_lint``): every rank must enter the same
gloo collectives, in the same order, with tensors of the same size. A value
that differs between ranks — the rank itself — is fine in host arithmetic
(a stripe's offset is the whole point of ranked mining), but not where it
sets the size of a tensor that enters a collective, or the number of rounds
of a loop that enters one: a rank with one round more enters an all-reduce
alone and waits there until gloo's timeout. The hang shows only in a world
of several ranks, never in a one-process test.

  SHD003  a rank-divergent value flowing into
          (a) the size of ``torch.zeros/ones/full/empty/arange/
              broadcast_to`` (first positional argument, or ``size=``/
              ``shape=``), or of their ``np``/``numpy`` spellings;
          (b) the arguments of ``.reshape()`` or ``.view()``;
          (c) the trip count of a ``for ... in range(...)`` whose body
              enters a collective: a ``torch.distributed`` collective or a
              rendezvous of ``spmd_lint`` (``winner_select``,
              ``init_distributed``, ...), or a module-local function that
              calls one — the port's counterpart of the reference's
              "traced work".

Producers: the reference's ``process_index``, ``mesh_rank``,
``process_id`` and ``<world/elastic>.index()`` (``self.index()`` inside a
class whose name says world or elastic, ``ElasticWorld``), and torch's
spelling of the rank, ``get_rank`` (``dist.get_rank(group)``), which the
reference's vocabulary lacks. A name assigned from an expression holding a
producer is rank-divergent too, to a fixed point.

Provenance limit (the reference's, deliberate): the taint is per function,
with no threading of arguments across calls. A rank computed in one
function and handed to another that loops over it is invisible — the shape
of ``make_fused_miner`` and ``_WorldCall`` (``models/fused.py``), whose
round plan ``world_slices`` gives every rank the same number of rounds and
is held to that by a property test (``tests/test_torch_shard_lint.py``).

Not ported: SHD001 (``shard_map`` spec arity), SHD002 (a collective with no
axis context) and SHD004 (the ``shard_map`` import seam) read ``shard_map``,
which the port does not have; SHD003's static-argument sink reads traced
functions with static arguments, which the port does not have either.

Scope: the SPMD pass's (``parallel/``, ``tools/``, ``models/fused.py``,
``models/miner.py``, ``backend/cuda.py``, ``cli.py``) plus the elastic file
``resilience/elastic.py``; override key ``shard_files``. SHD000 reports a
file that does not parse.
"""
from __future__ import annotations

import ast
import pathlib

from . import Finding, override_files, rel_path, source_cached
from .callgraph import call_name, dotted
from .spmd_lint import (_collective_funcs, _default_elastic_files,
                        _scoped_files, _Vocabulary)

_RANK_CALLS = {"process_index", "mesh_rank", "process_id", "get_rank"}
_WORLD_TOKENS = ("world", "elastic")
_SHAPE_CTORS = {"zeros", "ones", "full", "empty", "arange", "broadcast_to"}
_ARRAY_NS = ("torch", "np", "numpy")
_SIZE_KEYWORDS = ("size", "shape")
_VIEWS = ("reshape", "view")


def _default_files(root: pathlib.Path) -> list[pathlib.Path]:
    return _scoped_files(root) + _default_elastic_files(root)


def _is_rank_producer(call: ast.Call, cls: str | None) -> str | None:
    name = call_name(call)
    if name in _RANK_CALLS:
        return dotted(call.func) or name
    if name == "index" and isinstance(call.func, ast.Attribute):
        recv = dotted(call.func.value)
        owner = (cls or "") if recv == "self" else recv
        if any(tok in owner.lower() for tok in _WORLD_TOKENS):
            return dotted(call.func)
    return None


def rank_producers(tree: ast.Module) -> list[tuple[int, str]]:
    """(line, spelling) of every rank-divergent producer call in a module:
    what the pass's taint starts from."""
    return sorted({(node.lineno, p) for scope, cls in _scopes(tree)
                   for node in _scope_nodes(scope)
                   if isinstance(node, ast.Call)
                   and (p := _is_rank_producer(node, cls))})


def _scopes(tree: ast.Module) -> list[tuple[ast.AST, str | None]]:
    """The module and every function in it, each with the name of the class
    that holds it directly (for ``self.index()``)."""
    out: list[tuple[ast.AST, str | None]] = [(tree, None)]

    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, cls))
                walk(child, None)
            else:
                walk(child, cls)

    walk(tree, None)
    return out


def _scope_nodes(scope: ast.AST):
    """The nodes a scope's pass reads, as the reference's: a function's
    whole body, nested functions included (a closure sees the outer
    taint); the module's statements outside every function."""
    if not isinstance(scope, ast.Module):
        yield from ast.walk(scope)
        return
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _assigned(target: ast.expr) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for t in target.elts for n in _assigned(t)]
    return []


def _tainted_names(scope: ast.AST, cls: str | None) -> set[str]:
    """Names a scope assigns (transitively) from a rank-divergent producer —
    per function, the reference's provenance limit."""
    assigns: list[tuple[list[str], ast.expr]] = []
    for n in _scope_nodes(scope):
        if isinstance(n, ast.Assign):
            names = [x for t in n.targets for x in _assigned(t)]
            if names:
                assigns.append((names, n.value))
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)) \
                and n.value is not None:
            assigns.append((_assigned(n.target), n.value))
    tainted: set[str] = set()
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if names and not set(names) <= tainted and \
                    _source(value, tainted, cls):
                tainted |= set(names)
                changed = True
    return tainted


def _source(expr: ast.expr | None, tainted: set[str],
            cls: str | None) -> str | None:
    """The producer or tainted name that makes ``expr`` rank-divergent."""
    if expr is None:
        return None
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            p = _is_rank_producer(sub, cls)
            if p:
                return p
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return sub.id
    return None


def _shd003(rel: str, tree: ast.Module) -> list[Finding]:
    vocab = _Vocabulary(tree)
    entering = _collective_funcs(tree, vocab)
    findings: list[Finding] = []
    seen: set[tuple[int, str]] = set()

    def flag(line: int, msg: str) -> None:
        if (line, msg) not in seen:
            seen.add((line, msg))
            findings.append(Finding(rel, line, "SHD003", msg))

    def enters_collective(loop: ast.For) -> bool:
        return any(isinstance(sub, ast.Call)
                   and (vocab.op(sub) is not None
                        or call_name(sub) in entering)
                   for sub in ast.walk(loop))

    for scope, cls in _scopes(tree):
        tainted = _tainted_names(scope, cls)
        for node in _scope_nodes(scope):
            if isinstance(node, ast.Call):
                name = call_name(node)
                d = dotted(node.func)
                ns = d.rsplit(".", 1)[0] if "." in d else ""
                if name in _SHAPE_CTORS and ns in _ARRAY_NS:
                    cands = list(node.args[:1]) + [
                        kw.value for kw in node.keywords
                        if kw.arg in _SIZE_KEYWORDS]
                    for c in cands:
                        src = _source(c, tainted, cls)
                        if src:
                            flag(node.lineno,
                                 f"rank-divergent value '{src}' flows into "
                                 f"the size of '{d}' — each rank builds a "
                                 f"tensor of another size, and a gloo "
                                 f"collective over it desyncs the world "
                                 f"(a hang until gloo's timeout)")
                elif name in _VIEWS and isinstance(node.func, ast.Attribute):
                    for c in node.args:
                        src = _source(c, tainted, cls)
                        if src:
                            flag(node.lineno,
                                 f"rank-divergent value '{src}' flows into "
                                 f"'.{name}()' — divergent shapes diverge "
                                 f"the tensors the ranks hand to their "
                                 f"collectives (a hang until gloo's "
                                 f"timeout)")
            elif isinstance(node, ast.For) and \
                    isinstance(node.iter, ast.Call) and \
                    call_name(node.iter) == "range":
                src = None
                for a in node.iter.args:
                    src = src or _source(a, tainted, cls)
                if src and enters_collective(node):
                    flag(node.lineno,
                         f"rank-divergent value '{src}' sets the trip count "
                         f"of a loop that enters a collective — ranks run "
                         f"different numbers of rounds, and a rank with one "
                         f"more waits alone in its all-reduce until gloo's "
                         f"timeout; give every rank the same round count "
                         f"and let a rank with no work bring a neutral "
                         f"value (models.fused.world_slices)")
    return findings


def run_shard_lint(root: pathlib.Path, overrides=None,
                   notes=None) -> list[Finding]:
    findings: list[Finding] = []
    for path in override_files(overrides, "shard_files",
                               lambda: _default_files(root)):
        rel = rel_path(path, root)
        try:
            _, tree, err = source_cached(path)
        except OSError:
            continue
        if tree is None:
            findings.append(Finding(rel, err[0], "SHD000",
                                    f"syntax error: {err[1]}"))
            continue
        findings.extend(_shd003(rel, tree))
    return findings
