"""OPB rules — the op-budget ratchet of the port's sweep kernel.

The counterpart of the reference's ``opbudget``: the sweep runs at 0.88 of
its bound on the H100 (PERF.md), so the per-chip speed left is doing
fewer operations a nonce, and nothing else stops a refactor from
re-inflating the loop. The port's budget, ``analysis/OPBUDGET.json``
inside this package (the reference's root ``OPBUDGET.json`` is the
reference's and is never read or written here), pins a **static ALU
census** that this stdlib-only pass recomputes on every run, and the gate
fails when it grows.

The static census is the reference's ``_StaticCensus`` rule read for
CUDA C++: a count of the 32-bit ALU operators on the sweep's per-nonce
path in ``ops/csrc/sha256d_sweep.cu`` — ``sha256d_h01`` (both of its
instantiations count the same) and the device functions it calls
(``expand``, ``rounds``, the sigma, ``ch``, ``maj`` and ``add_on_fma``
helpers), plus ``qualifies``. Each arithmetic, bitwise and compare operator token of a
body counts 1, as does each one-instruction intrinsic
(``__funnelshift_r``, ``__byte_perm``, ...), and a call adds the callee's
census; a ``#pragma unroll`` loop whose bounds are literals multiplies
its body by the trip count, and a bound that is a template parameter
(``kFirst``) takes its value at the call site. Subscripts cost nothing
(the arrays are unrolled into registers). Nothing is folded and no branch
is chosen, so it is a deterministic proxy, not the compiled count: any
edit that adds per-nonce operators raises it. The exact count is the
traced SASS census below.

The nonce-invariant per-template precompute (``extend_midstate`` in
``ops/sha256_sched.py``) is censused apart (``static_host_alu_ops``), with
the reference's AST walker over the same Python function (155 on both
packages' copies), so a hoist out of the kernel reads as a per-nonce
decrease. It is informational, as in the reference.

The physical numbers ride in the budget's ``traced`` section, taken on
the card by the mover (``python -m
mpi_blockchain_tpu_torch.analysis.opbudget --write``, which imports torch
and disassembles the built library; the reference's mover is
``experiments/roofline.py --write-budget``): for each difficulty class the
SASS census of the production kernel's main loop (``loop_census``), its
ALU-only count, the source's adds (``source_adds``), the bound in SM
clocks a nonce, and the ``nvcc`` release that built it. ``--check``
compares the loop census exactly when the release matches, and on
another release fails naming both.

  OPB001  the static ALU census of the kernel source exceeds the
          committed budget — op counts only ratchet DOWN. A justified
          increase goes through the mover and a reviewed OPBUDGET.json
          diff; the CLI's ``--rebaseline`` only accepts a LOWER census.
  OPB002  the port's OPBUDGET.json is missing, unparseable, or lacks
          ``static_alu_ops``/``traced`` — the ratchet is not armed.
  OPB003  a census entry is missing from its source (a rename left the
          gate counting nothing): the kernel's ``sha256d_h01`` and
          ``qualifies`` always, and the host's ``extend_midstate`` when
          the budget carries a host census.

Override keys: ``opbudget_json`` (budget path), ``kernel_src`` (the CUDA
source), ``host_src`` (the per-template precompute) — the drift-fixture
seams.
"""
from __future__ import annotations

import ast
import pathlib
import re

from . import REPO_PACKAGE, Finding, rel_path
from .budget import (int_key_error, read_json_object, refuse_upward,
                     require_amendable, write_json_budget)
from .cparse import extract_function_body, line_of, strip_comments

BASELINE_NAME = "OPBUDGET.json"
#: The port's budget lives in this package, beside the pass that reads it.
BASELINE_PATH = f"{REPO_PACKAGE}/analysis/{BASELINE_NAME}"
MOVER = "python -m mpi_blockchain_tpu_torch.analysis.opbudget --write"
KERNEL_SRC = f"{REPO_PACKAGE}/ops/csrc/sha256d_sweep.cu"
CENSUS_ENTRY = "sha256d_h01"
QUALIFY_ENTRY = "qualifies"
#: The difficulty of the main path (d24: the class below 32 bits), whose
#: loop the card check reports.
CENSUS_DIFFICULTY = 24
HOST_SRC = f"{REPO_PACKAGE}/ops/sha256_sched.py"
HOST_ENTRY = "extend_midstate"
REQUIRED_KEYS = ("static_alu_ops", "traced")
#: One difficulty of each class the kernel is instantiated for
#: (``Mode`` in the source), in class order.
CLASS_DIFFICULTIES = (0, 24, 32, 48, 64)
_UNROLL_CAP = 4096   # unrolled trip counts beyond this count once


# ---- the CUDA C++ census ---------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<pragma>\#[ \t]*pragma[ \t]+unroll\b[^\n]*)
  | (?P<pp>\#[^\n]*)
  | (?P<word>[A-Za-z_]\w*|\d\w*)
  | (?P<op><<=|>>=|->|\+\+|--|<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%&|^]=|::|\S)
""", re.X)

#: Operator tokens that occupy an ALU slot.
_ALU = frozenset({"+", "-", "*", "/", "%", "&", "|", "^", "~", "!", "<<",
                  ">>", "<", ">", "<=", ">=", "==", "!=", "&&", "||", "++",
                  "--", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
                  "<<=", ">>="})
#: Intrinsics that are one ALU instruction each.
_INTRINSICS = frozenset({"__funnelshift_r", "__funnelshift_l",
                         "__byte_perm", "__popc", "__clz", "__brev",
                         "__umulhi", "min", "max"})
#: Words after which ``*`` and ``&`` declare a pointer or a reference, or
#: dereference, rather than multiply or mask.
_NOT_OPERANDS = frozenset({"const", "unsigned", "int", "bool", "auto",
                           "uint32_t", "uint64_t", "return"})
_OPEN = {"(": ")", "[": "]", "{": "}"}
_LOOP = re.compile(r"int (\w+) = (\w+) ; \1 (<=?) (\w+) ; "
                   r"(?:\+\+ \1|\1 \+\+)")

_DEVICE_FN = re.compile(
    r"(?:template\s*<(?P<tparams>[^<>]*)>\s*)?__device__\b[^;{}()]*?"
    r"\b(?P<name>[A-Za-z_]\w*)\s*\(")


def _close(toks: list[tuple[str, str]], i: int) -> int:
    """Index of the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(toks)):
        if toks[j][1] in _OPEN:
            depth += 1
        elif toks[j][1] in _OPEN.values():
            depth -= 1
            if depth == 0:
                return j
    return len(toks) - 1


def _statement_end(toks: list[tuple[str, str]], i: int) -> int:
    """Index of the ``;`` that ends the statement starting at ``i``."""
    j = i
    while j < len(toks) and toks[j][1] != ";":
        j = _close(toks, j) + 1 if toks[j][1] in _OPEN else j + 1
    return min(j, len(toks) - 1)


def _value(word: str, env: dict) -> int | None:
    """An integer literal or a template argument; None otherwise."""
    if word[:1].isdigit():
        try:
            return int(word.rstrip("uUlL"), 0)
        except ValueError:
            return None
    return env.get(word)


class CudaCensus:
    """The static ALU census of device functions of one CUDA source: the
    ALU operator tokens of a function's body, plus the census of each
    device function it calls (see the module docstring)."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        text = strip_comments(path.read_text(errors="replace"))
        #: name -> (template parameter names, definition line)
        self.funcs: dict[str, tuple[list[str], int]] = {}
        for m in _DEVICE_FN.finditer(text):
            tparams = [p.split("=")[0].split()[-1]
                       for p in (m.group("tparams") or "").split(",")
                       if p.strip()]
            self.funcs.setdefault(m.group("name"),
                                  (tparams, line_of(text, m.start("name"))))
        self._memo: dict[tuple, int] = {}

    def func_cost(self, name: str, targs: tuple = ()) -> int | None:
        """The census of one call of ``name`` with template arguments
        ``targs``; None when there is no such device function."""
        key = (name, targs)
        if name not in self.funcs:
            return None
        if key not in self._memo:
            self._memo[key] = 0   # a recursive call counts nothing
            body = extract_function_body(
                self.path, rf"__device__\b[^;{{}}()]*?\b{name}\s*\(")
            toks = [(m.lastgroup, m.group()) for m in _TOKEN.finditer(body)
                    if m.lastgroup != "pp"]
            self._memo[key] = self._cost(
                toks, dict(zip(self.funcs[name][0], targs)))
        return self._memo[key]

    def _cost(self, toks: list[tuple[str, str]], env: dict) -> int:
        total, i = 0, 0
        while i < len(toks):
            kind, text = toks[i]
            nxt = toks[i + 1][1] if i + 1 < len(toks) else ""
            if kind == "pragma" and nxt == "for":
                head = _close(toks, i + 2)
                end = (_close(toks, head + 1) if toks[head + 1][1] == "{"
                       else _statement_end(toks, head + 1))
                trips = self._trips(toks[i + 3:head], env)
                if trips is None:
                    total += self._cost(toks[i + 1:end + 1], env)
                else:
                    total += trips * self._cost(toks[head + 1:end + 1], env)
                i = end + 1
                continue
            if text == "[":   # a subscript of an unrolled array: folded
                i = _close(toks, i) + 1
                continue
            if kind == "word" and text in self.funcs:
                targs = ()
                if nxt == "<":
                    shut = next((j for j in range(i + 2, len(toks))
                                 if toks[j][1] == ">"), len(toks))
                    targs = tuple(_value(t, env)
                                  for _, t in toks[i + 2:shut:2])
                    i = shut
                total += self.func_cost(text, targs)
            elif kind == "word" and text in _INTRINSICS and nxt == "(":
                total += 1
            elif kind == "op" and text in _ALU:
                before = toks[i - 1] if i else ("op", "")
                binary = (before[0] == "word" and
                          before[1] not in _NOT_OPERANDS) or \
                    before[1] in (")", "]")
                total += binary or text not in ("*", "&")
            i += 1
        return total

    @staticmethod
    def _trips(head: list[tuple[str, str]], env: dict) -> int | None:
        """Trips of a ``for (int r = A; r < B; ++r)`` header whose bounds
        are literals or template arguments; None otherwise."""
        m = _LOOP.fullmatch(" ".join(t for _, t in head))
        if m is None:
            return None
        lo, hi = _value(m.group(2), env), _value(m.group(4), env)
        if lo is None or hi is None:
            return None
        trips = max(0, hi - lo + (m.group(3) == "<="))
        return trips if trips <= _UNROLL_CAP else None


def static_kernel_census(src: pathlib.Path) -> dict[str, int] | None:
    """{``sha256d_h01``: census, ``qualifies``: census} of the per-nonce
    path, or None when an entry is absent. Raises OSError for an
    unreadable source."""
    return _kernel_parts(CudaCensus(src))


def _kernel_parts(census: CudaCensus) -> dict[str, int] | None:
    h01 = census.func_cost(CENSUS_ENTRY)
    test = census.func_cost(QUALIFY_ENTRY)
    if h01 is None or test is None:
        return None
    return {CENSUS_ENTRY: h01, QUALIFY_ENTRY: test}


def difficulty_class(difficulty_bits: int) -> int:
    """The kernel's ``Mode`` for a difficulty (as
    ``ops.sha256_cuda.difficulty_class``, kept here so the gate imports
    no torch)."""
    d = int(difficulty_bits)
    return 0 if d <= 0 else 1 if d < 32 else 2 if d == 32 else \
        3 if d < 64 else 4


# ---- the host census: the reference's AST walker ---------------------------

#: Operators that occupy an ALU slot (the ratchet counts these).
_ALU_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
            ast.Pow, ast.LShift, ast.RShift, ast.BitAnd, ast.BitOr,
            ast.BitXor)
#: The kernels' variadic folded-sum helper: a call costs len(args) - 1.
_FOLDED_SUM_FNS = ("_usum",)


class _StaticCensus:
    """Weighted AST ALU-op counter with literal-range unrolling: the
    reference's host census (``mpi_blockchain_tpu.analysis.opbudget``),
    kept here so the port imports nothing of the reference."""

    def __init__(self, tree: ast.Module):
        self.funcs: dict[str, ast.FunctionDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs.setdefault(node.name, node)
        self._memo: dict[str, int] = {}
        self._stack: set[str] = set()

    def _eval(self, e: ast.expr, env: dict):
        """int/bool value, or None when not statically known."""
        if isinstance(e, ast.Constant) and isinstance(e.value, (int, bool)):
            return e.value
        if isinstance(e, ast.Name):
            return env.get(e.id)
        if isinstance(e, ast.UnaryOp):
            v = self._eval(e.operand, env)
            if v is None:
                return None
            if isinstance(e.op, ast.USub):
                return -v
            if isinstance(e.op, ast.Not):
                return not v
            if isinstance(e.op, ast.Invert):
                return ~v
            return None
        if isinstance(e, ast.BinOp):
            lo, hi = self._eval(e.left, env), self._eval(e.right, env)
            if lo is None or hi is None:
                return None
            try:
                return {
                    ast.Add: lambda: lo + hi, ast.Sub: lambda: lo - hi,
                    ast.Mult: lambda: lo * hi,
                    ast.FloorDiv: lambda: lo // hi,
                    ast.Mod: lambda: lo % hi,
                    ast.LShift: lambda: lo << hi,
                    ast.RShift: lambda: lo >> hi,
                    ast.BitAnd: lambda: lo & hi,
                    ast.BitOr: lambda: lo | hi,
                    ast.BitXor: lambda: lo ^ hi,
                }[type(e.op)]()
            except (KeyError, ZeroDivisionError, ValueError):
                return None
        if isinstance(e, ast.Compare) and len(e.ops) == 1:
            lo = self._eval(e.left, env)
            hi = self._eval(e.comparators[0], env)
            if lo is None or hi is None:
                return None
            table = {ast.Lt: lambda: lo < hi, ast.LtE: lambda: lo <= hi,
                     ast.Gt: lambda: lo > hi, ast.GtE: lambda: lo >= hi,
                     ast.Eq: lambda: lo == hi,
                     ast.NotEq: lambda: lo != hi}
            fn = table.get(type(e.ops[0]))
            return fn() if fn else None
        return None

    def _range_values(self, it: ast.expr, env: dict) -> list[int] | None:
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords
                and 1 <= len(it.args) <= 3):
            return None
        vals = [self._eval(a, env) for a in it.args]
        if any(v is None for v in vals):
            return None
        try:
            values = list(range(*vals))
        except (TypeError, ValueError):
            return None
        return values if len(values) <= _UNROLL_CAP else None

    def func_cost(self, name: str) -> int | None:
        if name in self._memo:
            return self._memo[name]
        fn = self.funcs.get(name)
        if fn is None or name in self._stack:
            return None
        self._stack.add(name)
        cost = self._block(fn.body, {})
        self._stack.discard(name)
        self._memo[name] = cost
        return cost

    def _block(self, stmts: list[ast.stmt], env: dict) -> int:
        return sum(self._stmt(s, env) for s in stmts)

    def _stmt(self, s: ast.stmt, env: dict) -> int:
        if isinstance(s, ast.For):
            values = self._range_values(s.iter, env)
            if values is not None and isinstance(s.target, ast.Name):
                return sum(self._block(
                    s.body, {**env, s.target.id: v}) for v in values)
            return self._expr(s.iter, env) + self._block(s.body, env) \
                + self._block(s.orelse, env)
        if isinstance(s, ast.While):
            return self._expr(s.test, env) + self._block(s.body, env)
        if isinstance(s, ast.If):
            test = self._eval(s.test, env)
            if test is True:
                return self._block(s.body, env)
            if test is False:
                return self._block(s.orelse, env)
            return self._expr(s.test, env) + max(
                self._block(s.body, env), self._block(s.orelse, env))
        if isinstance(s, ast.Assign):
            return self._expr(s.value, env) + sum(
                self._expr(t, env) for t in s.targets)
        if isinstance(s, ast.AugAssign):
            alu = 1 if isinstance(s.op, _ALU_OPS) else 0
            return alu + self._expr(s.value, env) + \
                self._expr(s.target, env)
        if isinstance(s, ast.AnnAssign):
            return self._expr(s.value, env) if s.value else 0
        if isinstance(s, (ast.Return, ast.Expr)):
            return self._expr(s.value, env) if s.value is not None else 0
        if isinstance(s, ast.With):
            return sum(self._expr(i.context_expr, env)
                       for i in s.items) + self._block(s.body, env)
        if isinstance(s, ast.Try):
            return (self._block(s.body, env)
                    + sum(self._block(h.body, env) for h in s.handlers)
                    + self._block(s.orelse, env)
                    + self._block(s.finalbody, env))
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Import, ast.ImportFrom,
                          ast.Pass, ast.Global, ast.Nonlocal)):
            return 0
        return sum(self._expr(e, env) for e in ast.iter_child_nodes(s)
                   if isinstance(e, ast.expr))

    def _expr(self, e: ast.expr | None, env: dict) -> int:
        if e is None:
            return 0
        if isinstance(e, ast.BinOp):
            alu = 1 if isinstance(e.op, _ALU_OPS) else 0
            return alu + self._expr(e.left, env) + \
                self._expr(e.right, env)
        if isinstance(e, ast.BoolOp):
            return (len(e.values) - 1) + sum(
                self._expr(v, env) for v in e.values)
        if isinstance(e, ast.Compare):
            return len(e.ops) + self._expr(e.left, env) + sum(
                self._expr(c, env) for c in e.comparators)
        if isinstance(e, ast.UnaryOp):
            alu = 1 if isinstance(e.op, (ast.Invert, ast.USub)) else 0
            return alu + self._expr(e.operand, env)
        if isinstance(e, ast.IfExp):
            test = self._eval(e.test, env)
            if test is True:
                return self._expr(e.body, env)
            if test is False:
                return self._expr(e.orelse, env)
            return self._expr(e.test, env) + max(
                self._expr(e.body, env), self._expr(e.orelse, env))
        if isinstance(e, ast.Call):
            cost = sum(self._expr(a, env) for a in e.args) + sum(
                self._expr(k.value, env) for k in e.keywords)
            if isinstance(e.func, ast.Name):
                if e.func.id in _FOLDED_SUM_FNS:
                    return cost + max(0, len(e.args) - 1)
                inner = self.func_cost(e.func.id)
                if inner is not None:
                    cost += inner
            return cost + self._expr(e.func, env)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            gens = e.generators
            if len(gens) == 1 and isinstance(gens[0].target, ast.Name) \
                    and not gens[0].ifs:
                values = self._range_values(gens[0].iter, env)
                if values is not None:
                    return sum(self._expr(
                        e.elt, {**env, gens[0].target.id: v})
                        for v in values)
            return self._expr(e.elt, env) + sum(
                self._expr(g.iter, env) for g in gens)
        return sum(self._expr(c, env) for c in ast.iter_child_nodes(e)
                   if isinstance(c, ast.expr))


def static_alu_census(src: pathlib.Path,
                      entry: str = HOST_ENTRY) -> int | None:
    """The reference's weighted static ALU count of a Python function
    (``entry`` and what it calls module-locally), or None when it is
    absent. Raises SyntaxError/OSError for an unreadable source."""
    tree = ast.parse(src.read_text(), filename=str(src))
    return _StaticCensus(tree).func_cost(entry)


# ---- the gate --------------------------------------------------------------


def _paths(root: pathlib.Path, overrides: dict
           ) -> tuple[pathlib.Path, pathlib.Path, pathlib.Path]:
    baseline = pathlib.Path(overrides.get("opbudget_json",
                                          root / BASELINE_PATH))
    src = pathlib.Path(overrides.get("kernel_src", root / KERNEL_SRC))
    host = pathlib.Path(overrides.get("host_src", root / HOST_SRC))
    return baseline, src, host


def load_baseline(baseline: pathlib.Path) -> tuple[dict | None, str]:
    """(budget dict, error message) — dict None iff invalid."""
    data, err = read_json_object(baseline)
    if data is None:
        return None, err
    err = int_key_error(data, baseline.name, "static_alu_ops", MOVER,
                        positive=True)
    if err:
        return None, err
    if not isinstance(data.get("traced"), dict):
        return None, (f"{baseline.name} lacks the 'traced' SASS loop "
                      f"census taken on the card — regenerate it with "
                      f"`{MOVER}`")
    return data, ""


def run_opbudget(root: pathlib.Path, overrides=None,
                 notes=None) -> list[Finding]:
    overrides = overrides or {}
    baseline_path, src, host_src = _paths(root, overrides)
    baseline, err = load_baseline(baseline_path)
    if baseline is None:
        return [Finding(rel_path(baseline_path, root), 1, "OPB002",
                        f"op-budget ratchet is not armed: {err}")]
    src_rel = rel_path(src, root)
    try:
        census = CudaCensus(src)
        parts = _kernel_parts(census)
    except OSError as e:
        return [Finding(src_rel, 1, "OPB003",
                        f"kernel source unreadable: {e}")]
    if parts is None:
        return [Finding(src_rel, 1, "OPB003",
                        f"census entries '{CENSUS_ENTRY}' and "
                        f"'{QUALIFY_ENTRY}' not both found in {src.name} — "
                        f"the op-budget gate is counting nothing; update "
                        f"CENSUS_ENTRY in analysis/opbudget.py alongside "
                        f"the rename")]
    findings: list[Finding] = []
    # The per-template precompute: counted apart so a hoist out of the
    # kernel is a per-nonce decrease, never moved-ops noise. A budget that
    # CLAIMS a host census while the entry is gone was disarmed by a
    # rename.
    if isinstance(baseline.get("static_host_alu_ops"), int):
        host_rel = rel_path(host_src, root)
        try:
            host_cost = static_alu_census(host_src, HOST_ENTRY)
        except (OSError, SyntaxError) as e:
            findings.append(Finding(host_rel, 1, "OPB003",
                                    f"host census source unreadable: {e}"))
        else:
            if host_cost is None:
                findings.append(Finding(
                    host_rel, 1, "OPB003",
                    f"host census entry '{HOST_ENTRY}' not found in "
                    f"{host_src.name} but the committed budget carries "
                    f"static_host_alu_ops — update HOST_ENTRY in "
                    f"analysis/opbudget.py alongside the rename"))
            elif notes is not None and \
                    host_cost != baseline["static_host_alu_ops"]:
                notes.append(
                    f"opbudget: host per-template census {host_cost} "
                    f"differs from the committed "
                    f"{baseline['static_host_alu_ops']} — refresh it with "
                    f"`{MOVER}`")
    current = sum(parts.values())
    budget = baseline["static_alu_ops"]
    if current > budget:
        findings.append(Finding(
            src_rel, census.funcs[CENSUS_ENTRY][1], "OPB001",
            f"static ALU op census grew: {current} > budget {budget} "
            f"({', '.join(f'{k} {v}' for k, v in parts.items())}). The "
            f"op count of the sweep's per-nonce path only ratchets DOWN; "
            f"if this increase is justified, re-census on the card with "
            f"`{MOVER}` and commit the {BASELINE_PATH} diff"))
    elif current < budget and notes is not None:
        notes.append(f"opbudget: static census {current} is below the "
                     f"budget {budget} — ratchet it down with "
                     f"--rebaseline (or the --write mover)")
    return findings


def rebaseline(root: pathlib.Path,
               overrides=None) -> tuple[int, int, pathlib.Path]:
    """Writes the current static census into the budget, refusing to
    RAISE it (the ratchet). Returns (old, new, path). Raises ValueError
    when the census is higher, an entry is missing, or there is no valid
    budget to amend — a missing or corrupt budget is bootstrapped by the
    mover on the card, which takes the traced census too."""
    baseline_path, _, _ = _paths(root, overrides or {})
    static = static_section(root, overrides)
    old_data, err = load_baseline(baseline_path)
    old_data = require_amendable(old_data, err, MOVER)
    old, current = old_data["static_alu_ops"], static["static_alu_ops"]
    refuse_upward(current, old, census_label="static census",
                  policy="The op budget only ratchets down",
                  mover=MOVER, baseline_name=BASELINE_NAME)
    write_json_budget(baseline_path, {**old_data, **static})
    return old, current, baseline_path


def static_section(root: pathlib.Path, overrides=None) -> dict:
    """The budget's static keys, as the gate computes them. Raises
    ValueError when an entry is missing (OSError/SyntaxError for an
    unreadable source)."""
    _, src, host_src = _paths(root, overrides or {})
    parts = static_kernel_census(src)
    host = static_alu_census(host_src, HOST_ENTRY)
    if parts is None or host is None:
        raise ValueError(f"census entries '{CENSUS_ENTRY}', "
                         f"'{QUALIFY_ENTRY}' ({src.name}) and "
                         f"'{HOST_ENTRY}' ({host_src.name}) not all found "
                         f"— nothing to baseline")
    return {
        "census_entry": CENSUS_ENTRY,
        "host_census_entry": HOST_ENTRY,
        "host_source": rel_path(host_src, root),
        "source": rel_path(src, root),
        "static_alu_ops": sum(parts.values()),
        "static_components": parts,
        "static_host_alu_ops": host,
    }


# ---- the mover (imports torch, needs the card; never run by the gate) ------


def nvcc_release(nvcc: str) -> str:
    """``nvcc --version``'s release line's version (``12.8, V12.8.93``)."""
    import subprocess

    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    m = re.search(r"release ([^\n]+)", out)
    if m is None:
        raise ValueError(f"no release in nvcc --version: {out[-200:]}")
    return m.group(1).strip()


def trace_loop_census() -> dict:
    """The SASS census of the production sweep's main loop for each
    difficulty class, from the library built in this checkout, with the
    release of the ``nvcc`` that built it. Needs the CUDA toolkit (the
    library's build and ``cuobjdump``); refuses to run without a card, so
    no CPU run ever writes this section."""
    import torch

    from ..ops import sha256_cuda

    if not torch.cuda.is_available():
        raise ValueError("the traced op census is taken on a CUDA device, "
                         "and there is none here")
    nvcc = sha256_cuda.find_nvcc()
    if nvcc is None:
        raise ValueError("no nvcc: the traced op census needs the built "
                         "kernel library")
    sass = sha256_cuda.disassemble(sha256_cuda.build())
    classes = {}
    for d in CLASS_DIFFICULTIES:
        census = sha256_cuda.loop_census(sass, d)
        adds = sha256_cuda.source_adds(d)
        classes[str(sha256_cuda.difficulty_class(d))] = {
            "alu_only": sha256_cuda.alu_only_count(census),
            "bound_sm_clocks_per_nonce":
                sha256_cuda.bound_sm_clocks_per_nonce(census, adds),
            "difficulty_bits": d,
            "loop_census": census,
            "loop_instructions": sum(census.values()),
            "source_adds": adds,
        }
    return {"classes": classes, "nvcc_release": nvcc_release(nvcc),
            "symbol": sha256_cuda.kernel_symbol(CENSUS_DIFFICULTY)}


def write_budget(root: pathlib.Path | None = None,
                 overrides=None) -> pathlib.Path:
    """The one sanctioned mover: full rewrite of the port's OPBUDGET.json
    — the static censuses and, from the card, the traced SASS census (the
    committed diff is the review surface)."""
    from . import default_root

    root = root if root is not None else default_root()
    baseline_path, _, _ = _paths(root, overrides or {})
    data = static_section(root, overrides)
    data["traced"] = trace_loop_census()
    data["writer"] = MOVER
    write_json_budget(baseline_path, data)
    return baseline_path


def check_budget(root: pathlib.Path | None = None, overrides=None) -> int:
    """On the card: recomputes the static censuses and the SASS loop
    census of every class and requires them to reproduce the committed
    budget. The loop census is compared exactly when the ``nvcc`` release
    is the committed one; on another release the check fails naming both.
    Growth of the static census is a RATCHET INCREASE. rc 0 reproduces,
    1 drifted, 2 not armed or no card. One line starting ``opbudget:`` on
    stderr per verdict, and a JSON object of the traced census on stdout
    when it was taken."""
    import json
    import sys

    from . import default_root

    root = root if root is not None else default_root()
    baseline_path, _, _ = _paths(root, overrides or {})
    committed, err = load_baseline(baseline_path)
    if committed is None:
        print(f"opbudget: not armed: {err}", file=sys.stderr)
        return 2
    static = static_section(root, overrides)
    try:
        traced = trace_loop_census()
    except ValueError as e:
        print(f"opbudget: {e}", file=sys.stderr)
        return 2
    print(json.dumps(traced, sort_keys=True))
    cur, old = static["static_alu_ops"], committed["static_alu_ops"]
    if cur > old:
        print(f"opbudget: RATCHET INCREASE: static ALU census {cur} > "
              f"committed {old} (delta +{cur - old})", file=sys.stderr)
        return 1
    if any(committed.get(k) != v for k, v in static.items()):
        print(f"opbudget: {BASELINE_NAME}'s static census is stale — "
              f"re-run `{MOVER}` and review the diff", file=sys.stderr)
        return 1
    was = committed["traced"]
    if traced["nvcc_release"] != was.get("nvcc_release"):
        print(f"opbudget: the library was built by nvcc release "
              f"{traced['nvcc_release']}, the committed census by "
              f"{was.get('nvcc_release')}: the SASS loop census is not "
              f"comparable; re-census with `{MOVER}`", file=sys.stderr)
        return 1
    for cls, row in traced["classes"].items():
        if row != was.get("classes", {}).get(cls):
            print(f"opbudget: class {cls} (d{row['difficulty_bits']}): the "
                  f"SASS loop census drifted: "
                  f"{row['loop_instructions']} instructions, ALU-only "
                  f"{row['alu_only']} against the committed "
                  f"{was.get('classes', {}).get(cls)}", file=sys.stderr)
            return 1
    main = traced["classes"][str(difficulty_class(CENSUS_DIFFICULTY))]
    print(f"opbudget: {BASELINE_NAME} reproduces (static {cur} ALU ops a "
          f"nonce; nvcc {traced['nvcc_release']}; d{CENSUS_DIFFICULTY} "
          f"loop {main['loop_instructions']} instructions, ALU-only "
          f"{main['alu_only']}, source adds {main['source_adds']}, bound "
          f"{main['bound_sm_clocks_per_nonce']:.4f} SM clocks a nonce)",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.analysis.opbudget",
        description="the sanctioned mover of the port's OPBUDGET.json "
                    "(in mpi_blockchain_tpu_torch/analysis/): builds and "
                    "disassembles the CUDA library on the card (imports "
                    "torch) and rewrites or checks the committed budget; "
                    "the chainlint gate itself stays stdlib-only")
    parser.add_argument("--write", action="store_true",
                        help="re-census on the card and rewrite the budget")
    parser.add_argument("--check", action="store_true",
                        help="verify the committed budget reproduces on "
                             "the card")
    parser.add_argument("--baseline", type=pathlib.Path, default=None,
                        metavar="PATH",
                        help="check/write against another OPBUDGET.json "
                             "(the drift-fixture seam)")
    parser.add_argument("--root", type=pathlib.Path, default=None)
    args = parser.parse_args(argv)
    if args.write == args.check:
        parser.error("pass exactly one of --write and --check")
    overrides = ({"opbudget_json": args.baseline}
                 if args.baseline is not None else None)
    if args.check:
        return check_budget(args.root, overrides)
    try:
        path = write_budget(args.root, overrides)
    except (ValueError, OSError) as e:
        print(f"opbudget: {e}", file=sys.stderr)
        return 2
    print(f"opbudget: wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
