"""BIND rules — the port's two C interfaces against their ctypes declarations.

Both native libraries of the port are bound with ctypes, and each binding
re-declares every ``extern "C"`` prototype by hand. A drifted arity or
width corrupts arguments silently: a pointer declared ``c_int`` is cut to
32 bits (on the card, an illegal address that surfaces as a fault at the
next synchronising call, far from its cause), a ``uint32`` passed where C
reads ``uint64`` reads garbage. Two interfaces are checked:

* the chain core: ``core/csrc/capi.cpp`` (its ``cc_*`` exports) against
  the ``_SIGNATURES`` table of ``core/_ctypes_binding.py``;
* the CUDA library: every function of the ``extern "C"`` block of
  ``ops/csrc/sha256d_sweep.cu`` against the ``lib.X.argtypes`` /
  ``lib.X.restype`` assignments of ``ops/sha256_cuda.bind``, which also
  binds the fused step's entries that ``ops/sha256_block.py`` calls.

  BIND001  exported C symbol has no ctypes argtypes declaration
  BIND002  argtypes arity differs from the C parameter count
  BIND003  an argtype is incompatible with the C parameter type
  BIND004  restype missing or incompatible with the C return type
  BIND005  ctypes declares a symbol the C interface does not export

The reference's BIND006/BIND007 (ctypes veneer against the pybind11
surface) have no counterpart: the port has no pybind11 module.

Read for the port: a pointer crosses as ``c_void_p`` (the port's binding
convention: device pointers are ``tensor.data_ptr()`` ints, host buffers
``ctypes`` arrays), so every pointer parameter accepts ``c_void_p``
beside its typed ``POINTER(...)`` spelling.
"""
from __future__ import annotations

import ast
import pathlib

from . import DOC, REPO_PACKAGE, Finding, rel_path
from .cparse import parse_extern_c_block, parse_extern_c_funcs

_PTR = {"c_void_p"}

# C parameter type -> acceptable ctypes spellings.
ARG_OK = {
    "uint8_t*": _PTR | {"c_char_p", "POINTER(c_uint8)"},
    "char*": _PTR | {"c_char_p"},
    "uint32_t*": _PTR | {"POINTER(c_uint32)"},
    "uint64_t*": _PTR | {"POINTER(c_uint64)"},
    "int*": _PTR | {"POINTER(c_int)"},
    "float*": _PTR | {"POINTER(c_float)"},
    "void*": _PTR,
    "uint8_t": {"c_uint8"},
    "uint16_t": {"c_uint16"},
    "uint32_t": {"c_uint32", "c_uint"},
    "uint64_t": {"c_uint64", "c_ulonglong"},
    "int64_t": {"c_int64", "c_longlong"},
    "int32_t": {"c_int32"},
    "size_t": {"c_size_t"},
    "int": {"c_int"},
}
RET_OK = {
    "void*": {"c_void_p"},
    "char*": {"c_char_p"},
    "uint64_t": {"c_uint64", "c_ulonglong"},
    "uint32_t": {"c_uint32", "c_uint"},
    "int64_t": {"c_int64", "c_longlong"},
    "int": {"c_int"},
}


def _ctypes_expr_name(node: ast.expr, aliases: dict[str, str]) -> str:
    """Canonical spelling of an argtypes/restype element expression."""
    if isinstance(node, ast.Attribute):        # ctypes.c_void_p
        return node.attr
    if isinstance(node, ast.Name):             # _P / c_int
        return aliases.get(node.id, node.id)
    if isinstance(node, ast.Call):             # ctypes.POINTER(ctypes.c_X)
        fn = _ctypes_expr_name(node.func, aliases)
        args = ",".join(_ctypes_expr_name(a, aliases) for a in node.args)
        return f"{fn}({args})"
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    return ast.dump(node)


def _aliases(tree: ast.Module) -> dict[str, str]:
    """Module-level ``_P = ctypes.c_void_p`` style aliases."""
    aliases: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, (ast.Attribute, ast.Call)):
            aliases[node.targets[0].id] = _ctypes_expr_name(node.value,
                                                            aliases)
    return aliases


def parse_signature_table(path: pathlib.Path):
    """(argtypes, restypes, lines) from the chain core binding's
    ``_SIGNATURES = {"cc_x": ([argtypes], restype), ...}`` table."""
    tree = ast.parse(path.read_text(), filename=str(path))
    aliases = _aliases(tree)
    argtypes: dict[str, list[str]] = {}
    restypes: dict[str, str] = {}
    lines: dict[str, int] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, (ast.Assign, ast.AnnAssign))
                and isinstance(node.value, ast.Dict)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        if not any(isinstance(t, ast.Name) and t.id == "_SIGNATURES"
                   for t in targets):
            continue
        for key, value in zip(node.value.keys, node.value.values):
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)
                    and isinstance(value, ast.Tuple)
                    and len(value.elts) == 2):
                continue
            sym = key.value
            lines[sym] = key.lineno
            args, ret = value.elts
            if isinstance(args, (ast.List, ast.Tuple)):
                argtypes[sym] = [_ctypes_expr_name(e, aliases)
                                 for e in args.elts]
            restypes[sym] = _ctypes_expr_name(ret, aliases)
    return argtypes, restypes, lines


def parse_ctypes_assignments(path: pathlib.Path, receivers=("lib", "_lib")):
    """(argtypes, restypes, lines) from ``lib.sym.argtypes = [...]`` /
    ``lib.sym.restype = ...`` assignments (the CUDA library's ``bind``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    aliases = _aliases(tree)
    argtypes: dict[str, list[str]] = {}
    restypes: dict[str, str] = {}
    lines: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Attribute)
                and isinstance(tgt.value.value, ast.Name)
                and tgt.value.value.id in receivers):
            continue
        sym = tgt.value.attr
        lines.setdefault(sym, node.lineno)
        if tgt.attr == "argtypes" and isinstance(node.value,
                                                 (ast.List, ast.Tuple)):
            argtypes[sym] = [_ctypes_expr_name(e, aliases)
                             for e in node.value.elts]
        elif tgt.attr == "restype":
            restypes[sym] = _ctypes_expr_name(node.value, aliases)
    return argtypes, restypes, lines


def check_contract(cfuncs, decls, c_rel: str, binding_rel: str
                   ) -> list[Finding]:
    """BIND001-005 for one C interface against one binding."""
    argtypes, restypes, decl_lines = decls
    findings: list[Finding] = []
    for name, fn in sorted(cfuncs.items()):
        if name not in argtypes:
            findings.append(Finding(
                c_rel, fn.line, "BIND001",
                f"exported symbol {name} has no ctypes argtypes "
                f"declaration in {binding_rel}"))
            continue
        declared = argtypes[name]
        line = decl_lines.get(name, 1)
        if len(declared) != len(fn.params):
            findings.append(Finding(
                binding_rel, line, "BIND002",
                f"{name}: argtypes arity {len(declared)} != C parameter "
                f"count {len(fn.params)} "
                f"({', '.join(p.ctype for p in fn.params)})"))
        else:
            for i, (p, d) in enumerate(zip(fn.params, declared)):
                ok = ARG_OK.get(p.ctype, set())
                if d not in ok:
                    findings.append(Finding(
                        binding_rel, line, "BIND003",
                        f"{name}: argtypes[{i}] is {d}; C declares "
                        f"'{p.name}: {p.ctype}' (expected one of "
                        f"{sorted(ok) or ['<unmappable>']}; {DOC} §BIND)"))
        declared_ret = restypes.get(name)
        if fn.ret == "void":
            if declared_ret not in (None, "None"):
                findings.append(Finding(
                    binding_rel, line, "BIND004",
                    f"{name}: restype {declared_ret} declared but C "
                    f"returns void"))
        else:
            ok = RET_OK.get(fn.ret, set())
            if declared_ret is None:
                findings.append(Finding(
                    binding_rel, line, "BIND004",
                    f"{name}: no restype declared; C returns {fn.ret} "
                    f"(ctypes would silently truncate through the c_int "
                    f"default)"))
            elif declared_ret not in ok:
                findings.append(Finding(
                    binding_rel, line, "BIND004",
                    f"{name}: restype {declared_ret} incompatible with C "
                    f"return {fn.ret} (expected one of {sorted(ok)})"))
    for name in sorted(set(argtypes) - set(cfuncs)):
        findings.append(Finding(
            binding_rel, decl_lines.get(name, 1), "BIND005",
            f"ctypes declares {name} but {c_rel} exports no such symbol"))
    return findings


def run_binding_contract(root: pathlib.Path, overrides=None,
                         notes=None) -> list[Finding]:
    overrides = overrides or {}
    pkg = root / REPO_PACKAGE
    capi = overrides.get("capi", pkg / "core" / "csrc" / "capi.cpp")
    binding = overrides.get("ctypes_binding",
                            pkg / "core" / "_ctypes_binding.py")
    cuda_src = overrides.get("cuda_src",
                             pkg / "ops" / "csrc" / "sha256d_sweep.cu")
    cuda_binding = overrides.get("cuda_binding",
                                 pkg / "ops" / "sha256_cuda.py")

    findings = check_contract(
        parse_extern_c_funcs(capi), parse_signature_table(binding),
        rel_path(capi, root), rel_path(binding, root))
    cuda_rel = rel_path(cuda_src, root)
    cfuncs = parse_extern_c_block(cuda_src)
    if not cfuncs:
        findings.append(Finding(
            cuda_rel, 1, "BIND001",
            f'no extern "C" function found in {cuda_rel} — the CUDA '
            f"library's C interface is gone or unparsable, so its binding "
            f"is checked against nothing"))
    findings += check_contract(
        cfuncs, parse_ctypes_assignments(cuda_binding), cuda_rel,
        rel_path(cuda_binding, root))
    return findings
