"""Minimal C/C++/CUDA source parsing for the chainlint passes.

Not a compiler: the core and kernel sources are house-style (clang-format,
no macros in signatures, no function pointers in the C ABI, definitions of
the C interface at column 0), so line-preserving comment stripping +
regexes over declarations are reliable here. Everything returns 1-based
line numbers against the ORIGINAL file so findings are clickable.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re


def strip_comments(text: str) -> str:
    """Removes // and /* */ comments, preserving line structure (every
    newline survives, so offsets->line numbers stay valid)."""
    def _block(m: re.Match) -> str:
        return "\n" * m.group(0).count("\n")

    text = re.sub(r"/\*.*?\*/", _block, text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return text


def line_of(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


@dataclasses.dataclass(frozen=True)
class CParam:
    name: str
    ctype: str          # canonical: "uint32_t", "uint8_t*", "void*", ...


@dataclasses.dataclass(frozen=True)
class CFunc:
    name: str
    ret: str            # canonical type
    params: tuple[CParam, ...]
    line: int


_BASE_TYPES = ("uint8_t", "uint16_t", "uint32_t", "uint64_t",
               "int64_t", "int32_t", "size_t", "int", "char", "void",
               "float")

#: Spellings the CUDA library's C interface uses for the fixed widths
#: (longest first, so "unsigned long long" never reads as "long long").
_ALIASES = ((r"\bunsigned\s+long\s+long\b", "uint64_t"),
            (r"\blong\s+long\b", "int64_t"),
            (r"\bunsigned\s+int\b", "uint32_t"),
            (r"\bunsigned\b", "uint32_t"))


def canon_ctype(decl: str) -> str:
    """'const uint8_t* data' -> 'uint8_t*'; 'uint8_t out[32]' -> 'uint8_t*';
    'uint64_t len' -> 'uint64_t'. Unknown shapes come back as-is (they then
    fail the compatibility table, which is the safe direction)."""
    decl = decl.strip()
    for pattern, width in _ALIASES:
        decl = re.sub(pattern, width, decl)
    is_ptr = "*" in decl or re.search(r"\[\s*\d*\s*\]", decl) is not None
    for base in _BASE_TYPES:
        if re.search(rf"\b{base}\b", decl):
            return f"{base}*" if is_ptr else base
    return decl


_FUNC_RE = re.compile(
    r"(?m)^(?P<ret>[A-Za-z_][\w ]*?\s*\*?)\s*"
    r"(?P<name>cc_\w+)\s*\((?P<params>[^)]*)\)\s*\{", re.S)


def _parse_funcs(text: str, pattern: re.Pattern, start: int = 0,
                 end: int | None = None) -> dict[str, CFunc]:
    funcs: dict[str, CFunc] = {}
    for m in pattern.finditer(text, start,
                              len(text) if end is None else end):
        params: list[CParam] = []
        plist = m.group("params").strip()
        if plist and plist != "void":
            for p in plist.split(","):
                p = p.strip()
                name_m = re.search(r"([A-Za-z_]\w*)\s*(?:\[\s*\d*\s*\])?$", p)
                params.append(CParam(
                    name=name_m.group(1) if name_m else p,
                    ctype=canon_ctype(p)))
        funcs[m.group("name")] = CFunc(
            name=m.group("name"), ret=canon_ctype(m.group("ret")),
            params=tuple(params), line=line_of(text, m.start()))
    return funcs


def parse_extern_c_funcs(path: pathlib.Path) -> dict[str, CFunc]:
    """All cc_* function definitions in a capi-style translation unit."""
    text = strip_comments(path.read_text(errors="replace"))
    return _parse_funcs(text, _FUNC_RE)


#: Any function definition that starts at column 0 (the C interface's
#: house style; statements inside a body are indented and never match).
_ANY_FUNC_RE = re.compile(
    r"(?m)^(?P<ret>[A-Za-z_][\w ]*?\s*\*?)\s*"
    r"(?P<name>[A-Za-z_]\w*)\s*\((?P<params>[^)]*)\)\s*\{", re.S)


def extern_c_span(text: str) -> tuple[int, int] | None:
    """(start, end) offsets of the first ``extern "C" { ... }`` block's
    body in comment-stripped text, brace-matched; None without one."""
    m = re.search(r'extern\s+"C"\s*\{', text)
    if m is None:
        return None
    depth, i = 1, m.end()
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return m.end(), i - 1


def parse_extern_c_block(path: pathlib.Path) -> dict[str, CFunc]:
    """Every function defined in the ``extern "C"`` block of a CUDA or
    C++ translation unit (the CUDA library's C interface), whatever its
    name; empty when the file has no such block."""
    text = strip_comments(path.read_text(errors="replace"))
    span = extern_c_span(text)
    if span is None:
        return {}
    return _parse_funcs(text, _ANY_FUNC_RE, *span)


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    width: int
    line: int


_FIELD_RE = re.compile(
    r"(?m)^\s*(?P<type>uint8_t|uint16_t|uint32_t|uint64_t)\s+"
    r"(?P<name>\w+)\s*(?:\[(?P<n>\d+)\])?\s*(?:=\s*[^;]*)?;")
_WIDTHS = {"uint8_t": 1, "uint16_t": 2, "uint32_t": 4, "uint64_t": 8}


def parse_struct_fields(path: pathlib.Path,
                        struct: str) -> list[StructField]:
    """Data members of ``struct <name> { ... }`` in declaration order.

    Method declarations inside the struct contain '(' and never match the
    field regex; nested braces (none in chain.hpp's headers) are out of
    scope for this parser.
    """
    text = strip_comments(path.read_text(errors="replace"))
    m = re.search(rf"struct\s+{struct}\s*\{{", text)
    if m is None:
        return []
    depth, i = 1, m.end()
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    body = text[m.end():i - 1]
    fields = []
    for fm in _FIELD_RE.finditer(body):
        width = _WIDTHS[fm.group("type")]
        if fm.group("n"):
            width *= int(fm.group("n"))
        fields.append(StructField(fm.group("name"), width,
                                  line_of(text, m.end() + fm.start())))
    return fields


def extract_function_body(path: pathlib.Path, signature_re: str) -> str:
    """Brace-matched body text of the first function whose definition
    matches ``signature_re`` (searched in comment-stripped text)."""
    text = strip_comments(path.read_text(errors="replace"))
    m = re.search(signature_re, text)
    if m is None:
        return ""
    start = text.find("{", m.end() - 1)
    if start < 0:
        return ""
    depth, i = 1, start + 1
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return text[start + 1:i - 1]
