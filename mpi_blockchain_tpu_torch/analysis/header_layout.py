"""HDR rules — the frozen 80-byte header layout, held across the port.

Every path of the port depends on the exact serialization of chain.hpp's
FROZEN table; a silently reordered or resized field is the drift this pass
exists to catch. The canonical layout is pinned HERE, and the port's
independent encodings of it are checked against it:

  HDR001  C++ BlockHeader struct field order/width differs from canonical
  HDR002  header size constant (kHeaderSize / HEADER_SIZE) is not 80
  HDR003  chain.cpp serialize()/deserialize() offsets differ from canonical
  HDR004  a Python- or CUDA-side layout anchor disagrees: the
          ``HeaderFields`` codec and ``set_nonce`` slice
          (``core/__init__.py``), ``NONCE_WORD_INDEX``
          (``ops/sha256_sched.py``) and its users (``sha256_block.py``'s
          winner digest, ``sha256_torch.py``'s round-4 entry), the nonce
          word of the CUDA sweep and step (``ops/csrc/sha256d_sweep.cu``),
          and the golden-byte test's offsets

The nonce MUST live in SHA-256 chunk 2 at word 3 (byte offset 76 = 64 +
3*4): the midstate and extended-midstate precompute of every path
assumes it. Every anchor fails closed: a pattern that no longer matches
is itself a finding, so a refactor cannot silently switch a leg off.
"""
from __future__ import annotations

import pathlib
import re

from . import DOC, REPO_PACKAGE, Finding, rel_path
from .cparse import extract_function_body, parse_struct_fields, \
    strip_comments

CANONICAL = (("version", 4), ("prev_hash", 32), ("data_hash", 32),
             ("timestamp", 4), ("bits", 4), ("nonce", 4))
HEADER_SIZE = 80
NONCE_OFFSET = 76           # == 64 (chunk 1) + 3 (word index) * 4
NONCE_WORD = (NONCE_OFFSET - 64) // 4


def canonical_offsets() -> dict[str, tuple[int, int]]:
    out, off = {}, 0
    for name, width in CANONICAL:
        out[name] = (off, width)
        off += width
    return out


def _line(text: str, offset: int) -> int:
    return text[:offset].count("\n") + 1


def _check_struct(findings, hpp: pathlib.Path, rel: str):
    fields = parse_struct_fields(hpp, "BlockHeader")
    if not fields:
        findings.append(Finding(rel, 1, "HDR001",
                                "struct BlockHeader not found / no parsable "
                                "data members"))
        return
    got = [(f.name, f.width) for f in fields]
    if got != list(CANONICAL):
        for i, (g, c) in enumerate(zip(got, CANONICAL)):
            if g != c:
                findings.append(Finding(
                    rel, fields[i].line, "HDR001",
                    f"BlockHeader field {i} is {g[0]}[{g[1]}B]; the frozen "
                    f"layout requires {c[0]}[{c[1]}B] here (full layout: "
                    f"{[n for n, _ in CANONICAL]})"))
                break
        else:
            findings.append(Finding(
                rel, fields[0].line, "HDR001",
                f"BlockHeader has {len(got)} data members; the frozen "
                f"layout has {len(CANONICAL)}"))
    total = sum(w for _, w in got)
    if total != HEADER_SIZE:
        findings.append(Finding(
            rel, fields[0].line, "HDR002",
            f"BlockHeader fields total {total} bytes; the frozen header "
            f"is {HEADER_SIZE}"))
    text = hpp.read_text(errors="replace")
    m = re.search(r"kHeaderSize\s*=\s*(\d+)", text)
    if m and int(m.group(1)) != HEADER_SIZE:
        findings.append(Finding(
            rel, _line(text, m.start()), "HDR002",
            f"kHeaderSize = {m.group(1)}; the frozen header is "
            f"{HEADER_SIZE}"))


def _serializer_offsets(body: str, buf: str) -> dict[str, int]:
    """Field -> byte offset from store_le32/load_le32/memcpy calls against
    buffer variable ``buf`` in a serialize/deserialize body."""
    offsets: dict[str, int] = {}
    for m in re.finditer(
            rf"store_le32\(\s*{buf}\s*(?:\+\s*(\d+))?\s*,\s*(\w+)\s*\)",
            body):
        offsets[m.group(2)] = int(m.group(1) or 0)
    for m in re.finditer(
            rf"(\w+)\s*=\s*load_le32\(\s*{buf}\s*(?:\+\s*(\d+))?\s*\)",
            body):
        offsets[m.group(1).split(".")[-1]] = int(m.group(2) or 0)
    for m in re.finditer(
            rf"memcpy\(\s*{buf}\s*(?:\+\s*(\d+))?\s*,\s*[\w.]*?(\w+)\s*,",
            body):
        offsets[m.group(2)] = int(m.group(1) or 0)
    for m in re.finditer(
            rf"memcpy\(\s*[\w.]*?(\w+)\s*,\s*{buf}\s*(?:\+\s*(\d+))?\s*,",
            body):
        offsets[m.group(1)] = int(m.group(2) or 0)
    return offsets


def _check_serializer(findings, cpp: pathlib.Path, rel: str):
    canon = canonical_offsets()
    for fn_re, buf, label in (
            (r"void\s+BlockHeader::serialize\s*\(", "out", "serialize"),
            (r"BlockHeader\s+BlockHeader::deserialize\s*\(", "in",
             "deserialize")):
        body = extract_function_body(cpp, fn_re)
        if not body:
            findings.append(Finding(rel, 1, "HDR003",
                                    f"BlockHeader::{label} not found"))
            continue
        got = _serializer_offsets(body, buf)
        normalized = {k.removeprefix("h."): v for k, v in got.items()}
        for field, (off, _w) in canon.items():
            if field not in normalized:
                findings.append(Finding(
                    rel, 1, "HDR003",
                    f"BlockHeader::{label} never touches field "
                    f"'{field}'"))
            elif normalized[field] != off:
                findings.append(Finding(
                    rel, 1, "HDR003",
                    f"BlockHeader::{label} places '{field}' at offset "
                    f"{normalized[field]}; the frozen layout puts it at "
                    f"{off}"))


class _Anchors:
    """Fail-closed regex anchors over one file: a pattern that does not
    match is an HDR004 finding naming what went missing."""

    def __init__(self, findings, path: pathlib.Path, rel: str,
                 strip_c: bool = False):
        self.findings, self.rel = findings, rel
        text = path.read_text(errors="replace")
        self.text = strip_comments(text) if strip_c else text

    def find(self, pattern: str, what: str) -> re.Match | None:
        m = re.search(pattern, self.text)
        if m is None:
            self.findings.append(Finding(
                self.rel, 1, "HDR004",
                f"could not locate {what} in {self.rel} — the layout "
                f"anchor is gone; update analysis/header_layout.py "
                f"alongside the refactor ({DOC} §HDR)"))
        return m

    def flag(self, m: re.Match, rule: str, message: str) -> None:
        self.findings.append(Finding(self.rel, _line(self.text, m.start()),
                                     rule, message))


def _check_python_codec(findings, core_init: pathlib.Path, rel: str):
    canon = canonical_offsets()
    a = _Anchors(findings, core_init, rel)
    m = a.find(r'unpack_from\("<I",\s*header80,\s*(\d+)\)',
               "the HeaderFields version unpack_from('<I', ...)")
    if m and int(m.group(1)) != canon["version"][0]:
        a.flag(m, "HDR004",
               f"HeaderFields.unpack reads version at {m.group(1)}; the "
               f"frozen layout puts it at {canon['version'][0]}")
    m = a.find(r'unpack_from\("<III",\s*header80,\s*(\d+)\)',
               "the HeaderFields timestamp/bits/nonce unpack_from('<III')")
    if m and int(m.group(1)) != canon["timestamp"][0]:
        a.flag(m, "HDR004",
               f"HeaderFields.unpack reads timestamp/bits/nonce from "
               f"{m.group(1)}; the frozen layout starts them at "
               f"{canon['timestamp'][0]}")
    expected = [(canon["prev_hash"][0],
                 canon["prev_hash"][0] + canon["prev_hash"][1]),
                (canon["data_hash"][0],
                 canon["data_hash"][0] + canon["data_hash"][1])]
    slices = list(re.finditer(r"header80\[(\d+):(\d+)\]", a.text))
    if not slices:
        findings.append(Finding(
            rel, 1, "HDR004",
            f"could not locate the HeaderFields hash-field slices "
            f"(header80[a:b]) in {rel} — layout anchor gone"))
    for sm in slices:
        sl = (int(sm.group(1)), int(sm.group(2)))
        if sl not in expected:
            a.flag(sm, "HDR004",
                   f"HeaderFields slices header80[{sl[0]}:{sl[1]}]; frozen "
                   f"hash fields live at {expected}")
    m = a.find(r"header80\[:(\d+)\]", "the set_nonce prefix slice")
    if m and int(m.group(1)) != NONCE_OFFSET:
        a.flag(m, "HDR004",
               f"set_nonce keeps header80[:{m.group(1)}]; the frozen nonce "
               f"offset is {NONCE_OFFSET}")


def _check_header_size(findings, binding: pathlib.Path, rel: str):
    a = _Anchors(findings, binding, rel)
    m = a.find(r"HEADER_SIZE\s*=\s*(\d+)", "the HEADER_SIZE constant")
    if m and int(m.group(1)) != HEADER_SIZE:
        a.flag(m, "HDR002",
               f"Python HEADER_SIZE = {m.group(1)}; the frozen header is "
               f"{HEADER_SIZE}")


def _check_nonce_word(findings, sched: pathlib.Path, block: pathlib.Path,
                      torch_ops: pathlib.Path, root: pathlib.Path):
    """NONCE_WORD_INDEX and the two Python users that must go through it
    (or through the round it implies)."""
    a = _Anchors(findings, sched, rel_path(sched, root))
    m = a.find(r"NONCE_WORD_INDEX\s*=\s*(\d+)",
               "the chunk-2 nonce word index (NONCE_WORD_INDEX)")
    if m and 64 + int(m.group(1)) * 4 != NONCE_OFFSET:
        a.flag(m, "HDR004",
               f"NONCE_WORD_INDEX = {m.group(1)} puts the nonce at byte "
               f"{64 + int(m.group(1)) * 4}; the frozen nonce offset is "
               f"{NONCE_OFFSET}")
    # The step's plain winner digest writes the nonce through the index,
    # never through a literal word number.
    b = _Anchors(findings, block, rel_path(block, root))
    b.find(r"\w+\[NONCE_WORD_INDEX\]\s*=",
           "the winner digest's nonce-word store (w[NONCE_WORD_INDEX] = ...)")
    # The plain sweep enters hash 1 at the round after the nonce word:
    # rounds 0..2 and round 3's constant part are in the extended midstate.
    t = _Anchors(findings, torch_ops, rel_path(torch_ops, root))
    m = t.find(r"_rounds\(\s*st4\s*,\s*window\s*,\s*K\[(\d+):\]\)",
               "the plain sweep's round-4 entry (_rounds(st4, window, K[4:]))")
    if m and int(m.group(1)) != NONCE_WORD + 1:
        t.flag(m, "HDR004",
               f"the plain sweep enters hash 1 at round {m.group(1)}; the "
               f"nonce word is chunk-2 word {NONCE_WORD}, so the first "
               f"round after it is {NONCE_WORD + 1}")


def _top_level_items(text: str) -> list[str]:
    """The comma-separated items of an initializer list, commas inside
    parentheses (a call's arguments) kept in their item."""
    items, depth, cur = [], 0, []
    for ch in text:
        if ch == "," and depth == 0:
            items.append("".join(cur).strip())
            cur = []
            continue
        depth += (ch == "(") - (ch == ")")
        cur.append(ch)
    items.append("".join(cur).strip())
    return [i for i in items if i]


def _check_cuda(findings, cu: pathlib.Path, rel: str):
    """The nonce word's place in the CUDA library: the sweep's chunk-2
    schedule (the nonce is word 3, the pad bit word 4), the step's
    finalize (the winner enters m[3]) and its chunk-2 template (slot 3
    left for the nonce, the pad bit at 4, the 640-bit length at 15)."""
    a = _Anchors(findings, cu, rel, strip_c=True)
    m = a.find(r"\bw\[(\d+)\]\s*=\s*0x80000000u?\s*;",
               "the sweep's chunk-2 pad word (w[4] = 0x80000000u)")
    if m and int(m.group(1)) != NONCE_WORD + 1:
        a.flag(m, "HDR004",
               f"the CUDA sweep puts the pad bit at chunk-2 word "
               f"{m.group(1)}; the nonce is word {NONCE_WORD}, the last "
               f"header word, so the pad is word {NONCE_WORD + 1}")
    m = a.find(r"\bm\[(\d+)\]\s*=\s*__byte_perm\(\s*nonce",
               "the step's finalize nonce word (m[3] = __byte_perm(nonce, ...))")
    if m and int(m.group(1)) != NONCE_WORD:
        a.flag(m, "HDR004",
               f"the CUDA step writes the winner into chunk-2 word "
               f"{m.group(1)}; the frozen nonce word is {NONCE_WORD}")
    m = a.find(r"uint32_t\s+t\[16\]\s*=\s*\{([^}]*)\}",
               "the step's chunk-2 template (uint32_t t[16] = {...})")
    if m:
        elts = _top_level_items(m.group(1))
        slot = elts[NONCE_WORD] if len(elts) > NONCE_WORD else None
        pad = elts[NONCE_WORD + 1] if len(elts) > NONCE_WORD + 1 else None
        if slot != "0" or pad is None or \
                not pad.lower().startswith("0x80000000"):
            a.flag(m, "HDR004",
                   f"the CUDA step's chunk-2 template is {{{m.group(1)}}}: "
                   f"word {NONCE_WORD} must be the nonce slot (0) and word "
                   f"{NONCE_WORD + 1} the pad bit (0x80000000)")
    m = a.find(r"\bt\[15\]\s*=\s*(\d+)\s*\*\s*8\s*;",
               "the step template's length word (t[15] = 80 * 8)")
    if m and int(m.group(1)) != HEADER_SIZE:
        a.flag(m, "HDR002",
               f"the CUDA step's template gives a {m.group(1)}-byte "
               f"message length; the frozen header is {HEADER_SIZE}")


def _check_golden_test(findings, test_path: pathlib.Path, rel: str):
    canon = canonical_offsets()
    valid = {(off, off + w) for off, w in canon.values()}
    text = test_path.read_text(errors="replace")
    for m in re.finditer(r"cand\[(\d+):(\d+)\]", text):
        sl = (int(m.group(1)), int(m.group(2)))
        if sl not in valid:
            findings.append(Finding(
                rel, _line(text, m.start()), "HDR004",
                f"golden-byte test slices cand[{sl[0]}:{sl[1]}], which is "
                f"not a frozen field span {sorted(valid)}"))


def run_header_layout(root: pathlib.Path, overrides=None,
                      notes=None) -> list[Finding]:
    overrides = overrides or {}
    pkg = root / REPO_PACKAGE
    hpp = overrides.get("chain_hpp", pkg / "core" / "csrc" / "chain.hpp")
    cpp = overrides.get("chain_cpp", pkg / "core" / "csrc" / "chain.cpp")
    core_init = overrides.get("core_init", pkg / "core" / "__init__.py")
    binding = overrides.get("ctypes_binding",
                            pkg / "core" / "_ctypes_binding.py")
    sched = overrides.get("sha_sched", pkg / "ops" / "sha256_sched.py")
    block = overrides.get("sha_block", pkg / "ops" / "sha256_block.py")
    torch_ops = overrides.get("sha_torch", pkg / "ops" / "sha256_torch.py")
    cu = overrides.get("cuda_src", pkg / "ops" / "csrc" / "sha256d_sweep.cu")
    golden = overrides.get("header_test",
                           root / "tests" / "test_torch_header_layout.py")

    findings: list[Finding] = []
    _check_struct(findings, hpp, rel_path(hpp, root))
    _check_serializer(findings, cpp, rel_path(cpp, root))
    _check_python_codec(findings, core_init, rel_path(core_init, root))
    _check_header_size(findings, binding, rel_path(binding, root))
    _check_nonce_word(findings, sched, block, torch_ops, root)
    _check_cuda(findings, cu, rel_path(cu, root))
    if golden.exists():
        _check_golden_test(findings, golden, rel_path(golden, root))
    elif notes is not None:
        notes.append(f"header: golden-byte test {golden} absent; skipped")
    return findings
