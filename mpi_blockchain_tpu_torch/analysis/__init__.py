"""chainlint for the PyTorch/CUDA port: static analysis of ``mpi_blockchain_tpu_torch``.

The port's counterpart of the reference's PR gate
(``python -m mpi_blockchain_tpu.analysis``), with its own scopes, its own
ratchet file and its own rules where the reference's read JAX: the same
rule ids, the same ``chainlint: disable=RULE`` comment form, the same
``Finding`` and the same deterministic (file, line, rule) order, so a
port finding maps to its reference counterpart. Every scope is rooted in
the port's package; the port's ``tools/`` plays the role of the
reference's ``experiments/``. The rule catalogue, the seams and how to
move the wait budget are in docs/static_analysis_torch.md.

The families:

* ``binding`` — two C interfaces against their ctypes declarations: the
  chain core's ``core/csrc/capi.cpp`` against ``core/_ctypes_binding.py``,
  and the ``extern "C"`` block of the CUDA library
  (``ops/csrc/sha256d_sweep.cu``) against ``ops/sha256_cuda.bind``
  (BIND001-005; the port has no pybind11 surface).
* ``header`` — the frozen 80-byte header layout across the C++ struct and
  serializer, ``core.HeaderFields``, ``NONCE_WORD_INDEX`` and its users,
  and the nonce word's place in the CUDA sweep and step (HDR001-004).
* ``sanitizers`` — the CUDA library's compute-sanitizer matrix: its
  driver exists, covers every entry of the C interface, and runs clean
  under memcheck, racecheck, synccheck and initcheck where the tool and a
  card are present (SAN001, SAN005-SAN008).
* ``telemetry`` — metric naming, rank labels, trace and site keywords
  at the emit points (TEL001-007).
* ``resilience`` — swallow-proof fault handling on the dispatch/IO paths
  and seeded randomness in ``sim/`` (RES001-002).
* ``conc``, ``lock``, ``future``, ``thread`` — thread-escape races,
  lock order and waits under a lock, future lifecycles, thread lifecycle
  and the blocking-wait ratchet (CONC, LCK, FUT, THR, TBW; the budget is
  ``analysis/WAITBUDGET.json`` inside this package).
* ``hotpath`` — blocking calls reachable from the miners' loops
  (HOT001-002).
* ``sync`` — implicit host-device syncs of device-origin tensors on the
  same hot path, read for PyTorch (SYNC001-003).
* ``spmd`` — collective consistency over the worlds of processes, read
  for ``torch.distributed``: no collective under a rank test, none a
  swallowing ``try`` can skip, and every rendezvous of the elastic file
  through ``guarded_collective`` (SPMD001, SPMD003-004).
* ``shard`` — rank-divergent values into the size of a tensor or the
  round count of a loop that enters a collective, read for
  ``torch.distributed`` (SHD003; the reference's SHD001, SHD002 and SHD004
  read ``shard_map``, which the port does not have).
* ``opbudget`` — the op-budget ratchet: the static ALU census of the
  sweep's per-nonce path in the CUDA source must not exceed
  ``analysis/OPBUDGET.json`` (OPB001-003; its traced section is the SASS
  loop census, taken on the card).
* ``trb`` — the transfer ratchet: host-device transfer and sync sites of
  the sweep path against ``analysis/TRANSFERBUDGET.json`` (TRB001-003;
  its traced section is the card's memcpy census).
* ``sbd`` — the collective-site ratchet: collective call sites of the
  world scope against ``analysis/SHARDBUDGET.json`` (SBD001-003; its
  traced section is the collectives one round issues).

CLI: ``python -m mpi_blockchain_tpu_torch.analysis`` — exits non-zero on
any finding. This module imports only the standard library: no torch, no
jax and nothing of the reference package, so the CLI runs wherever
Python does.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import threading
from typing import Callable, Iterable

REPO_PACKAGE = "mpi_blockchain_tpu_torch"

#: The catalogue the finding messages cite.
DOC = "docs/static_analysis_torch.md"

_SUPPRESS_RE = re.compile(r"chainlint:\s*disable=([\w,\- ]+)")
_SUPPRESS_FILE_RE = re.compile(r"chainlint:\s*disable-file=([\w,\- ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured finding: tests assert on ``rule`` ids."""
    file: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _suppressed_rules(match: re.Match | None) -> set[str]:
    if match is None:
        return set()
    return {r.strip() for r in match.group(1).split(",") if r.strip()}


def apply_suppressions(findings: Iterable[Finding],
                       root: pathlib.Path) -> list[Finding]:
    """Drops findings suppressed inline in their source file.

    Line-level: the flagged line carries ``chainlint: disable=RULE[,RULE]``
    (or ``disable=all``). File-level: any of the first 10 lines carries
    ``chainlint: disable-file=RULE[,RULE]``.
    """
    kept: list[Finding] = []
    cache: dict[str, list[str]] = {}
    for f in findings:
        path = root / f.file
        lines = cache.get(f.file)
        if lines is None:
            try:
                lines = path.read_text(errors="replace").splitlines()
            except OSError:
                lines = []
            cache[f.file] = lines
        file_rules: set[str] = set()
        for head in lines[:10]:
            file_rules |= _suppressed_rules(_SUPPRESS_FILE_RE.search(head))
        line_rules: set[str] = set()
        if 1 <= f.line <= len(lines):
            line_rules = _suppressed_rules(
                _SUPPRESS_RE.search(lines[f.line - 1]))
        active = file_rules | line_rules
        if f.rule in active or "all" in active:
            continue
        kept.append(f)
    return kept


#: Shared (text, AST) cache for the file-scoped passes: the conc, lock,
#: future and thread families walk overlapping file sets, and each source
#: is parsed once for all of them. Keyed by (path, mtime_ns, size), so a
#: rewritten override fixture parses again; guarded for ``--jobs``.
_SOURCE_CACHE: dict[tuple, tuple[str, ast.Module | None,
                                 tuple[int, str] | None]] = {}
_SOURCE_LOCK = threading.Lock()


def source_cached(path: pathlib.Path) -> tuple[str, ast.Module | None,
                                               tuple[int, str] | None]:
    """(text, tree, syntax_error) for a source file, memoized across
    pass families. ``tree`` is None iff the file failed to parse;
    ``syntax_error`` is then ``(lineno, msg)``. Raises OSError like
    ``read_text`` would."""
    path = pathlib.Path(path)
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    with _SOURCE_LOCK:
        hit = _SOURCE_CACHE.get(key)
    if hit is not None:
        return hit
    text = path.read_text()
    try:
        tree = ast.parse(text, filename=str(path))
        entry = (text, tree, None)
    except SyntaxError as e:
        entry = (text, None, (e.lineno or 1, e.msg or "syntax error"))
    with _SOURCE_LOCK:
        if len(_SOURCE_CACHE) > 4096:    # fixture churn in long test runs
            _SOURCE_CACHE.clear()
        _SOURCE_CACHE[key] = entry
    return entry


def default_root() -> pathlib.Path:
    """The repo root: parent of the mpi_blockchain_tpu_torch package."""
    return pathlib.Path(__file__).resolve().parent.parent.parent


def rel_path(path: pathlib.Path, root: pathlib.Path) -> str:
    """Repo-relative rendering used in findings (falls back to the given
    path for override fixtures outside the repo). One copy: the
    suppression and audit machinery join findings on this string."""
    path = pathlib.Path(path)
    return (str(path.relative_to(root)) if path.is_relative_to(root)
            else str(path))


def package_scope(root: pathlib.Path, subdirs: Iterable[str] = (),
                  extras: Iterable[str] = (),
                  core_glob: bool = False) -> list[pathlib.Path]:
    """Scope-file builder shared by the file-scoped passes: rglob of
    package subdirs + optional ``core/*.py`` glob (top level only —
    core/csrc is C++) + explicit package-relative extras, sorted."""
    pkg = root / REPO_PACKAGE
    files: list[pathlib.Path] = []
    for sub in subdirs:
        d = pkg / sub
        if d.is_dir():
            files += [p for p in d.rglob("*.py")
                      if "__pycache__" not in p.parts]
    if core_glob:
        core = pkg / "core"
        if core.is_dir():
            files += list(core.glob("*.py"))
    for extra in extras:
        p = pkg / extra
        if p.is_file():
            files.append(p)
    return sorted(files)


def override_files(overrides: dict | None, key: str,
                   default: Callable[[], Iterable[pathlib.Path]]
                   ) -> list[pathlib.Path]:
    """Normalizes a file-list override: absent -> ``default()``, a bare
    str/Path (the CLI's ``--override KEY=PATH`` form) -> one-element
    list."""
    value = (overrides or {}).get(key)
    if value is None:
        value = default()
    elif isinstance(value, (str, pathlib.Path)):
        value = [value]
    return [pathlib.Path(p) for p in value]


def pass_families() -> dict[str, Callable[..., list[Finding]]]:
    """Registry of the pass families the CLI runs (imports deferred so a
    syntax error in one pass does not take down the others)."""
    from .binding_contract import run_binding_contract
    from .conc_lint import run_conc_lint
    from .future_lint import run_future_lint
    from .header_layout import run_header_layout
    from .hotpath_lint import run_hotpath_lint
    from .lock_lint import run_lock_lint
    from .opbudget import run_opbudget
    from .resilience_lint import run_resilience_lint
    from .sanitizers import run_sanitizers
    from .shard_budget import run_shard_budget
    from .shard_lint import run_shard_lint
    from .spmd_lint import run_spmd_lint
    from .sync_lint import run_sync_lint
    from .telemetry_lint import run_telemetry_lint
    from .thread_lint import run_thread_lint
    from .transfer_budget import run_transfer_budget
    return {
        "binding": run_binding_contract,
        "header": run_header_layout,
        "sanitizers": run_sanitizers,
        "telemetry": run_telemetry_lint,
        "resilience": run_resilience_lint,
        "conc": run_conc_lint,
        "hotpath": run_hotpath_lint,
        "sync": run_sync_lint,
        "lock": run_lock_lint,
        "future": run_future_lint,
        "thread": run_thread_lint,
        "spmd": run_spmd_lint,
        "shard": run_shard_lint,
        "opbudget": run_opbudget,
        "trb": run_transfer_budget,
        "sbd": run_shard_budget,
    }


_PKG = REPO_PACKAGE

#: The code that drives a world's collectives (the spmd and shard scopes).
_WORLD_SCOPE = (f"{_PKG}/parallel", f"{_PKG}/tools", f"{_PKG}/models/fused.py",
                f"{_PKG}/models/miner.py", f"{_PKG}/backend/cuda.py",
                f"{_PKG}/cli.py", f"{_PKG}/resilience/elastic.py")

#: Repo-relative path prefixes each family draws findings from — the
#: ``--since REV`` changed-files mode skips families whose scope holds no
#: changed file (a family that runs keeps ALL its findings).
FAMILY_SCOPES: dict[str, tuple[str, ...]] = {
    "binding": (f"{_PKG}/core", f"{_PKG}/ops"),
    "header": (f"{_PKG}/core", f"{_PKG}/ops",
               "tests/test_torch_header_layout.py"),
    "sanitizers": (f"{_PKG}/ops/csrc", f"{_PKG}/core/csrc"),
    "telemetry": (_PKG,),
    "resilience": (_PKG,),
    "conc": (_PKG,),
    "hotpath": (_PKG,),
    "sync": (f"{_PKG}/models", f"{_PKG}/backend", f"{_PKG}/parallel",
             f"{_PKG}/core", f"{_PKG}/ops/sha256_cuda.py",
             f"{_PKG}/utils", f"{_PKG}/config.py",
             f"{_PKG}/resilience/dispatch.py",
             f"{_PKG}/resilience/elastic.py"),
    "lock": (_PKG,),
    "future": (_PKG,),
    "thread": (_PKG,),
    "spmd": _WORLD_SCOPE,
    "shard": _WORLD_SCOPE,
    "opbudget": (f"{_PKG}/ops/csrc/sha256d_sweep.cu",
                 f"{_PKG}/ops/sha256_sched.py",
                 f"{_PKG}/analysis/OPBUDGET.json"),
    "trb": (f"{_PKG}/models/miner.py", f"{_PKG}/models/fused.py",
            f"{_PKG}/backend/cuda.py", f"{_PKG}/backend/cpu.py",
            f"{_PKG}/parallel/mesh.py", f"{_PKG}/resilience/dispatch.py",
            f"{_PKG}/ops/sha256_cuda.py", f"{_PKG}/ops/sha256_block.py",
            f"{_PKG}/analysis/TRANSFERBUDGET.json"),
    "sbd": (f"{_PKG}/parallel/mesh.py", f"{_PKG}/parallel/distributed.py",
            f"{_PKG}/backend/cuda.py", f"{_PKG}/models/fused.py",
            f"{_PKG}/models/miner.py", f"{_PKG}/analysis/SHARDBUDGET.json"),
}

#: Rule-id prefix -> owning family (suppression audit attribution).
RULE_FAMILIES = {"BIND": "binding", "HDR": "header", "SAN": "sanitizers",
                 "TEL": "telemetry", "RES": "resilience", "CONC": "conc",
                 "HOT": "hotpath", "SYNC": "sync", "LCK": "lock",
                 "FUT": "future", "THR": "thread", "TBW": "thread",
                 "SPMD": "spmd", "SHD": "shard", "OPB": "opbudget",
                 "TRB": "trb", "SBD": "sbd"}


#: A change under the analysis engine itself can alter ANY family's
#: behavior — --since runs everything rather than guessing.
_ENGINE_PREFIX = f"{_PKG}/analysis"


def families_for_changed(changed: Iterable[str]) -> list[str]:
    """Families whose scope intersects a changed-file set (repo-relative
    posix paths), in registry order. Any change under the analysis
    engine selects every family."""
    changed = [c.replace("\\", "/") for c in changed]
    if any(c == _ENGINE_PREFIX
           or c.startswith(_ENGINE_PREFIX + "/") for c in changed):
        return list(FAMILY_SCOPES)
    selected: list[str] = []
    for family, prefixes in FAMILY_SCOPES.items():
        if any(c == p or c.startswith(p.rstrip("/") + "/")
               for c in changed for p in prefixes):
            selected.append(family)
    return selected


def run_all(root: pathlib.Path | None = None,
            passes: Iterable[str] | None = None,
            overrides: dict[str, pathlib.Path] | None = None,
            notes: list[str] | None = None,
            *,
            apply_suppress: bool = True,
            jobs: int = 1,
            timings: dict[str, float] | None = None) -> list[Finding]:
    """Runs the selected pass families and returns suppression-filtered
    findings, sorted by (file, line, rule). ``overrides`` maps checker
    file keys (e.g. ``capi``, ``cuda_src``) to alternate paths — the
    drift-fixture test seam. ``notes`` collects non-finding diagnostics
    (a missing tool). ``jobs`` > 1 runs the families on a thread pool;
    results merge in registry order either way. ``timings`` (if given)
    receives per-family wall milliseconds. ``apply_suppress=False``
    returns the RAW findings — the suppression-audit path."""
    import time

    root = root if root is not None else default_root()
    registry = pass_families()
    selected = list(passes) if passes is not None else list(registry)
    unknown = [p for p in selected if p not in registry]
    if unknown:
        raise ValueError(f"unknown pass families {unknown}; "
                         f"have {sorted(registry)}")

    def run_one(name: str) -> list[Finding]:
        t0 = time.perf_counter()
        result = registry[name](root, overrides=overrides or {},
                                notes=notes)
        if timings is not None:
            timings[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return result

    findings: list[Finding] = []
    if jobs > 1 and len(selected) > 1:
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(
                min(jobs, len(selected))) as pool:
            futures = {name: pool.submit(run_one, name)
                       for name in selected}
        for name in selected:           # registry order, not finish order
            # The pool's with-block has already joined every worker, so
            # each future is done here: this read never waits.
            findings.extend(futures[name].result())  # chainlint: disable=FUT002
    else:
        for name in selected:
            findings.extend(run_one(name))
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    if apply_suppress:
        return apply_suppressions(findings, root)
    return findings


# ---- stale-suppression audit ----------------------------------------------

_AUDIT_SUFFIXES = (".py", ".cpp", ".hpp", ".h", ".cc", ".cu", ".cuh")


def _audit_files(root: pathlib.Path) -> list[pathlib.Path]:
    # tests/ is deliberately NOT scanned: its fixture literals embed
    # `chainlint: disable=` strings that are test data, not suppressions.
    # The port's tools/ lives inside the package, so one walk covers it.
    base = root / REPO_PACKAGE
    if not base.is_dir():
        return []
    return sorted(p for p in base.rglob("*")
                  if p.suffix in _AUDIT_SUFFIXES
                  and "__pycache__" not in p.parts
                  and "build" not in p.relative_to(base).parts[:1])


def audit_suppressions(root: pathlib.Path | None = None,
                       passes: Iterable[str] | None = None,
                       overrides: dict | None = None,
                       notes: list[str] | None = None,
                       jobs: int = 1) -> list[str]:
    """Warnings for every ``chainlint: disable=`` comment whose rule no
    longer fires on that line (and every ``disable-file=`` whose rule
    fires nowhere in the file). Only rules whose owning family RAN are
    audited, so a ``--passes`` subset never reports false staleness.
    Warning-only: warnings never fail a gate."""
    root = root if root is not None else default_root()
    registry = pass_families()
    selected = list(passes) if passes is not None else list(registry)
    raw = run_all(root=root, passes=selected, overrides=overrides,
                  notes=notes, apply_suppress=False, jobs=jobs)
    return audit_from_raw(root, raw, selected)


def audit_from_raw(root: pathlib.Path, raw: Iterable[Finding],
                   ran_families: Iterable[str]) -> list[str]:
    """The audit computed from an existing RAW (unsuppressed) findings
    set — the seam that lets the CLI's gating run serve the staleness
    report without analyzing everything a second time."""
    fired_line = {(f.file, f.line, f.rule) for f in raw}
    fired_file = {(f.file, f.rule) for f in raw}
    ran = set(ran_families)

    def audited(rule: str) -> bool:
        prefix = rule.rstrip("0123456789")
        return RULE_FAMILIES.get(prefix) in ran

    warnings: list[str] = []
    for path in _audit_files(root):
        rel = rel_path(path, root)
        try:
            lines = path.read_text(errors="replace").splitlines()
        except OSError:
            continue
        for i, line in enumerate(lines, start=1):
            m = _SUPPRESS_FILE_RE.search(line)
            if m and i <= 10:
                for rule in _suppressed_rules(m):
                    if rule != "all" and audited(rule) and \
                            (rel, rule) not in fired_file:
                        warnings.append(
                            f"{rel}:{i}: stale file-level suppression — "
                            f"{rule} fires nowhere in this file")
                continue
            m = _SUPPRESS_RE.search(line)
            if m:
                for rule in _suppressed_rules(m):
                    if rule != "all" and audited(rule) and \
                            (rel, i, rule) not in fired_line:
                        warnings.append(
                            f"{rel}:{i}: stale suppression — {rule} no "
                            f"longer fires on this line")
    return warnings
