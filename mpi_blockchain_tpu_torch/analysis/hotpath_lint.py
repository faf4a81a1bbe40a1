"""HOT rules — blocking-call detection on the port's dispatch hot path.

The host loop between two sweeps on the card is tight: one launch per
sweep, heartbeats and counters through the in-memory telemetry ring, one
read-back, and nothing else. The pipelined miner lives or dies on that
staying true — a single ``time.sleep``, checkpoint write, or socket call
creeping into ``Miner.mine_block`` serializes the pipeline and re-opens
the bubble the meshwatch pipeline report measures. This pass walks the
call graph (analysis/callgraph.py) from the mine-loop entry points and
flags blocking work reachable on the sweep critical path:

  HOT001  a blocking call — file I/O (``open``/``os.fdopen``/pathlib
           read/write/mkdir, ``tempfile``), ``time.sleep``, socket ops,
           ``subprocess``/``os.system``, ``os.replace``/``rename``/
           ``fsync`` — reachable from a hot-path entry point outside the
           sanctioned seams. The finding message carries the call chain
           that reaches it.
  HOT002  a configured hot-path entry point does not exist in the
           analyzed file set — the lint is silently checking nothing.

Entry points: the port's ``Miner.mine_chain``/``mine_block``
(models/miner.py), ``FusedMiner.mine_chain``/``_mine_span``
(models/fused.py), and the two backends the miners drive on the card:
``CudaBackend.launch``/``search`` (backend/cuda.py) and
``ResilientBackend.search_async``/``search`` (resilience/dispatch.py).

Sanctioned seams (pruned from traversal — blocking work INSIDE them is
their own contract, reviewed there): the reference's list mapped onto
the port (``telemetry/``, ``meshwatch/``, ``perfwatch/``,
``blocktrace/``, ``resilience/policy.py``, ``resilience/injection.py``,
``utils/logging.py``, ``service/``), and one the port decides on
explicitly:

* ``core/build.py`` — the native libraries' build at first use (the C++
  core with g++, the CUDA library with nvcc), reached through the
  memoized loaders (``core._ctypes_binding._lib``,
  ``ops.sha256_cuda._lib``). It runs once a process, before the first
  launch that needs it, and never again: the loaders are
  ``functools.cache``d. The reference's counterpart is the jit compile
  at a program's first dispatch, which its hot path carries the same
  way; a run that must not pay it builds first (``chip_smoke.py`` and
  ``bench`` do).

The checkpoint seam stays honest by construction: ``mine
--checkpoint-every`` runs through the ``on_block`` callback, which a
static call graph cannot follow. Known limits in
docs/static_analysis_torch.md §Known limits.

Scope (override key ``hotpath_files``): ``models/``, ``backend/``,
``ops/``, ``parallel/``, ``core/*.py``, ``utils/``, ``config.py``,
``resilience/dispatch.py``.
"""
from __future__ import annotations

import ast
import pathlib

from . import DOC, REPO_PACKAGE, Finding, override_files, package_scope, \
    rel_path
from .callgraph import CallGraph, FuncInfo, call_name, dotted

#: (class, method) hot-path entry points; every one must exist (HOT002).
#: Shared root set: sync_lint walks the same roots (SYNC003 mirrors
#: HOT002), so a rename is caught by whichever family runs.
ENTRY_POINTS = (
    ("Miner", "mine_chain"),
    ("Miner", "mine_block"),
    ("FusedMiner", "mine_chain"),
    ("FusedMiner", "_mine_span"),
    ("CudaBackend", "launch"),
    ("CudaBackend", "search"),
    ("ResilientBackend", "search_async"),
    ("ResilientBackend", "search"),
)

_PKG = REPO_PACKAGE

#: Module path prefixes (repo-relative, posix) pruned from traversal.
SANCTIONED_SEAMS = (
    f"{_PKG}/telemetry",
    f"{_PKG}/meshwatch",
    f"{_PKG}/perfwatch",
    # blocktrace: in-memory trace context + per-block waterfall math.
    f"{_PKG}/blocktrace",
    f"{_PKG}/resilience/policy.py",
    f"{_PKG}/resilience/injection.py",
    f"{_PKG}/utils/logging.py",
    # The miner only touches the service through TemplateFeed.payload_for
    # (a lock-guarded in-memory template read).
    f"{_PKG}/service",
    # The native libraries' build at first use: once a process, behind
    # the functools.cache'd loaders (see the module docstring).
    f"{_PKG}/core/build.py",
)

#: Dotted (module, func) pairs that block the calling thread.
_BANNED_DOTTED = {
    ("time", "sleep"),
    ("os", "replace"), ("os", "rename"), ("os", "fsync"),
    ("os", "fdopen"), ("os", "system"), ("os", "popen"),
    ("socket", "socket"), ("socket", "create_connection"),
    ("tempfile", "mkstemp"), ("tempfile", "mkdtemp"),
    ("tempfile", "NamedTemporaryFile"), ("tempfile", "TemporaryFile"),
    ("shutil", "copy"), ("shutil", "copyfile"), ("shutil", "move"),
}

#: Dotted prefixes that are blocking wholesale.
_BANNED_PREFIXES = ("subprocess.", "urllib.request.")

#: Bare builtin/from-imported names that block.
_BANNED_BARE = {"open", "sleep", "mkstemp", "urlopen"}

#: pathlib-style I/O method names (attribute calls on any receiver;
#: "open" covers both ``path.open()`` and e.g. ``gzip.open``).
_BANNED_IO_METHODS = {"open", "read_text", "write_text", "read_bytes",
                      "write_bytes", "mkdir", "rmdir", "touch",
                      "unlink", "hardlink_to", "symlink_to"}


def _banned_label(node: ast.Call) -> str | None:
    """The human label when this call is a blocking primitive."""
    d = dotted(node.func)
    name = call_name(node)
    if d:
        parts = tuple(d.split("."))
        if len(parts) >= 2 and parts[-2:] in _BANNED_DOTTED:
            return d
        if any(d.startswith(p) for p in _BANNED_PREFIXES):
            return d
    if isinstance(node.func, ast.Name) and name in _BANNED_BARE:
        return name
    if isinstance(node.func, ast.Attribute) and \
            name in _BANNED_IO_METHODS:
        return f".{name}()"
    return None


def _scoped_files(root: pathlib.Path) -> list[pathlib.Path]:
    return package_scope(
        root, subdirs=("models", "backend", "ops", "parallel", "utils"),
        extras=("config.py", "resilience/dispatch.py"),
        core_glob=True)


def _is_sanctioned(info: FuncInfo) -> bool:
    mod = info.module.replace("\\", "/")
    return any(mod.startswith(seam) for seam in SANCTIONED_SEAMS)


def run_hotpath_lint(root: pathlib.Path, overrides=None,
                     notes=None) -> list[Finding]:
    files = override_files(overrides, "hotpath_files",
                           lambda: _scoped_files(root))

    graph, errors = CallGraph.from_files(root, files)
    findings: list[Finding] = [
        Finding(rel, lineno, "HOT000", f"syntax error: {msg}")
        for rel, lineno, msg in errors]

    anchor = (rel_path(files[0], root) if files else REPO_PACKAGE)
    roots, missing = graph.resolve_roots(ENTRY_POINTS)
    for cls, method in missing:
        findings.append(Finding(
            anchor, 1, "HOT002",
            f"hot-path entry point {cls}.{method} not found in the "
            f"analyzed file set — the blocking-call lint is "
            f"checking nothing for it; update ENTRY_POINTS in "
            f"analysis/hotpath_lint.py alongside the rename ({DOC} "
            f"§HOTPATH)"))

    chains = graph.reachable(roots, prune=_is_sanctioned)
    seen: set[tuple[str, int]] = set()
    for qual in sorted(chains):
        info = graph.functions[qual]
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            label = _banned_label(node)
            if label is None:
                continue
            key = (info.module, node.lineno)
            if key in seen:
                continue
            seen.add(key)
            chain = " -> ".join(chains[qual])
            findings.append(Finding(
                info.module, node.lineno, "HOT001",
                f"blocking call '{label}' reachable on the dispatch hot "
                f"path via {chain} — it serializes the sweep pipeline; "
                f"move it behind a sanctioned async seam (telemetry "
                f"ring, meshwatch flusher thread, the on_block "
                f"checkpoint callback) or off the critical path "
                f"({DOC} §HOTPATH)"))
    return findings
