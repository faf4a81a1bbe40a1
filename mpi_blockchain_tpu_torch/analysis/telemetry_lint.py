"""TEL rules — telemetry discipline of the port: causal stamps + metric naming.

The port keeps the reference's telemetry conventions (the same metric
names, labels and event records), so its rules are the reference's, over
the port's files. The forensics merge can only place sim-bus events that
carry a Lamport stamp and a node id; the mesh aggregator merges per-rank
series on one ``rank`` label convention; the critical-path, mesh-skew,
incident and compile views join their records on keywords the emit
points must carry.

  TEL001  ``emit_event(...)`` in a simulation-bus module whose payload
          cannot be proven to carry both ``lamport`` and ``node`` fields
          — either the dict literal omits them, or the payload is not a
          literal at all. Route sim-bus events through
          ``CausalLog.record`` (telemetry/causal.py), which stamps both.

  TEL002  a registry metric registered under a name that violates the
          documented naming/unit-suffix convention (docs/perfwatch.md):
          counters must end ``_total``; histograms must carry a unit
          suffix (``_ms``/``_seconds``/... or a documented count unit);
          no gauge/histogram may end ``_total``, ``_count`` or ``_sum``
          (``_count``/``_sum`` collide with the summary sample names the
          Prometheus exporter appends, ``_total`` masquerades as a
          counter to any dashboard). Only statically-known (literal
          string) names are checked — f-string families like
          ``sim_group_{field}`` are the call site's responsibility.

  TEL003  a hand-rolled ``rank`` label in a multi-rank code path: a
          ``counter``/``gauge``/``histogram`` call passing ``rank=...``
          directly. The meshwatch aggregator merges per-rank samples on
          the ``rank`` label, so the label must be ONE convention —
          stamped by ``telemetry.rank_counter``/``rank_gauge``/
          ``rank_histogram`` (which default it to the process's declared
          mesh rank) — or an 8-rank merge silently splits one series
          into differently-spelled ones.

  TEL004  a per-dispatch emit point (``profiler().dispatch(...)``) in
          the mining hot loop that does not thread the block trace
          context: the call must carry a ``height=`` keyword (or a
          ``**meta`` spread whose contents the lint cannot see). The
          blocktrace critical-path join attributes segments to blocks
          through the record's meta height (or per-segment trace
          stamps); a dispatch born without one produces segments the
          per-block waterfall can only count as ``unattributed`` — the
          drift bug that silently hollows out ``perfwatch
          critical-path`` (docs/observability.md §blocktrace).

  TEL005  a rendezvous skew-span emit point (``skew_span(...)``) that
          does not carry a ``site=`` keyword. The mesh-skew analyzer
          joins spans ACROSS RANKS on (site, round) — a span born
          without its site label lands in the shard as unjoinable
          noise, silently hollowing out ``perfwatch mesh-skew`` the
          same way a height-less dispatch hollows the critical path
          (docs/observability.md §meshprof). The runtime spells the
          parameter keyword-only for exactly this reason; the lint
          catches the drift where a future refactor loosens it.

  TEL006  a chainwatch incident emit point (``emit_incident(...)``)
          that does not carry explicit ``rule=`` and ``severity=``
          keywords. The incident surfaces all key on them — the
          ``incidents_total{rule,severity}`` counter, the open-episode
          table the shards//healthz//incidents views merge on, the
          bundle filename, the Perfetto annotation lane — so an emit
          born without them produces an incident the whole triage
          pipeline cannot classify (the runtime spells both parameters
          keyword-only; the lint catches the refactor that loosens it,
          same stance as TEL005's site=).

  TEL007  a dispatchwatch compile emit point (``compile_scope(...)`` /
          ``note_cache(...)``) that does not carry a ``site=`` keyword.
          The compile census joins observed compiles to the seam
          cache that should have absorbed them on the site label — a
          compile attributed without one lands as ``unscoped`` noise
          the recompile accounting must price pessimistically, and a
          cache note without one prices nothing at all (the runtime
          spells both parameters keyword-only; the lint catches the
          refactor that loosens it — the same stance as TEL005's
          skew-span site).

Scope (every path in the port's package; the reference's lists mapped
onto the port, plus the port's own emit points): TEL001 over
``simulation.py`` (the bus surface; override key ``sim_py``); TEL002 over
every ``.py`` of the package (override key ``telemetry_files``); TEL003
over the multi-rank surfaces — ``parallel/``, ``meshwatch/``,
``bench_lib.py``, ``resilience/elastic.py`` (the elastic ranks) and the
two-rank tool ``tools/world_turns.py`` (override key
``rank_scope_files``); TEL004 over the mining loops plus the CLI seam —
``models/miner.py``, ``models/fused.py``, ``resilience/elastic.py``,
``cli.py`` (override key ``blocktrace_scope_files``); TEL005 over the
skew-span emit surface — ``meshprof/``, ``resilience/elastic.py``,
``parallel/mesh.py``, ``blocktrace/overhead.py``, and the port's own
world sites ``backend/cuda.py`` and ``models/fused.py`` (override key
``skew_scope_files``); TEL006 over the incident emit surface —
``chainwatch/`` plus the wired seams ``resilience/elastic.py``,
``blocktrace/critical_path.py``, ``meshwatch/shard.py`` (override key
``incident_scope_files``); TEL007 over the compile emit surface —
``dispatchwatch/`` plus the wired dispatch seams ``backend/cuda.py``,
``models/fused.py``, ``parallel/mesh.py``, ``blocktrace/overhead.py``,
``ops/sha256_cuda.py`` (override key ``compile_scope_files``).

The docs the messages cite (docs/perfwatch.md, docs/observability.md)
describe the reference's conventions, which the port keeps; the port's
catalogue is docs/static_analysis_torch.md.
"""
from __future__ import annotations

import ast
import pathlib

from . import REPO_PACKAGE, Finding, override_files, rel_path


def _call_name(node: ast.Call) -> str:
    """Rightmost name of the called expression:
    telemetry.rank_counter -> 'rank_counter'."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""

REQUIRED_FIELDS = ("lamport", "node")

# TEL002: unit suffixes a histogram name may carry. Time/size units plus
# the repo's documented count units (reorg depth in blocks).
HISTOGRAM_UNIT_SUFFIXES = ("_ms", "_us", "_ns", "_s", "_seconds", "_bytes",
                           "_depth", "_blocks", "_pct")
# Reserved endings: _count/_sum are appended by the Prometheus summary
# renderer; _total is the counter convention.
RESERVED_SUFFIXES = ("_total", "_count", "_sum")


def _literal_str_keys(node: ast.expr) -> set[str] | None:
    """Keys of a dict literal (or dict(...) call with kwargs); None when
    the payload is not statically analyzable."""
    if isinstance(node, ast.Dict):
        keys = set()
        for k in node.keys:
            if k is None:  # **spread: keys unknowable
                return None
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
        return keys
    if (isinstance(node, ast.Call) and _call_name(node) == "dict"
            and not node.args):
        if any(kw.arg is None for kw in node.keywords):
            return None
        return {kw.arg for kw in node.keywords}
    return None


def _metric_name_arg(node: ast.Call) -> str | None:
    """The literal metric name of a counter/gauge/histogram call, or None
    when it is not statically known (variable, f-string family)."""
    arg = node.args[0] if node.args else None
    if arg is None:
        for kw in node.keywords:
            if kw.arg == "name":
                arg = kw.value
                break
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def _check_metric_name(kind: str, name: str) -> str | None:
    """TEL002 violation message for one (metric kind, literal name)."""
    if kind == "counter":
        if not name.endswith("_total"):
            return (f"counter {name!r} must end '_total' "
                    f"(the monotonic-counter convention)")
        return None
    bad = next((s for s in RESERVED_SUFFIXES if name.endswith(s)), None)
    if bad:
        return (f"{kind} {name!r} must not end {bad!r} — reserved for "
                f"{'counters' if bad == '_total' else 'summary samples'}")
    if kind == "histogram" and not name.endswith(HISTOGRAM_UNIT_SUFFIXES):
        return (f"histogram {name!r} lacks a unit suffix "
                f"{HISTOGRAM_UNIT_SUFFIXES}")
    return None


def _package_py_files(root: pathlib.Path) -> list[pathlib.Path]:
    pkg = root / REPO_PACKAGE
    return sorted(p for p in pkg.rglob("*.py")
                  if "__pycache__" not in p.parts
                  and p.relative_to(pkg).parts[0] != "build")


def _rank_scope_files(root: pathlib.Path) -> list[pathlib.Path]:
    """TEL003's multi-rank surface: everywhere a per-rank metric can be
    born (missing files are skipped)."""
    pkg = root / REPO_PACKAGE
    files: list[pathlib.Path] = []
    for sub in ("parallel", "meshwatch"):
        d = pkg / sub
        if d.is_dir():
            files.extend(p for p in d.rglob("*.py")
                         if "__pycache__" not in p.parts)
    for extra in (pkg / "bench_lib.py",
                  pkg / "resilience" / "elastic.py",
                  pkg / "tools" / "world_turns.py"):
        if extra.is_file():
            files.append(extra)
    return sorted(files)


def _run_naming_lint(root: pathlib.Path, files) -> list[Finding]:
    """TEL002 over every metric registration with a literal name."""
    findings: list[Finding] = []
    for path in files:
        rel = rel_path(path, root)
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 1, "TEL000",
                                    f"syntax error: {e.msg}"))
            continue
        except OSError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _call_name(node)
            if kind not in ("counter", "gauge", "histogram"):
                continue
            name = _metric_name_arg(node)
            if name is None:
                continue
            msg = _check_metric_name(kind, name)
            if msg:
                findings.append(Finding(
                    rel, node.lineno, "TEL002",
                    f"{msg}; see the naming convention in "
                    f"docs/perfwatch.md"))
    return findings


def _blocktrace_scope_files(root: pathlib.Path) -> list[pathlib.Path]:
    """TEL004's surface: everywhere a mining dispatch record is born
    (missing files are skipped, matching the other scope builders)."""
    pkg = root / REPO_PACKAGE
    return sorted(p for p in (pkg / "models" / "miner.py",
                              pkg / "models" / "fused.py",
                              pkg / "resilience" / "elastic.py",
                              pkg / "cli.py") if p.is_file())


def _is_profiler_dispatch(node: ast.Call) -> bool:
    """``profiler().dispatch(...)`` / ``profiler(...).dispatch(...)`` —
    the emit-point idiom, including aliased imports (``from ... import
    profiler as _profiler`` in cli.py), hence the suffix match; the
    profiler's own internal ``self.dispatch`` fallback
    (``segment_on_last``) deliberately does not match."""
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr == "dispatch"
            and isinstance(func.value, ast.Call)):
        return False
    name = _call_name(func.value)
    return bool(name) and name.endswith("profiler")


def _run_blocktrace_lint(root: pathlib.Path, files) -> list[Finding]:
    """TEL004: every mining-loop dispatch emit point threads the block
    trace context via an explicit ``height=`` (a ``**`` spread is
    opaque and passes — the call site owns it)."""
    findings: list[Finding] = []
    for path in files:
        rel = rel_path(path, root)
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 1, "TEL000",
                                    f"syntax error: {e.msg}"))
            continue
        except OSError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or \
                    not _is_profiler_dispatch(node):
                continue
            has_height = any(kw.arg in ("height", None)
                             for kw in node.keywords)
            if not has_height:
                findings.append(Finding(
                    rel, node.lineno, "TEL004",
                    "profiler().dispatch() without height= — the "
                    "dispatch record carries no block identity, so its "
                    "segments fall out of the per-block critical-path "
                    "join as `unattributed`; thread the block trace "
                    "context (pass height=..., or run inside "
                    "blocktrace.trace_block which defaults it) — "
                    "docs/observability.md §blocktrace"))
    return findings


def _skew_scope_files(root: pathlib.Path) -> list[pathlib.Path]:
    """TEL005's surface: everywhere a rendezvous skew span is born
    (missing files are skipped, matching the other scope builders)."""
    pkg = root / REPO_PACKAGE
    files = [p for p in (pkg / "resilience" / "elastic.py",
                         pkg / "parallel" / "mesh.py",
                         pkg / "blocktrace" / "overhead.py",
                         pkg / "backend" / "cuda.py",
                         pkg / "models" / "fused.py")
             if p.is_file()]
    d = pkg / "meshprof"
    if d.is_dir():
        files.extend(p for p in d.rglob("*.py")
                     if "__pycache__" not in p.parts)
    return sorted(files)


def _run_skew_span_lint(root: pathlib.Path, files) -> list[Finding]:
    """TEL005: every ``skew_span(...)`` emit point carries a literal
    ``site=`` keyword (a ``**`` spread is opaque and passes — the call
    site owns it, same stance as TEL004's height)."""
    findings: list[Finding] = []
    for path in files:
        rel = rel_path(path, root)
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 1, "TEL000",
                                    f"syntax error: {e.msg}"))
            continue
        except OSError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            # Suffix match for aliased imports (`from ... import
            # skew_span as _skew_span`), same stance as the profiler
            # dispatch idiom.
            if not (name and name.endswith("skew_span")):
                continue
            if not any(kw.arg in ("site", None) for kw in node.keywords):
                findings.append(Finding(
                    rel, node.lineno, "TEL005",
                    "skew_span() without site= — the span carries no "
                    "collective-site label, so the mesh-skew analyzer "
                    "cannot join it across ranks on (site, round) and "
                    "it lands in the shard as unjoinable noise; pass "
                    "site=... at the emit point — "
                    "docs/observability.md §meshprof"))
    return findings


def _incident_scope_files(root: pathlib.Path) -> list[pathlib.Path]:
    """TEL006's surface: everywhere a chainwatch incident is born —
    the subsystem itself plus the wired seams (missing files are
    skipped, matching the other scope builders)."""
    pkg = root / REPO_PACKAGE
    files = [p for p in (pkg / "resilience" / "elastic.py",
                         pkg / "blocktrace" / "critical_path.py",
                         pkg / "meshwatch" / "shard.py")
             if p.is_file()]
    d = pkg / "chainwatch"
    if d.is_dir():
        files.extend(p for p in d.rglob("*.py")
                     if "__pycache__" not in p.parts)
    return sorted(files)


def _run_incident_lint(root: pathlib.Path, files) -> list[Finding]:
    """TEL006: every ``emit_incident(...)`` emit point carries explicit
    ``rule=`` and ``severity=`` keywords (a ``**`` spread is opaque and
    passes — the call site owns it, same stance as TEL005's site)."""
    findings: list[Finding] = []
    for path in files:
        rel = rel_path(path, root)
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 1, "TEL000",
                                    f"syntax error: {e.msg}"))
            continue
        except OSError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            # Suffix match for aliased imports (`from ... import
            # emit_incident as _emit_incident`), same stance as TEL005.
            if not (name and name.endswith("emit_incident")):
                continue
            for req in ("rule", "severity"):
                if not any(kw.arg in (req, None)
                           for kw in node.keywords):
                    findings.append(Finding(
                        rel, node.lineno, "TEL006",
                        f"emit_incident() without {req}= — every "
                        f"incident surface (incidents_total labels, "
                        f"the open-episode table the shard//healthz/"
                        f"/incidents views merge on, the bundle "
                        f"filename, the Perfetto annotation lane) keys "
                        f"on it, so the triage pipeline cannot "
                        f"classify the incident; pass {req}=... at the "
                        f"emit point — docs/observability.md "
                        f"§chainwatch"))
    return findings


def _compile_scope_files(root: pathlib.Path) -> list[pathlib.Path]:
    """TEL007's surface: everywhere a compile emit is born — the
    subsystem itself plus the wired dispatch seams (missing files are
    skipped, matching the other scope builders)."""
    pkg = root / REPO_PACKAGE
    files = [p for p in (pkg / "backend" / "cuda.py",
                         pkg / "models" / "fused.py",
                         pkg / "parallel" / "mesh.py",
                         pkg / "blocktrace" / "overhead.py",
                         pkg / "ops" / "sha256_cuda.py")
             if p.is_file()]
    d = pkg / "dispatchwatch"
    if d.is_dir():
        files.extend(p for p in d.rglob("*.py")
                     if "__pycache__" not in p.parts)
    return sorted(files)


def _run_compile_emit_lint(root: pathlib.Path, files) -> list[Finding]:
    """TEL007: every ``compile_scope(...)`` / ``note_cache(...)`` emit
    point carries a ``site=`` keyword (a ``**`` spread is opaque and
    passes — the call site owns it, same stance as TEL005's site)."""
    findings: list[Finding] = []
    for path in files:
        rel = rel_path(path, root)
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 1, "TEL000",
                                    f"syntax error: {e.msg}"))
            continue
        except OSError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            # Suffix match for aliased imports (`from ... import
            # compile_scope as _compile_scope`), same stance as TEL005.
            if not (name and (name.endswith("compile_scope")
                              or name.endswith("note_cache"))):
                continue
            if not any(kw.arg in ("site", None) for kw in node.keywords):
                emit = ("compile_scope" if name.endswith("compile_scope")
                        else "note_cache")
                findings.append(Finding(
                    rel, node.lineno, "TEL007",
                    f"{emit}() without site= — the compile census joins "
                    f"observed compiles to the seam cache that "
                    f"should have absorbed them on the site label, so "
                    f"this emit lands as unscoped/unpriceable noise; "
                    f"pass site=... at the emit point — "
                    f"docs/observability.md §dispatchwatch"))
    return findings


def _run_rank_label_lint(root: pathlib.Path, files) -> list[Finding]:
    """TEL003: no hand-rolled ``rank=`` label on a raw registry call in
    multi-rank code."""
    findings: list[Finding] = []
    for path in files:
        rel = rel_path(path, root)
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 1, "TEL000",
                                    f"syntax error: {e.msg}"))
            continue
        except OSError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _call_name(node)
            if kind not in ("counter", "gauge", "histogram"):
                continue
            if any(kw.arg == "rank" for kw in node.keywords):
                findings.append(Finding(
                    rel, node.lineno, "TEL003",
                    f"hand-rolled rank label on {kind}() in a "
                    f"multi-rank code path — use telemetry.rank_{kind} "
                    f"so the `rank` label the mesh aggregator merges on "
                    f"stays one convention (docs/observability.md "
                    f"§Mesh shards)"))
    return findings


def run_telemetry_lint(root: pathlib.Path, overrides=None,
                       notes=None) -> list[Finding]:
    overrides = overrides or {}
    tel_files = override_files(overrides, "telemetry_files",
                               lambda: _package_py_files(root))
    findings: list[Finding] = list(_run_naming_lint(root, tel_files))
    rank_files = override_files(overrides, "rank_scope_files",
                                lambda: _rank_scope_files(root))
    findings.extend(_run_rank_label_lint(root, rank_files))
    bt_files = override_files(overrides, "blocktrace_scope_files",
                              lambda: _blocktrace_scope_files(root))
    findings.extend(_run_blocktrace_lint(root, bt_files))
    skew_files = override_files(overrides, "skew_scope_files",
                                lambda: _skew_scope_files(root))
    findings.extend(_run_skew_span_lint(root, skew_files))
    incident_files = override_files(overrides, "incident_scope_files",
                                    lambda: _incident_scope_files(root))
    findings.extend(_run_incident_lint(root, incident_files))
    compile_files = override_files(overrides, "compile_scope_files",
                                   lambda: _compile_scope_files(root))
    findings.extend(_run_compile_emit_lint(root, compile_files))
    sim_py = overrides.get("sim_py", root / REPO_PACKAGE / "simulation.py")
    rel = rel_path(sim_py, root)
    try:
        tree = ast.parse(sim_py.read_text(), filename=str(sim_py))
    except SyntaxError as e:
        return findings + [Finding(rel, e.lineno or 1, "TEL000",
                                   f"syntax error: {e.msg}")]
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or \
                _call_name(node) != "emit_event":
            continue
        payload = node.args[0] if node.args else None
        keys = _literal_str_keys(payload) if payload is not None else set()
        if keys is None:
            findings.append(Finding(
                rel, node.lineno, "TEL001",
                "emit_event on the simulation bus with a non-literal "
                "payload — the causal stamp cannot be verified; route "
                "the event through CausalLog.record, which stamps "
                "lamport/node automatically"))
        else:
            missing = [f for f in REQUIRED_FIELDS if f not in keys]
            if missing:
                findings.append(Finding(
                    rel, node.lineno, "TEL001",
                    f"sim-bus event omits causal field(s) "
                    f"{missing} — the forensics merge cannot place it; "
                    f"use CausalLog.record (stamps lamport/node) instead "
                    f"of raw emit_event"))
    return findings
