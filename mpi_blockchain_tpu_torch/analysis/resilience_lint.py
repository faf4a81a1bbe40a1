"""RES rules — swallow-proof fault handling + byte-reproducible attacks.

The resilience layer's whole premise is that dispatch and I/O failures
reach ONE sanctioned decision point (``resilience/policy.py``'s
``call_with_retry`` — retry, degrade, or raise ``RetryExhausted``)
instead of dying silently where they happened. The classic drift bug is
a future edit dropping an ``except Exception: pass`` around a device
call or a checkpoint write "to be safe" — which converts a detectable
fault into silent corruption or a silent stall, the exact failure class
the resilience layer exists to kill.

  RES001  in a dispatch/IO-path module, an exception handler that
          swallows broadly: a bare ``except:`` (catches SystemExit /
          KeyboardInterrupt) that does not re-raise, or an
          ``except Exception:`` / ``except BaseException:`` (alone or
          in a tuple) whose body is only ``pass`` / ``continue`` /
          ``...``. Handle the specific exception, let it propagate to
          the policy layer, or at minimum record it (a counter, an
          event, a warning) before moving on.

  RES002  in the adversarial-simulation package (``sim/`` — scenario,
          engine, strategies, live-bus attackers), any randomness or
          time source OUTSIDE the seeded scenario RNG: importing
          ``random``/``secrets``/``uuid``, calling ``os.urandom``,
          reading the wall clock (``time.time``/``monotonic``/
          ``perf_counter``/``*_ns``, ``datetime.now``/``utcnow``/
          ``today``), or numpy's STATEFUL global RNG surface
          (``np.random.seed``/``random``/``rand``/``randint``/...).
          Every attack decision must come from the scenario seed
          through ``ScenarioRng`` (crc32 / keyed Philox) — that is
          what keeps a 1000-node adversarial run byte-reproducible,
          the property the chaos/adversary smoke gates assert.

Scope: RES001 covers the port's dispatch/IO surface — the reference's
list mapped onto the port (``backend/``, ``core/build.py``,
``core/_ctypes_binding.py``, ``utils/checkpoint.py``, ``simulation.py``,
``models/``, ``parallel/distributed.py``, ``service/``) plus what the port
adds to it: ``ops/sha256_cuda.py`` and ``ops/sha256_block.py``, where the
CUDA library is built with nvcc, bound with ctypes and launched (the
reference's kernels were traced by jax, with no IO of their own)
(override key ``resilience_files``). RES002 covers
``mpi_blockchain_tpu_torch/sim/`` (override key ``adversary_files``). The
sanctioned swallow point ``resilience/policy.py`` is deliberately outside
both scopes.
"""
from __future__ import annotations

import ast
import pathlib

from . import DOC, REPO_PACKAGE, Finding, override_files, rel_path

_PKG = REPO_PACKAGE

#: Repo-relative dispatch/IO paths RES001 covers (files or directories).
DISPATCH_IO_PATHS = (
    f"{_PKG}/backend",
    f"{_PKG}/core/build.py",
    f"{_PKG}/core/_ctypes_binding.py",
    f"{_PKG}/utils/checkpoint.py",
    f"{_PKG}/simulation.py",
    f"{_PKG}/models",
    f"{_PKG}/parallel/distributed.py",
    # The front door's admission/rebuild paths are dispatch IO — a
    # swallowed failure there is a silently dropped transaction.
    f"{_PKG}/service",
    # The port's own dispatch IO: the CUDA library's nvcc build, ctypes
    # binding and launches (a swallowed launch error is a sweep that
    # silently found nothing).
    f"{_PKG}/ops/sha256_cuda.py",
    f"{_PKG}/ops/sha256_block.py",
)

_BROAD = ("Exception", "BaseException")


def _expr_name(node: ast.expr) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):   # builtins.Exception etc.
        return node.attr
    return None


def _catches_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True   # bare except:
    if isinstance(t, ast.Tuple):
        return any(_expr_name(e) in _BROAD for e in t.elts)
    return _expr_name(t) in _BROAD


def _body_swallows(body: list[ast.stmt]) -> bool:
    """True when the handler body does nothing observable: only pass /
    continue / bare `...` — no raise, no logging, no assignment."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Constant) and \
                stmt.value.value is Ellipsis:
            continue
        return False
    return True


def _reraises(body: list[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Raise)
               for stmt in body for n in ast.walk(stmt))


def _scan_file(root: pathlib.Path, path: pathlib.Path) -> list[Finding]:
    rel = rel_path(path, root)
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, "RES000",
                        f"syntax error: {e.msg}")]
    except OSError:
        return []
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            # A bare except that re-raises is a (crude) cleanup idiom;
            # one that does not is a black hole for SIGINT and bugs.
            if not _reraises(node.body):
                findings.append(Finding(
                    rel, node.lineno, "RES001",
                    "bare 'except:' in a dispatch/IO path swallows "
                    "everything incl. KeyboardInterrupt — catch the "
                    "specific exception or route it through the "
                    f"resilience policy layer (call_with_retry; {DOC} "
                    f"§RES)"))
        elif _catches_broad(node) and _body_swallows(node.body):
            findings.append(Finding(
                rel, node.lineno, "RES001",
                "'except Exception: pass' in a dispatch/IO path turns a "
                "detectable fault into silent corruption/stall — handle "
                "it, record it (counter/event), or let it reach the "
                f"resilience policy layer ({DOC} §RES)"))
    return findings


def _scoped_files(root: pathlib.Path) -> list[pathlib.Path]:
    files: list[pathlib.Path] = []
    for entry in DISPATCH_IO_PATHS:
        p = root / entry
        if p.is_dir():
            files.extend(sorted(q for q in p.rglob("*.py")
                                if "__pycache__" not in q.parts))
        elif p.exists():
            files.append(p)
    return files


# ---- RES002: seeded-RNG-only adversary paths ------------------------------

#: The adversarial-simulation package RES002 covers.
ADVERSARY_PATHS = (f"{_PKG}/sim",)

#: Modules whose mere import is nondeterminism on an attack path.
_BANNED_MODULES = {"random", "secrets", "uuid"}

#: attribute-call chains that read the wall clock or OS entropy.
_BANNED_CALLS = {
    ("time", "time"), ("time", "monotonic"), ("time", "perf_counter"),
    ("time", "time_ns"), ("time", "monotonic_ns"),
    ("time", "perf_counter_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("os", "urandom"), ("os", "getrandom"),
}

#: numpy's STATEFUL global-RNG surface (np.random.<name>(...)). The
#: counter-based constructors (Philox/Generator/SeedSequence/PCG64 and
#: a SEEDED default_rng) stay legal — they are how ScenarioRng works.
_BANNED_NP_RANDOM = {
    "seed", "random", "rand", "randn", "randint", "random_sample",
    "uniform", "normal", "choice", "shuffle", "permutation", "bytes",
}


def _dotted(node: ast.expr) -> list[str]:
    """['np', 'random', 'seed'] for np.random.seed — [] when not a
    plain attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _scan_adversary_file(root: pathlib.Path,
                         path: pathlib.Path) -> list[Finding]:
    rel = rel_path(path, root)
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, "RES000",
                        f"syntax error: {e.msg}")]
    except OSError:
        return []
    findings: list[Finding] = []

    def flag(line: int, what: str) -> None:
        findings.append(Finding(
            rel, line, "RES002",
            f"{what} in an adversary/scenario path breaks "
            f"byte-reproducibility — draw from the seeded ScenarioRng "
            f"(crc32 / keyed Philox) instead"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] in _BANNED_MODULES:
                    flag(node.lineno, f"import of {alias.name!r}")
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] \
                    in _BANNED_MODULES:
                flag(node.lineno, f"import from {node.module!r}")
            elif node.module:
                # Bare from-imports of banned members (`from time
                # import time`) would otherwise dodge the dotted-call
                # check below — flag them at the import site.
                mod = node.module.split(".")[0]
                for alias in node.names:
                    if (mod, alias.name) in _BANNED_CALLS:
                        flag(node.lineno,
                             f"from-import of wall-clock/entropy "
                             f"{mod}.{alias.name}")
        elif isinstance(node, ast.Call):
            parts = _dotted(node.func)
            if not parts:
                continue
            tail = tuple(parts[-2:])
            if len(parts) >= 2 and tail in _BANNED_CALLS:
                flag(node.lineno, f"wall-clock/entropy call "
                                  f"{'.'.join(parts)}()")
            elif len(parts) >= 3 and parts[-2] == "random" and \
                    parts[-1] in _BANNED_NP_RANDOM:
                flag(node.lineno, f"stateful global-RNG call "
                                  f"{'.'.join(parts)}()")
            elif parts[-1] == "default_rng" and not node.args \
                    and not node.keywords:
                # Bare (from-imported) calls too: len(parts) may be 1.
                flag(node.lineno, "unseeded default_rng() (OS "
                                  "entropy)")
    return findings


def _adversary_files(root: pathlib.Path) -> list[pathlib.Path]:
    files: list[pathlib.Path] = []
    for entry in ADVERSARY_PATHS:
        p = root / entry
        if p.is_dir():
            files.extend(sorted(q for q in p.rglob("*.py")
                                if "__pycache__" not in q.parts))
        elif p.exists():
            files.append(p)
    return files


def run_resilience_lint(root: pathlib.Path, overrides=None,
                        notes=None) -> list[Finding]:
    overrides = overrides or {}
    files = override_files(overrides, "resilience_files",
                           lambda: _scoped_files(root))
    findings: list[Finding] = []
    for path in files:
        findings.extend(_scan_file(root, path))
    adversary = override_files(overrides, "adversary_files",
                               lambda: _adversary_files(root))
    for path in adversary:
        findings.extend(_scan_adversary_file(root, pathlib.Path(path)))
    return findings
