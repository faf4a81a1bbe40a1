"""The port's one-command gate: lint, budgets, smokes and tests, in order.

The counterpart of the reference's ``make check`` (``Makefile``,
``check:``): each of its prerequisites has a step here that runs the
port's CLI for it, with the same assertions where the reference's recipe
holds them inline (the telemetry snapshot's needles, the forensics
report's fork tree and trace rows, the adversarial sim's determinism and
attack audit). Every step runs as a subprocess from the repo's root, and
the gate stops at the first one that fails, with that step's exit code.

    python -m mpi_blockchain_tpu_torch.gate                # on the card
    python -m mpi_blockchain_tpu_torch.gate --device cpu   # no card
    python -m mpi_blockchain_tpu_torch.gate --list         # the plan
    python -m mpi_blockchain_tpu_torch.gate --resolve      # parse, run nothing
    python -m mpi_blockchain_tpu_torch.gate --only lint,tier1
    make check-torch [DEVICE=cpu]

Like every entry point of the port it runs on the card unless it is given
``--device cpu``; with no card it exits 2 with the port's ``ConfigError``
text and never falls back to the CPU. On the CPU the smokes mine with the
C++ sweep and the plain torch sweep. Three steps have no CPU run, and the
gate says so when it passes them: the two card-side censuses
(``opbudget-check``, ``transferbudget-check``; the ``lint`` step's
``opbudget`` and ``trb`` families hold their static halves everywhere) and
``compile-smoke`` (``dispatchwatch smoke``, whose census is of the card's
nvcc builds). ``tier1`` runs the port's tests: all of
``tests/test_torch_*.py`` on the CPU, and on the card the ``cuda``-marked
tests of ``CARD_TEST_FILES`` with ``--noconftest`` (the root conftest
imports jax, which the card's machine lacks).

``--resolve`` imports each step's module and parses its arguments with
that module's own parser (pytest's for ``tier1``), without running it.

One line a step goes to stdout: its name, exit code, wall seconds and the
commands it ran. This module imports only the standard library.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import pathlib
import re
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "mpi_blockchain_tpu_torch"
DEVICES = ("cuda", "cpu")

#: The port's test files that hold ``cuda``-marked tests and import no jax,
#: not even through the modules they import: what ``tier1`` runs on the
#: card, with ``--noconftest``.
CARD_TEST_FILES = (
    "tests/test_torch_analysis.py",
    "tests/test_torch_bench_cuda.py",
    "tests/test_torch_budgets.py",
    "tests/test_torch_elastic_cuda.py",
    "tests/test_torch_fused_cuda.py",
    "tests/test_torch_fused_world_cuda.py",
    "tests/test_torch_mesh_cuda.py",
    "tests/test_torch_parallel_cuda.py",
    "tests/test_torch_resilience_cuda.py",
    "tests/test_torch_sentinel_cuda.py",
    "tests/test_torch_service_cuda.py",
    "tests/test_torch_sim_cuda.py",
    "tests/test_torch_sweep_cuda.py",
    "tests/test_torch_trace_cuda.py",
)
#: Stand-ins in a run's arguments: every port test file, the card files.
PORT_TESTS = "tests/test_torch_*.py"
CARD_TESTS = "<CARD_TEST_FILES>"

#: What the reference's ``metrics-smoke`` greps the snapshot for.
METRICS_NEEDLES = (r"^mining_rounds_total", r"^hashes_tried_total", r"_count")

# A module whose ``__main__`` runs its CLI on import: its parser lives here.
_ENTRIES = {PKG: f"{PKG}.cli"}


@dataclasses.dataclass(frozen=True)
class Run:
    """One subprocess of a step: ``python -m module args``. ``{tmp}`` in an
    argument is the step's scratch directory; ``device`` appends
    ``--device D``; ``only`` restricts the run to one device."""
    module: str
    args: tuple[str, ...] = ()
    device: bool = True
    only: str | None = None
    env: tuple[tuple[str, str], ...] = ()

    def argv(self, device: str, tmp: str) -> list[str]:
        args: list[str] = []
        for a in self.args:
            if a == PORT_TESTS:
                args += sorted(str(p.relative_to(ROOT)) for p in
                               ROOT.glob(PORT_TESTS))
            elif a == CARD_TESTS:
                args += CARD_TEST_FILES
            else:
                args.append(a.format(tmp=tmp))
        if self.device:
            args += ["--device", device]
        return [sys.executable, "-m", self.module, *args]

    def render(self, argv: list[str]) -> str:
        """The command as a shell would run it, its environment first."""
        return shlex.join([f"{k}={v}" for k, v in self.env] + argv)


@dataclasses.dataclass(frozen=True)
class Step:
    """One prerequisite of the reference's ``check:`` (``reference``; None
    for a step of the port's own), its runs, and the recipe's inline
    assertions (``check``: the runs' stdouts and the scratch directory ->
    a failure, or None). ``card_only`` says why the step has no CPU run."""
    name: str
    reference: str | None
    runs: tuple[Run, ...]
    check: Callable[[list[str], pathlib.Path], str | None] | None = None
    card_only: str | None = None
    timeout_s: float = 900.0

    def runs_for(self, device: str) -> list[Run]:
        return [r for r in self.runs if r.only in (None, device)]


def _metrics(outs: list[str], tmp: pathlib.Path) -> str | None:
    missing = [n for n in METRICS_NEEDLES
               if not re.search(n, outs[0], re.MULTILINE)]
    return f"required metrics missing: {missing}" if missing else None


def _forensics(outs: list[str], tmp: pathlib.Path) -> str | None:
    report = json.loads(outs[1])
    trace = json.loads((tmp / "trace.json").read_text())
    tree = report["fork_tree"]
    pids = {e["pid"] for e in trace["traceEvents"] if e["ph"] == "X"}
    if not tree["blocks"]:
        return "empty fork tree"
    if not tree["fork_points"]:
        return "no fork reconstructed"
    if report["convergence"]["reorgs"] < 1:
        return "no reorg audited"
    if len(pids) < 4:
        return f"trace rows missing: {sorted(pids)}"
    return None


def _adversary(outs: list[str], tmp: pathlib.Path) -> str | None:
    if (tmp / "a.json").read_bytes() != (tmp / "b.json").read_bytes():
        return "same-seed causal dumps differ"
    if not re.search(r"^sim_sync_rejected_total [1-9]",
                     (tmp / "metrics.txt").read_text(), re.MULTILINE):
        return "sim_sync_rejected_total not exercised"
    report = json.loads(outs[2])
    audit = report["attack_audit"]
    s, e, f = audit["selfish"][0], audit["eclipse"][0], audit["flood"][0]
    fails = {
        "no fork tree": report["fork_tree"]["blocks"]
        and report["fork_tree"]["fork_points"],
        "nothing withheld or released": s["withheld_total"] > 0
        and s["released_total"] > 0,
        "no release reorged": any(r["reorgs_caused"]
                                  for r in s["releases"]),
        "eclipse victim stuck": e["victim_tip_canonical"]
        and e["post_heal_adopt"],
        "floods not rejected with chains untouched": f["rejections"] > 0
        and f["chains_untouched"],
        f"rejections by path {f['rejections_by_path']}":
            set(f["rejections_by_path"]) == {"budget", "linkage", "bits"},
    }
    bad = [what for what, ok in fails.items() if not ok]
    return "; ".join(bad) or None


_CENSUS_ON_CPU = ("its traced section is taken on the card ({what}); on the "
                  "CPU the lint step's {family} family holds its static half")

STEPS: tuple[Step, ...] = (
    Step("lint", "lint", (Run(f"{PKG}.analysis",
                              ("--jobs", "4", "--audit-suppressions"),
                              device=False),), timeout_s=600),
    Step("opbudget-check", "opbudget-check",
         (Run(f"{PKG}.analysis.opbudget", ("--check",), device=False),),
         card_only=_CENSUS_ON_CPU.format(
             what="the SASS census of the sweep's loop", family="opbudget"),
         timeout_s=600),
    Step("transferbudget-check", None,
         (Run(f"{PKG}.analysis.transfer_budget", ("--check",),
              device=False),),
         card_only=_CENSUS_ON_CPU.format(
             what="the memcpy census the profiler records", family="trb"),
         timeout_s=600),
    Step("shardbudget-check", "shardbudget-check",
         (Run(f"{PKG}.analysis.shard_budget", ("--check",)),),
         timeout_s=600),
    Step("metrics-smoke", "metrics-smoke",
         (Run(f"{PKG}.telemetry", ("--steps", "3")),), check=_metrics),
    Step("forensics-smoke", "forensics-smoke", (
        Run(PKG, ("sim", "--groups", "3", "--drop-rate", "20", "--seed",
                  "3", "--blocks", "4", "--partition-steps", "12",
                  "--events-dump", "{tmp}/causal.json")),
        Run(f"{PKG}.forensics", ("--events", "{tmp}/causal.json",
                                 "--trace", "{tmp}/trace.json", "--json"),
            device=False)), check=_forensics),
    Step("perf-smoke", "perf-smoke", (Run(f"{PKG}.perfwatch", ("smoke",)),)),
    Step("chaos-smoke", "chaos-smoke",
         (Run(f"{PKG}.resilience", ("smoke",)),)),
    Step("adversary-smoke", "adversary-smoke", (
        Run(PKG, ("sim", "--preset", "adversarial-smoke", "--events-dump",
                  "{tmp}/a.json", "--metrics-dump", "{tmp}/metrics.txt")),
        Run(PKG, ("sim", "--preset", "adversarial-smoke", "--events-dump",
                  "{tmp}/b.json")),
        Run(f"{PKG}.forensics", ("--events", "{tmp}/a.json", "--json"),
            device=False)), check=_adversary),
    Step("meshwatch-smoke", "meshwatch-smoke",
         (Run(f"{PKG}.meshwatch", ("smoke",)),)),
    Step("elastic-smoke", "elastic-smoke",
         (Run(f"{PKG}.resilience", ("elastic-smoke",)),)),
    Step("trace-smoke", "trace-smoke",
         (Run(f"{PKG}.blocktrace", ("smoke",)),)),
    # The bubble audit mines on the C++ sweep on every machine (its
    # module's docstring says why), so it takes no --device.
    Step("pipeline-smoke", "pipeline-smoke",
         (Run(f"{PKG}.meshwatch", ("pipeline-smoke",), device=False),)),
    Step("skew-smoke", "skew-smoke",
         (Run(f"{PKG}.meshwatch", ("skew-smoke",)),)),
    Step("incident-smoke", "incident-smoke",
         (Run(f"{PKG}.chainwatch", ("smoke",)),)),
    Step("compile-smoke", "compile-smoke",
         (Run(f"{PKG}.dispatchwatch", ("smoke",), device=False),),
         card_only="dispatchwatch smoke has no CPU mode: its census is of "
                   "the card's nvcc builds (ROADMAP, deliberate "
                   "differences)"),
    Step("serve-smoke", "serve-smoke",
         (Run(f"{PKG}.service", ("smoke",)),)),
    Step("tier1", "tier1", (
        Run("pytest", (PORT_TESTS, "-q", "-m", "not slow", "-p",
                       "no:cacheprovider"), device=False, only="cpu",
            env=(("JAX_PLATFORMS", "cpu"),)),
        Run("pytest", ("--noconftest", "-q", "-m", "cuda", "-p",
                       "no:cacheprovider", CARD_TESTS), device=False,
            only="cuda")), timeout_s=3000),
)

_CARD_PROBE = (
    "import json, sys\n"
    "from mpi_blockchain_tpu_torch.backend.cuda import resolve_device\n"
    "from mpi_blockchain_tpu_torch.config import ConfigError\n"
    "try:\n"
    "    resolve_device('cuda')\n"
    "except ConfigError as e:\n"
    "    print(json.dumps({'event': 'error', 'error': str(e)},"
    " sort_keys=True))\n"
    "    sys.exit(2)\n"
    "import torch\n"
    "print(torch.cuda.get_device_name(0))\n")


def _env(run: Run) -> dict[str, str]:
    path = os.pathsep.join(p for p in (str(ROOT), os.environ.get(
        "PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, **dict(run.env))


def _call(argv: list[str], env: dict, timeout: float
          ) -> tuple[int, str, str]:
    """Runs ``argv`` from the repo's root in a session of its own (the
    smokes start rank processes; a timeout kills them all): rc (124 on the
    timeout), stdout, stderr."""
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err + f"\ntimed out after {timeout:.0f} s"


def card_name() -> tuple[int, str]:
    """(0, the card's name, and nvidia-smi's name and power limit where it
    is installed), or (2, the port's ConfigError line) with no card."""
    rc, out, err = _call([sys.executable, "-c", _CARD_PROBE],
                         dict(os.environ, PYTHONPATH=str(ROOT)), 300)
    if rc != 0:
        return rc, (out.strip() or err.strip()[-2000:])
    name = out.strip()
    smi = shutil.which("nvidia-smi")
    if smi:
        q = subprocess.run([smi, "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        name += f" ({q.stdout.strip()})"
    return 0, name


def run_step(step: Step, device: str) -> tuple[int, list[str], float]:
    """Runs a step's commands in order, stopping at the first that fails,
    then its check. Returns (rc, the command lines, wall s)."""
    t0 = time.perf_counter()
    lines, outs = [], []
    deadline = t0 + step.timeout_s
    with tempfile.TemporaryDirectory(prefix=f"gate_{step.name}_") as tmp:
        for run in step.runs_for(device):
            argv = run.argv(device, tmp)
            lines.append(run.render(argv))
            rc, out, err = _call(argv, _env(run),
                                 max(1.0, deadline - time.perf_counter()))
            outs.append(out)
            if rc != 0:
                print(f"gate: {step.name}: {lines[-1]} exited {rc}"
                      f"\n--- stdout (tail)\n{out[-3000:]}\n--- stderr "
                      f"(tail)\n{err[-3000:]}", file=sys.stderr)
                return rc, lines, time.perf_counter() - t0
        if step.check is not None:
            try:
                failure = step.check(outs, pathlib.Path(tmp))
            except (OSError, ValueError, KeyError, IndexError,
                    TypeError) as e:
                failure = f"{type(e).__name__}: {e}"
            if failure:
                print(f"gate: {step.name}: assertions failed: {failure}",
                      file=sys.stderr)
                return 1, lines, time.perf_counter() - t0
    return 0, lines, time.perf_counter() - t0


class _Parsed(BaseException):
    """Raised in place of running a CLI once its parser has parsed."""


def resolve_run(run: Run, device: str) -> str | None:
    """Parses ``run``'s arguments with its module's own parser, running
    nothing: None when they parse, else why not."""
    args = run.argv(device, "/nonexistent")[3:]
    if run.module == "pytest":
        from _pytest.config import get_config
        from _pytest.config.exceptions import UsageError

        missing = [a for a in args if a.endswith(".py")
                   and not (ROOT / a).is_file()]
        if missing or not any(a.endswith(".py") for a in args):
            return f"test files missing: {missing or 'none given'}"
        try:
            get_config(list(args))._parser.parse(list(args))
        except UsageError as e:
            return f"pytest refused the arguments: {e}"
        return None
    entry = _ENTRIES.get(run.module, run.module)
    module = importlib.import_module(entry)
    if not hasattr(module, "main"):
        module = importlib.import_module(f"{entry}.__main__")
    parse_args = argparse.ArgumentParser.parse_args

    def parsed(self, args=None, namespace=None):
        parse_args(self, args, namespace)
        raise _Parsed

    argparse.ArgumentParser.parse_args = parsed
    try:
        module.main(list(args))
    except _Parsed:
        return None
    except SystemExit as e:
        return f"its parser refused the arguments (exit {e.code})"
    finally:
        argparse.ArgumentParser.parse_args = parse_args
    return "its main returned without parsing its arguments"


def _describe(step: Step, device: str) -> str:
    if device == "cpu" and step.card_only:
        return f"not run on cpu: {step.card_only}"
    return " && ".join(r.render(["python", *r.argv(device, "TMP")[1:]])
                       for r in step.runs_for(device))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {PKG}.gate",
        description="the port's gate: chainlint, the budget checks, the "
                    "smokes and the port's tests, in order, stopping at "
                    "the first failure (the reference's `make check`)")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where the steps run: the card, or the CPU "
                             "only when asked for")
    parser.add_argument("--list", action="store_true",
                        help="print the plan and exit")
    parser.add_argument("--resolve", action="store_true",
                        help="parse each step's arguments with its "
                             "module's own parser; run nothing")
    parser.add_argument("--only", default=None, metavar="STEP,...",
                        help="run these steps only, in the gate's order")
    args = parser.parse_args(argv)
    only = None
    if args.only is not None:
        only = [s.strip() for s in args.only.split(",") if s.strip()]
        unknown = sorted(set(only) - {s.name for s in STEPS})
        if unknown:
            parser.error(f"unknown steps {unknown}; have "
                         f"{[s.name for s in STEPS]}")
    steps = [s for s in STEPS if only is None or s.name in only]
    if args.list:
        for step in steps:
            print(f"gate: {step.name}: {_describe(step, args.device)}")
        return 0
    if args.device == "cuda":
        rc, name = card_name()
        if rc != 0:
            print(name)
            return rc
        print(f"gate: device cuda: {name}")
    else:
        print("gate: device cpu")
    t0 = time.perf_counter()
    for step in steps:
        if args.device == "cpu" and step.card_only:
            print(f"gate: {step.name}: not run on cpu: {step.card_only}")
            continue
        if args.resolve:
            why = [w for r in step.runs_for(args.device)
                   if (w := resolve_run(r, args.device))]
            print(f"gate: {step.name}: "
                  f"{'; '.join(why) if why else 'resolves'}: "
                  f"{_describe(step, args.device)}")
            if why:
                return 2
            continue
        rc, lines, wall = run_step(step, args.device)
        print(f"gate: {step.name}: rc {rc} in {wall:.1f} s: "
              f"{' && '.join(lines)}", flush=True)
        if rc != 0:
            return rc
    print(f"gate: {'resolved' if args.resolve else 'passed'} "
          f"{len(steps)} step(s) on {args.device} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
