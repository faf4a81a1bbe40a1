"""The port's gate (``python -m mpi_blockchain_tpu_torch.gate``, ``make
check-torch``): one step for each prerequisite of the reference's
``make check``, its plan, its parse-only mode, its stop at the first
failure, its refusal to fall back to the CPU, and the card's test list.
Nothing here runs a smoke; ``--only lint`` runs the one fast step for real.
"""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from mpi_blockchain_tpu_torch import gate

ROOT = pathlib.Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
CARD_STEPS = {"opbudget-check", "transferbudget-check", "compile-smoke"}


def _cli(*args, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.gate", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)


def _make_rule(name: str) -> str:
    """A Makefile rule's prerequisites and recipe, continuation lines
    joined."""
    text = (ROOT / "Makefile").read_text().replace("\\\n", " ")
    m = re.search(rf"^{re.escape(name)}:(.*)$", text, re.MULTILINE)
    assert m, name
    return m.group(1)


def test_every_prerequisite_of_the_references_check_has_a_step():
    prerequisites = _make_rule("check").split()
    assert len(prerequisites) == 17 and prerequisites[0] == "lint"
    by_reference = [s.reference for s in gate.STEPS if s.reference]
    # One step each, in the reference's order; the port's own extra step
    # (the transfer census) has no reference target.
    assert by_reference == prerequisites
    assert [s.name for s in gate.STEPS if s.reference is None] == \
        ["transferbudget-check"]
    assert {s.name for s in gate.STEPS if s.card_only} == CARD_STEPS
    assert len({s.name for s in gate.STEPS}) == len(gate.STEPS)


def test_the_makefile_target_calls_the_gate():
    assert _make_rule("check-torch").strip() == \
        "; $(PY) -m mpi_blockchain_tpu_torch.gate --device $(DEVICE)"
    text = (ROOT / "Makefile").read_text()
    assert re.search(r"^DEVICE \?= cuda$", text, re.MULTILINE)
    assert re.search(r"^\.PHONY: check-torch$", text, re.MULTILINE)


def test_list_prints_the_plan_on_the_cpu():
    proc = _cli("--list", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split(":")[1].strip() for ln in lines] == \
        [s.name for s in gate.STEPS]
    for step, ln in zip(gate.STEPS, lines):
        if step.name in CARD_STEPS:
            assert "not run on cpu" in ln
            continue
        runs = ln.split(": ", 2)[2].split(" && ")
        assert len(runs) == len(step.runs_for("cpu"))
        for run, text in zip(step.runs_for("cpu"), runs):
            assert text.startswith(run.render(["python", "-m",
                                                run.module]))
            assert text.endswith("--device cpu") == run.device
    tier1 = lines[-1]
    assert tier1.startswith("gate: tier1: JAX_PLATFORMS=cpu python -m "
                            "pytest ")
    assert "-m 'not slow'" in tier1
    assert all(str(p.relative_to(ROOT)) in tier1
               for p in TESTS.glob("test_torch_*.py"))


def test_list_on_the_card_names_the_card_files_without_conftest():
    proc = _cli("--list", "--only", "tier1,compile-smoke")
    assert proc.returncode == 0, proc.stderr
    tier1 = proc.stdout.splitlines()[-1]
    assert "--noconftest" in tier1 and "-m cuda" in tier1
    assert all(f in tier1 for f in gate.CARD_TEST_FILES)
    assert "dispatchwatch smoke" in proc.stdout


def test_resolve_parses_every_cpu_step_with_its_own_parser():
    proc = _cli("--resolve", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = {ln.split(":")[1].strip(): ln for ln in proc.stdout.splitlines()
             if ln.startswith("gate: ") and ln.count(":") >= 2}
    for step in gate.STEPS:
        want = "not run on cpu" if step.name in CARD_STEPS else "resolves"
        assert want in lines[step.name], lines[step.name]


@pytest.mark.parametrize("args,why", [
    (("--steps", "x"), "refused the arguments"),
    (("--device", "gpu"), "refused the arguments")])
def test_resolve_reports_arguments_a_parser_refuses(args, why):
    run = gate.Run("mpi_blockchain_tpu_torch.telemetry", args, device=False)
    assert why in gate.resolve_run(run, "cpu")
    assert gate.resolve_run(gate.Run("pytest", ("-q", "--bogus",
                                                "tests/test_torch_gate.py"),
                                     device=False), "cpu")
    assert gate.resolve_run(gate.Run("pytest", ("tests/nope.py",),
                                     device=False), "cpu")


def test_a_failing_step_stops_the_gate_with_its_rc(tmp_path, monkeypatch,
                                                   capsys):
    (tmp_path / "gate_ok.py").write_text("print('ok')\n")
    (tmp_path / "gate_fail.py").write_text("import sys\nsys.exit(3)\n")
    marker = tmp_path / "ran"
    (tmp_path / "gate_mark.py").write_text(
        f"open({str(marker)!r}, 'w').close()\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(gate, "STEPS", tuple(
        gate.Step(name, None, (gate.Run(module, device=False),))
        for name, module in (("first", "gate_ok"), ("second", "gate_fail"),
                             ("third", "gate_mark"))))
    assert gate.main(["--device", "cpu"]) == 3
    out = capsys.readouterr().out
    assert re.search(r"^gate: first: rc 0 in [\d.]+ s: .*gate_ok$", out,
                     re.MULTILINE)
    assert re.search(r"^gate: second: rc 3 in ", out, re.MULTILINE)
    assert "third" not in out and not marker.exists()


def test_a_failing_check_fails_its_step(tmp_path, monkeypatch, capsys):
    (tmp_path / "gate_ok.py").write_text("print('mining_rounds_total 1')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(gate, "STEPS", (gate.Step(
        "metrics", None, (gate.Run("gate_ok", device=False),),
        check=gate._metrics),))
    assert gate.main(["--device", "cpu"]) == 1
    assert "required metrics missing" in capsys.readouterr().err


def test_no_card_exits_2_and_never_falls_back_to_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for args in ((), ("--only", "lint"), ("--resolve",)):
        proc = _cli(*args, env=env)
        assert proc.returncode == 2, proc.stdout + proc.stderr
        error = json.loads(proc.stdout.strip().splitlines()[-1])
        assert "no CUDA device is available" in error["error"]
        assert "--device cpu" in error["error"]
        assert "rc " not in proc.stdout and "resolves" not in proc.stdout


def _file_of(name: str) -> pathlib.Path | None:
    """The repo's source file of a module name (a package's __init__)."""
    for base in (ROOT, TESTS):
        p = base.joinpath(*name.split("."))
        if p.with_suffix(".py").is_file():
            return p.with_suffix(".py")
        if (p / "__init__.py").is_file():
            return p / "__init__.py"
    return None


def _module_level(tree: ast.Module):
    """The nodes that run when a module is imported: function bodies cut
    (their imports are lazy)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
            stack.extend(ast.iter_child_nodes(node))


def _reaches_jax(path: pathlib.Path, seen: set) -> bool:
    """Whether importing ``path`` imports jax, following the module-level
    imports into the repo's own modules (tests and both packages)."""
    if path in seen:
        return False
    seen.add(path)
    base = TESTS if path.parent == TESTS else ROOT
    package = list(path.relative_to(base).with_suffix("").parts)[:-1]
    names = []
    for node in _module_level(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            parts = package[:len(package) + 1 - node.level] \
                if node.level else []
            module = ".".join(parts + ([node.module] if node.module else []))
            names += [module] + [f"{module}.{a.name}" for a in node.names]
    for name in names:
        parts = name.split(".")
        if parts[0] in ("jax", "jaxlib"):
            return True
        for i in range(1, len(parts) + 1):
            f = _file_of(".".join(parts[:i]))
            if f is not None and _reaches_jax(f, seen):
                return True
    return False


def _has_cuda_mark(path: pathlib.Path) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "cuda"
               and isinstance(n.value, ast.Attribute)
               and n.value.attr == "mark"
               for n in ast.walk(ast.parse(path.read_text())))


def test_the_card_files_are_the_jax_free_files_with_card_tests():
    card = {str(p.relative_to(ROOT)) for p in TESTS.glob("test_torch_*.py")
            if _has_cuda_mark(p) and not _reaches_jax(p, set())}
    assert card == set(gate.CARD_TEST_FILES)
    assert list(gate.CARD_TEST_FILES) == sorted(gate.CARD_TEST_FILES)
    # The scan sees jax behind the reference's modules: these files hold
    # no card test but reach jax through what they import.
    for name in ("test_torch_fused.py", "test_torch_sweep.py"):
        assert _reaches_jax(TESTS / name, set()), name


def test_readme_names_the_card_files():
    readme = (ROOT / "README.md").read_text()
    section = readme[readme.index("### The port's gate"):]
    section = section[:section.index("\n## ")]
    command = section[section.index("python -m pytest --noconftest"):]
    command = command[:command.index("```")]
    assert re.findall(r"tests/test_torch_\w+\.py", command) == \
        list(gate.CARD_TEST_FILES)


def test_only_lint_runs_for_real_on_the_cpu():
    proc = _cli("--only", "lint", "--device", "cpu", timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"^gate: lint: rc 0 in [\d.]+ s: .*"
                     r"mpi_blockchain_tpu_torch\.analysis --jobs 4 "
                     r"--audit-suppressions$", proc.stdout, re.MULTILINE)
    assert "gate: passed 1 step(s) on cpu" in proc.stdout
    with pytest.raises(SystemExit):
        gate.main(["--only", "nope", "--device", "cpu"])


def test_the_gate_imports_only_the_standard_library():
    code = ("import sys\nimport mpi_blockchain_tpu_torch.gate\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'torch', 'numpy', 'mpi_blockchain_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
