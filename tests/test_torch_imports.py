"""The port stands alone: no file of ``mpi_blockchain_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the reference package,
and importing the port never loads jax."""
import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mpi_blockchain_tpu_torch"


def _port_files() -> list[pathlib.Path]:
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    return [f for f in files if "build" not in f.relative_to(REPO).parts]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mpi_blockchain_tpu")


def test_no_jax_or_reference_import_anywhere_in_the_port():
    found = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                      for n in names if _forbidden(n)]
    assert len(_port_files()) > 10
    scanned = {f.relative_to(PORT).parts[0] for f in _port_files()
               if PORT in f.parents}
    assert {"service", "perfwatch", "chainwatch", "telemetry", "models",
            "sim", "resilience", "ops", "backend", "blocktrace",
            "meshwatch", "meshprof", "dispatchwatch", "forensics"} <= scanned
    assert {"meshwatch/shard.py", "meshwatch/aggregate.py",
            "meshwatch/server.py", "meshwatch/bubble.py",
            "meshwatch/world.py", "meshwatch/__main__.py",
            "meshprof/analyzer.py", "blocktrace/export.py",
            "blocktrace/__main__.py", "chainwatch/__main__.py",
            "resilience/elastic.py", "forensics/__init__.py",
            "forensics/__main__.py", "forensics/merge.py",
            "forensics/fork_tree.py", "forensics/attack_audit.py",
            "forensics/trace_export.py"} <= {
        str(f.relative_to(PORT)) for f in _port_files() if PORT in f.parents}
    assert found == []


def test_importing_every_port_module_leaves_jax_out():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in _port_files()
        if p.parent != REPO and p.name != "__main__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'mpi_blockchain_tpu')]\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
