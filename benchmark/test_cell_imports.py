"""Nothing the benchmark loads imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import spec

PROBE = """
import json, sys
from benchmark import control, devtrace, harness, mining, rank, reference
from benchmark import replay, spec, world
for w in spec.load_spec()["workloads"]:
    c = spec.cell(w["name"])
    spec.load_module(spec.driver_file(c.traffic["driver"]))
    for m in c.end_to_end + c.per_layer:
        spec.load_module(spec.metric_file(m["name"]))
import mpi_blockchain_tpu_torch.models.fused
import mpi_blockchain_tpu_torch.models.miner
import mpi_blockchain_tpu_torch.parallel.distributed
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_no_jax_in_a_fresh_interpreter_after_the_harness_loads():
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "mpi_blockchain_tpu_torch" in top and "benchmark" in top
    assert not top & {"jax", "jaxlib", "flax", "mpi_blockchain_tpu"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    for path in spec.HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "mpi_blockchain_tpu"}, path


def test_the_reference_and_the_control_import_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "hashlib", "random", "struct",
               "torch", "argparse", "json", "sys", "time"}
    for name in ("reference.py", "control.py", "replay.py"):
        assert _imports(spec.HERE / name) <= allowed, name
