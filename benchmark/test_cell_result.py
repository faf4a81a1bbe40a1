"""The result line, and the runs that must print none."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_the_last_line_s_keys(tiny):
    c = tiny("t-fused")
    result, rc = harness.run(c.name, 2**31 + 12345, 0.05, False,
                             device="cpu", cell=c)
    assert rc == 0 and list(result)[:5] == KEYS
    assert list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 8
    for name, v in result["compared"].items():
        assert v == {"value": 0, "limit": 0}, name
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.dumps(result)


def test_the_traced_line_has_the_trace_s_keys(tiny):
    c = tiny("t-fused")
    result, rc = harness.run(c.name, 9, 0.05, True, device="cpu", cell=c)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) <= {m["name"] for m in c.per_layer}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    assert list(result)[-1] == "compared"


def test_the_same_seed_mines_the_same_chain(tiny):
    c = tiny("t-miner")
    runs = []
    for _ in range(2):
        driver = harness.make_driver(harness.Ctx(c, 31, 0.0, False, "cpu"))
        driver.mine(3)
        runs.append(driver.chain())
    assert runs[0] == runs[1]


def _run(argv, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark", *argv],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_result_without_enough_cuda_devices():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without a card")
    p = _run(["--workload", "fused-d24", "--seed", "1", "--seconds", "1",
              "--trace", "0"], spec.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_no_result_for_an_unknown_workload():
    p = _run(["--workload", "nope", "--seed", "1", "--seconds", "1",
              "--trace", "0"], spec.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_no_result_from_the_benchmark_s_files_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["--workload", "fused-d24", "--seed", "1", "--seconds", "1",
              "--trace", "0"], tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""


def test_a_forbidden_module_is_found_by_its_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mpi_blockchain_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mpi_blockchain_tpu.cli", sys)
    assert harness.forbidden_modules() == ["mpi_blockchain_tpu"]
