"""The resilience layer on the card, at small sizes: a dead CUDA dispatch
steps down cuda:cuda -> cuda:torch -> cpu and still mines the C++ sweep's
chain; a corrupt winner is caught by re-validation and retried on
cuda:cuda; a missing ``nvcc`` fails ``mine`` with rc 2, no retry and no
step-down; ``search_async`` (sweeps launched at once, read back when asked
for) returns what ``search`` returns, in order.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax); run it from
the repository's root (it imports ``chip_smoke``'s helpers):

    python -m pytest --noconftest -q -m cuda tests/test_torch_resilience_cuda.py
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from chip_smoke import fault_plan, metric_total, without_nvcc
from mpi_blockchain_tpu_torch import core, telemetry
from mpi_blockchain_tpu_torch.backend import backend_from_config
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.resilience import injection
from mpi_blockchain_tpu_torch.resilience.__main__ import smoke_degradation

REPO = pathlib.Path(__file__).resolve().parent.parent


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh():
    injection.disarm()
    telemetry.reset()
    yield
    injection.disarm()


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.cuda
def test_dead_cuda_dispatch_steps_down_to_the_cpu_oracle(tmp_path):
    _card()
    got = smoke_degradation(tmp_path, device="cuda")
    assert got["degraded"]["rung"] == "cpu"
    assert telemetry.default_registry().total(
        "backend_degradations_total") == 2


@pytest.mark.cuda
def test_corrupt_winner_is_retried_on_the_kernel(tmp_path, capsys):
    _card()
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(fault_plan("backend.cuda.dispatch",
                                          "corrupt")))
    assert main(["mine", "--difficulty", "12", "--blocks", "3",
                 "--fault-plan", str(plan)]) == 0
    out = _last_json(capsys)
    assert out["rung"] == "cuda:cuda" and "degraded" not in out
    reg = telemetry.default_registry()
    assert reg.total("retries_total") == 1
    assert reg.total("corrupt_results_total") == 1
    assert main(["mine", "--difficulty", "12", "--blocks", "3",
                 "--backend", "cpu"]) == 0
    assert out["tip_hash"] == _last_json(capsys)["tip_hash"]


@pytest.mark.cuda
def test_missing_nvcc_fails_with_no_retry_or_step_down(tmp_path):
    _card()
    metrics = tmp_path / "m.prom"
    env = without_nvcc(dict(os.environ), str(tmp_path / "no_cuda_home"))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
         "--difficulty", "8", "--blocks", "1", "--metrics-dump",
         str(metrics)], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    err = json.loads(proc.stdout.strip().splitlines()[-1])
    assert err["kind"] == "kernel" and "nvcc" in err["error"]
    text = metrics.read_text()
    assert metric_total(text, "retries_total") == 0
    assert metric_total(text, "backend_degradations_total") == 0


@pytest.mark.cuda
def test_search_async_on_the_card_matches_search():
    _card()
    be = backend_from_config(MinerConfig(difficulty_bits=10, batch_pow2=16))
    assert be.rung == "cuda:cuda"
    assert be.active_backend.device.index is not None
    cand = core.Node(10, 0).make_candidate(b"x")
    futs = [be.search_async(cand, 10, start_nonce=i << 16,
                            max_count=1 << 16) for i in range(8)]
    got = [f.result(timeout=120) for f in futs]
    want = [be.search(cand, 10, start_nonce=i << 16, max_count=1 << 16)
            for i in range(8)]
    assert got == want
    oracle = [core.cpu_search(cand, i << 16, 1 << 16, 10)[0]
              for i in range(8)]
    assert [r.nonce for r in got] == oracle
