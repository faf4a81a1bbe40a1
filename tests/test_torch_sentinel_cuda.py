"""The perf sentinel's CLIs on the card: ``perfwatch smoke``,
``dispatchwatch smoke`` and the telemetry CLI, each mining through the
CUDA sweep kernel with no step-down.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_sentinel_cuda.py
"""
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _module(module: str, *args) -> tuple[int, str, str]:
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)
    return proc.returncode, proc.stdout, proc.stderr


def test_perfwatch_smoke_on_the_card():
    _card()
    rc, out, err = _module("mpi_blockchain_tpu_torch.perfwatch", "smoke")
    assert rc == 0, err[-2000:]
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["ok"] and doc["healthz"] == "ok"
    assert doc["sweep_launches"] > 0
    assert set(doc["rungs"]) == {"cuda:cuda"}


def test_dispatchwatch_smoke_on_the_card():
    _card()
    rc, out, err = _module("mpi_blockchain_tpu_torch.dispatchwatch", "smoke")
    assert rc == 0, err[-2000:]
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["ok"] and doc["recompiles_after_warmup"] == 0
    assert doc["loaded_before"] == [False, True]
    assert doc["cost"]["loop_instructions_per_nonce"] > 0


def test_the_telemetry_cli_on_the_card():
    _card()
    rc, out, err = _module("mpi_blockchain_tpu_torch.telemetry",
                           "--steps", "3")
    assert rc == 0, err[-2000:]
    for needle in (r"^mining_rounds_total", r"^hashes_tried_total",
                   r"_count"):
        assert re.search(needle, out, re.M), needle
    assert 'backend="cuda"' in out
