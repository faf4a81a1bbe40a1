"""The adversarial simulation on the card: config 5 (``sim --preset
adversarial``) on the cuda backend, where every group's bounded search is
one launch of the sweep kernel, equals the same run on the C++ sweep and
the reference's pin (tips, steps, stats, causal dump bytes); and the
kernel at the budgets a group's search takes equals its plain version and
the C++ ``cpu_search``.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax); run it from
the repository's root (it imports ``chip_smoke``'s helpers):

    python -m pytest --noconftest -q -m cuda tests/test_torch_sim_cuda.py
"""
import contextlib
import dataclasses
import hashlib
import io
import json

import numpy as np
import pytest
import torch

from chip_smoke import (SIM_PRESET_PIN, bounded_search_cases,
                        bounded_vs_plain)
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import PRESETS
from mpi_blockchain_tpu_torch.ops import sha256_cuda
from mpi_blockchain_tpu_torch.simulation import run_adversarial


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sim(argv, dump) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["sim", *argv, "--events-dump", str(dump)])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["dump_sha256"] = hashlib.sha256(dump.read_bytes()).hexdigest()
    return out


@pytest.mark.cuda
def test_config5_on_the_card_equals_the_cpp_sweep_and_the_pin(tmp_path):
    _card()
    sha256_cuda.launches = 0
    card = _sim(["--preset", "adversarial"], tmp_path / "card.json")
    launches = sha256_cuda.launches
    cpp = _sim(["--difficulty", "16", "--blocks", "20", "--backend", "cpu"],
               tmp_path / "cpp.json")
    assert card == cpp
    assert {k: card[k] for k in SIM_PRESET_PIN} == SIM_PRESET_PIN
    assert launches == 2 * card["steps"]


@pytest.mark.cuda
def test_every_group_searches_on_the_kernel_rung():
    _card()
    cfg = dataclasses.replace(PRESETS["adversarial"], n_blocks=3)
    net = run_adversarial(config=cfg, partition_steps=6, target_height=3)
    assert net.converged()
    for n in net.nodes:
        assert n.backend.rung == "cuda:cuda" and not n.backend.degraded
        assert n.backend.active_backend.effective_kernel == "cuda"


@pytest.mark.cuda
def test_bounded_searches_equal_the_plain_version_and_cpu_search():
    device = _card()
    cases = bounded_search_cases(np.random.default_rng(7))
    compared, mismatches, winners = bounded_vs_plain(cases, device)
    assert mismatches == 0
    assert compared == 2 * len(cases) and winners > 0
