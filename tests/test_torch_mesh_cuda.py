"""Mesh observability on the card: ``mine --mesh-obs`` and the three
multi-rank smokes with every rank mining through the CUDA sweep.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_mesh_cuda.py
"""
import contextlib
import io
import json

import pytest
import torch

from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.blocktrace import __main__ as trace_cli
from mpi_blockchain_tpu_torch.chainwatch import __main__ as watch_cli
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.meshwatch import __main__ as mesh_cli
from mpi_blockchain_tpu_torch.meshwatch import shard
from mpi_blockchain_tpu_torch.meshwatch.aggregate import rank_status

PINNED_D20_N10 = \
    "000008584f3d49230531993ab565d6fd422b9199d8d3d0279a6b03e9c4b7f445"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(fn, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
def test_mine_mesh_obs_on_the_card(tmp_path):
    _card()
    # The shard carries the process's registry: counters of runs before
    # this one in the same process must not count toward its total.
    telemetry.reset()
    rc, summary = _run(main, ["mine", "--difficulty", "20", "--blocks",
                              "10", "--batch-pow2", "20", "--mesh-obs",
                              str(tmp_path)])
    assert rc == 0 and summary["tip_hash"] == PINNED_D20_N10
    final = json.loads(shard.shard_path(tmp_path, 0).read_text())
    assert final["final"] is True and final["exit_status"] == 0
    assert sum(s["value"] for s in final["registry"]["hashes_tried_total"]) \
        == summary["hashes_tried"]
    assert final["memory"]["cuda:0"]["bytes_in_use"] > 0
    assert rank_status([final])["ranks"]["0"]["status"] == "finished"


@pytest.mark.cuda
@pytest.mark.parametrize("cli", [mesh_cli, watch_cli, trace_cli],
                         ids=["meshwatch", "chainwatch", "blocktrace"])
def test_the_smokes_on_the_card(cli):
    _card()
    rc, out = _run(cli.main, ["smoke"])
    assert rc == 0 and out["ok"] is True
