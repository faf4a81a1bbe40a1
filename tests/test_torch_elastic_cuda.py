"""The elastic mesh on the card: the in-process flavor's shrink, the
process-per-rank world's seeded death, and the skew smoke, with every
search through the CUDA sweep.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_elastic_cuda.py
"""
import contextlib
import io
import json

import pytest
import torch

from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.meshwatch import __main__ as mesh_cli
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_cuda
from mpi_blockchain_tpu_torch.resilience import __main__ as res_cli
from mpi_blockchain_tpu_torch.resilience import injection
from mpi_blockchain_tpu_torch.resilience.elastic import ElasticMeshBackend
from mpi_blockchain_tpu_torch.resilience.faultplan import FaultPlan

PINNED_D20_N10 = \
    "000008584f3d49230531993ab565d6fd422b9199d8d3d0279a6b03e9c4b7f445"

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(fn, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _disarm():
    telemetry.reset()
    yield
    injection.disarm()


def test_mesh_backend_shrinks_on_the_card_at_the_d20_pin():
    """A collective fault mid-run shrinks 4 logical miners to 3 on the
    card; every search is a launch of the CUDA sweep, and the chain is the
    d20/n10 pin."""
    _card()
    cfg = MinerConfig(difficulty_bits=20, n_blocks=10, batch_pow2=20,
                      n_miners=4)
    injection.arm(FaultPlan.from_dict({"faults": [
        {"site": "parallel.collective", "kind": "raise", "call": 4,
         "times": 1}]}))
    sha256_cuda.launches = 0
    backend = ElasticMeshBackend(cfg)
    miner = Miner(cfg, backend=backend)
    miner.mine_chain()
    injection.disarm()
    assert backend.n_live == 3 and backend.summary()["shrunk"]
    assert telemetry.gauge("mesh_live_devices").value == 3
    assert sha256_cuda.launches >= 10
    assert miner.node.tip_hash.hex() == PINNED_D20_N10


def test_cli_elastic_miners_on_the_card():
    _card()
    rc, out = _run(main, ["mine", "--elastic", "--miners", "4",
                          "--difficulty", "20", "--blocks", "10"])
    assert rc == 0 and out["tip_hash"] == PINNED_D20_N10
    assert out["backend"] == "cuda"
    assert out["mesh"]["device_mesh"]["n_live"] == 4


def test_rank_death_world_on_the_card_equals_the_cpp_sweeps(tmp_path):
    _card()
    card = res_cli.elastic_rank_death_world(tmp_path, "card", "cuda")
    cpp = res_cli.elastic_rank_death_world(
        tmp_path, "cpp", "cpu", chain=res_cli.DEATH_CHAIN["cuda"])
    assert card["victim"] == cpp["victim"] != 0
    assert card["dumps"] == cpp["dumps"] and len(card["dumps"]) == 3


def test_skew_smoke_on_the_card():
    _card()
    rc, out = _run(mesh_cli.main, ["skew-smoke"])
    assert rc == 0 and out["ok"] and out["rounds"] >= 8
