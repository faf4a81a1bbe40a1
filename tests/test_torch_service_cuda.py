"""The front door on the card: a served d16 chain, pipelined through the
CUDA sweep while a seeded load streams over HTTP, equals the sequential
replay of the door's templates on the C++ sweep; the serve smoke passes on
the card.

Every test needs a CUDA device (``cuda`` marker) and skips without one.
This file imports no jax, so it also runs on a machine with the card and
without jax, skipping the root conftest (which imports jax); run it from
the repository's root (it imports ``chip_smoke``'s helpers):

    python -m pytest --noconftest -q -m cuda tests/test_torch_service_cuda.py
"""
import threading
import time

import pytest
import torch

import chip_smoke
from mpi_blockchain_tpu_torch import service, telemetry
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_cuda
from mpi_blockchain_tpu_torch.resilience import injection
from mpi_blockchain_tpu_torch.service import __main__ as serve_smoke
from mpi_blockchain_tpu_torch.service import loadgen


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(autouse=True)
def _fresh():
    injection.disarm()
    telemetry.reset()
    yield
    injection.disarm()


@pytest.mark.cuda
def test_served_d16_chain_equals_the_cpp_replay(monkeypatch):
    """The chain and the load overlap by construction: the door closes
    with the chain, and a d16 chain of 30 blocks ended in 0.1 to 0.5 s on
    an NVIDIA H100 80GB HBM3 at 700 W, before (or before any of) its 200
    requests did. So, in the
    ``_block_mined`` seam, block 1 waits until the pool holds a
    transaction and the last block until the load has ended."""
    _card()
    blocks = 30
    load_done = threading.Event()
    run_load = loadgen.run_load

    def run_load_then_release(*args, **kwargs):
        try:
            return run_load(*args, **kwargs)
        finally:
            load_done.set()

    def held(self, rec):
        state = service.active_service()
        if state is None:           # the replay's miner, after the door
            return
        if rec.height == 1:
            pool = state.mempool
            deadline = time.monotonic() + 60
            while not pool.depth() and not load_done.is_set() \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
        if rec.height == blocks:
            load_done.wait(timeout=120)

    monkeypatch.setattr(loadgen, "run_load", run_load_then_release)
    monkeypatch.setattr(Miner, "_block_mined", held)
    run = chip_smoke.serve_run(["--difficulty", "16", "--blocks",
                                str(blocks), "--batch-pow2", "20"],
                               {"seed": 1337, "n": 200, "workers": 4})
    summary = run["summary"]
    assert summary["height"] == blocks and summary["rung"] == "cuda:cuda"
    assert run["launches"] > 0
    assert run["report"]["ended_before_chain"], run["report"]
    chip_smoke.check_load(run["report"], run["state"], 200, "d16")
    oracle = serve_smoke.replay_oracle(run["payloads"], blocks, 16)
    assert oracle.node.tip_hash.hex() == summary["tip_hash"]
    assert summary["service"]["mempool"]["included_total"] > 0


@pytest.mark.cuda
def test_serve_smoke_passes_on_the_card():
    _card()
    sha256_cuda.launches = 0
    got = serve_smoke.smoke(device="cuda")
    assert got["ok"] and got["chain_identical"]
    assert got["step_downs"] == ["cuda:torch"] and got["faults_fired"] == 3
    assert sha256_cuda.launches > 0
