"""The port's dispatchwatch CLI (``python -m
mpi_blockchain_tpu_torch.dispatchwatch``) on the CPU.

Both smoke legs (sequential, pipelined) on the C++ sweep mine the chain
the reference's legs mine, fire no ``recompile_storm`` and count no
recompile; ``census --probe`` reports ``{"error": ...}`` where the
disassembler cannot run; the exactly-once contract of a leg
(``_census_clean``) on synthetic censuses; and ``smoke`` with no card
exits 2 without mining.
"""
import json
import logging

import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu_torch import chainwatch, dispatchwatch, telemetry
from mpi_blockchain_tpu_torch.dispatchwatch import __main__ as cli
from mpi_blockchain_tpu_torch.ops import sha256_cuda
from mpi_blockchain_tpu_torch.utils.logging import get_logger

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    level = get_logger().level
    yield
    get_logger().setLevel(level)
    chainwatch.uninstall()
    dispatchwatch.clear_compiles()
    for pkg in (telemetry, ref_telemetry):
        pkg.reset()
        pkg.clear_events()


def test_both_legs_mine_the_references_chain_with_no_storm():
    payload = cli.measure_compile_census(device="cpu")
    ref = RefMiner(RefConfig(difficulty_bits=cli.SMOKE_DIFFICULTY,
                             n_blocks=cli.SMOKE_BLOCKS, backend="cpu",
                             data_prefix=cli.SMOKE_PREFIX),
                   log_fn=lambda rec: None)
    ref.mine_chain()
    assert payload["chain_identical"] is True
    assert payload["storm_incidents"] == 0
    assert payload["recompiles_after_warmup"] == \
        payload["recompiles_sequential"] == 0
    assert payload["rungs"] == ["cpu", "cpu"]
    assert payload["sites"] == payload["sites_sequential"] == {}
    assert set(payload["cost"]) == {"error"}
    leg = cli._mine_leg(True, "cpu")
    assert leg["chain"] == ref.chain_hashes()
    assert not chainwatch.installed()


def test_census_probe_reports_an_error_without_the_disassembler(capsys):
    assert cli.main(["census", "--probe"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["event"] == "dispatchwatch_census"
    assert out["compiles"] == {}
    assert set(out["cost"]) == {"error"} and out["cost"]["error"]
    assert cli.main(["census"]) == 0
    assert "cost" not in json.loads(capsys.readouterr().out)


SITE = sha256_cuda.COMPILE_SITE


def _site(**stages) -> dict:
    compiles = stages.get("nvcc", 0)
    return {SITE: {"compiles": compiles, "compile_ms": 0.0,
                   "cache_entries": 0, "stages": stages}}


@pytest.mark.parametrize("census, loaded, clean", [
    (_site(load=1), False, True),             # loaded in this leg
    (_site(nvcc=1, load=1), False, True),     # built, then loaded
    ({}, True, True),                         # loaded in an earlier leg
    ({}, False, False),                       # the seam never compiled
    (_site(nvcc=2, load=1), False, False),    # a second build
    (_site(load=2), False, False),            # a second load
    (_site(load=1), True, False),             # loaded again
    (_site(nvcc=1), True, False),             # rebuilt after the load
    ({**_site(load=1), "fused": {"compiles": 2, "compile_ms": 1.0,
                                 "cache_entries": 1,
                                 "stages": {"program": 2}}}, False, False),
    ({**_site(load=1), "fused": {"compiles": 2, "compile_ms": 1.0,
                                 "cache_entries": 2,
                                 "stages": {"program": 2}}}, False, True),
], ids=["load", "build_load", "loaded_before", "no_seam", "second_build",
        "second_load", "load_again", "rebuild", "fused_recompile",
        "fused_clean"])
def test_the_exactly_once_contract_of_a_leg(census, loaded, clean):
    assert cli._census_clean(census, loaded) is clean


def test_smoke_with_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mined = []
    monkeypatch.setattr(cli, "measure_compile_census",
                        lambda *a, **k: mined.append(1))
    assert cli.main(["smoke"]) == 2
    assert "no CUDA device" in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])["error"]
    assert mined == []
    assert get_logger().level != logging.WARNING   # refused before it
