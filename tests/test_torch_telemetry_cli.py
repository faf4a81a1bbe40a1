"""The port's telemetry CLI (``python -m mpi_blockchain_tpu_torch.telemetry``)
against the reference's, on the CPU.

With ``--device cpu`` (the C++ sweep, the reference's run) it prints the
reference's metric names, exits as the reference does and writes the same
``--metrics-dump``, on the reference's cases (``tests/test_telemetry.py``):
in-process with a dump, and as a subprocess with the ``metrics-smoke``
needles. With no card and no ``--device cpu`` it exits 2. Exact.
"""
import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.telemetry.__main__ import main as ref_main
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.telemetry.__main__ import main, \
    run_instrumented

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: What ``make metrics-smoke`` greps the snapshot for.
NEEDLES = (r"^mining_rounds_total", r"^hashes_tried_total", r"_count")


@pytest.fixture(autouse=True)
def _fresh():
    yield
    for pkg in (telemetry, ref_telemetry):
        pkg.reset()
        pkg.clear_events()


def _run(fn, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


#: Fields of a record that the run's own clock writes.
CLOCK_FIELDS = ("wall_ms",)


def _ring_lines(text: str) -> list[dict]:
    """The JSON records a run printed, without their clock fields."""
    return [{k: v for k, v in json.loads(line).items()
             if k not in CLOCK_FIELDS}
            for line in text.splitlines() if line.startswith("{")]


def _types(text: str) -> set[tuple[str, str]]:
    return set(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


@pytest.mark.parametrize("argv", [["--steps", "2"],
                                  ["--steps", "2", "--no-sim"],
                                  ["--steps", "3", "--events"]],
                         ids=["mine_and_sim", "no_sim", "events"])
def test_the_snapshot_has_the_references_metric_names(argv, tmp_path):
    rc, out = _run(main, [*argv, "--device", "cpu", "--metrics-dump",
                          str(tmp_path / "p.prom")])
    ref_rc, ref_out = _run(ref_main, [*argv, "--metrics-dump",
                                      str(tmp_path / "r.prom")])
    assert rc == ref_rc == 0
    assert _types(out) == _types(ref_out) and _types(out)
    for needle in ("mining_rounds_total", "hashes_tried_total",
                   "block_latency_ms_count"):
        assert needle in out
    if "--no-sim" not in argv:
        assert "sim_reorg_depth_count" in out
        # Faults were injected: the drop and reorg metrics moved.
        assert telemetry.counter("sim_messages_dropped_total").value > 0
        assert telemetry.counter("sim_reorgs_total").value > 0
    dump, ref_dump = (tmp_path / "p.prom").read_text(), \
        (tmp_path / "r.prom").read_text()
    assert _types(dump) == _types(ref_dump)
    if "--events" in argv:
        # The ring, after the snapshot: the reference's records, a
        # block_mined for every block, but for the fields the reference's
        # own clock writes.
        ring = _ring_lines(out)
        assert ring == _ring_lines(ref_out)
        assert [r["event"] for r in ring] == ["block_mined"] * 3
        assert [line for line in out.splitlines() if line.startswith("{")] \
            == [json.dumps(rec, sort_keys=True, default=str)
                for rec in telemetry.recent_events()]


def test_the_cpu_run_mines_the_references_chains():
    from mpi_blockchain_tpu.config import MinerConfig as RefConfig
    from mpi_blockchain_tpu.models.miner import Miner as RefMiner
    from mpi_blockchain_tpu.simulation import run_adversarial

    out = run_instrumented(steps=2, device="cpu")
    assert out["rung"] == "cpu" and out["sim_rungs"] == ["cpu", "cpu"]
    ref = RefMiner(RefConfig(difficulty_bits=8, n_blocks=2, backend="cpu"),
                   log_fn=lambda rec: None)
    ref.mine_chain()
    net = run_adversarial(config=RefConfig(difficulty_bits=8, n_blocks=4,
                                           backend="cpu"),
                          partition_steps=12, target_height=4,
                          nonce_budget=1 << 8, drop_rate_pct=25, seed=0)
    assert out["tip_hash"] == ref.node.tip_hash.hex()
    assert out["sim_tips"] == [n.node.tip_hash.hex() for n in net.nodes]


def test_the_acceptance_command_with_device_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.telemetry",
         "--steps", "3", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for needle in NEEDLES:
        assert re.search(needle, proc.stdout, re.M), needle
    assert "# TYPE" in proc.stdout


def test_no_card_exits_2_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run(main, ["--steps", "1"])
    assert rc == 2
    assert "no CUDA device" in json.loads(out.strip().splitlines()[-1])[
        "error"]
    assert telemetry.counter("mining_rounds_total").value == 0


@pytest.mark.parametrize("form", ["sequential", "pipelined", "fused"])
def test_the_miners_hand_the_references_records_to_log_fn(form):
    """``Miner(log_fn=)`` and ``FusedMiner(log_fn=)`` receive every
    record; by default the records go to the event ring, where they carry
    the reference's keys and values (but the clock's and the fused
    backend's name) and the ``trace`` stamp the reference's carry."""
    from mpi_blockchain_tpu.config import MinerConfig as RefConfig
    from mpi_blockchain_tpu.models.fused import FusedMiner as RefFusedMiner
    from mpi_blockchain_tpu.models.miner import Miner as RefMiner
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.fused import FusedMiner
    from mpi_blockchain_tpu_torch.models.miner import Miner

    if form == "fused":
        cfg = dict(difficulty_bits=8, n_blocks=3, batch_pow2=10)

        def ours(**kw):
            return FusedMiner(MinerConfig(**cfg, device="cpu"),
                              blocks_per_call=2, **kw)

        def ref():
            return RefFusedMiner(RefConfig(**cfg, backend="tpu",
                                           kernel="jnp"), blocks_per_call=2)
    else:
        cfg = dict(difficulty_bits=8, n_blocks=3, backend="cpu")
        pipeline = form == "pipelined"

        def ours(**kw):
            return Miner(MinerConfig(**cfg), pipeline=pipeline, **kw)

        def ref():
            return RefMiner(RefConfig(**cfg), pipeline=pipeline)
    got = []
    ours(log_fn=got.append).mine_chain()
    assert telemetry.recent_events() == []
    ours().mine_chain()
    ref().mine_chain()
    ringed = [{k: v for k, v in r.items() if k not in CLOCK_FIELDS}
              for r in telemetry.recent_events()]
    ref_ringed = [{k: v for k, v in r.items() if k not in CLOCK_FIELDS}
                  for r in ref_telemetry.recent_events()]
    if form == "fused":
        assert {r.pop("backend") for r in ringed} == {"cuda-fused"}
        assert {r.pop("backend") for r in ref_ringed} == {"tpu-fused"}
        for r in got:
            r.pop("backend")
    assert ringed == ref_ringed
    assert [r["event"] for r in ringed] == ["block_mined"] * 3
    # The fused miners log inside each block's trace frame, the Miners
    # after it.
    assert all(("trace" in r) == (form == "fused") for r in ringed)
    assert [{k: v for k, v in r.items() if k not in CLOCK_FIELDS}
            for r in got] == [{k: v for k, v in r.items() if k != "trace"}
                              for r in ringed]
