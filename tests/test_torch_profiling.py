"""The port's profiler capture (``utils/profiling.py``, ``mine --profile``)
on the CPU: ``trace_mining`` writes one Chrome trace into a logdir it
creates, holding the host spans as the profiler's user annotations, and
``mine --profile DIR`` mines the chain it mines unprofiled, on the
per-block and the fused path. (On the card, ``chip_smoke.py`` phase 15 b
counts the kernels in the trace.)"""
import json

import pytest
import torch

from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.utils.profiling import trace_mining

torch.set_num_threads(1)


def _traces(logdir) -> list:
    return sorted(logdir.glob("*.pt.trace.json"))


def _annotations(path) -> dict[str, list[dict]]:
    """The trace's user annotations (the host spans), by name."""
    out: dict[str, list[dict]] = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("cat") == "user_annotation":
            out.setdefault(ev["name"], []).append(ev)
    return out


def test_trace_mining_writes_the_spans_into_a_new_logdir(tmp_path):
    logdir = tmp_path / "new" / "logdir"
    miner = Miner(MinerConfig(difficulty_bits=8, n_blocks=3, backend="cpu"))
    with trace_mining(str(logdir)):
        miner.mine_chain()
    traces = _traces(logdir)
    assert len(traces) == 1
    spans = _annotations(traces[0])
    assert len(spans["miner.block"]) == len(spans["miner.sweep"]) == 3
    # Each sweep span nests inside its block's span.
    for block, sweep in zip(sorted(spans["miner.block"],
                                   key=lambda e: e["ts"]),
                            sorted(spans["miner.sweep"],
                                   key=lambda e: e["ts"])):
        assert block["ts"] <= sweep["ts"]
        assert sweep["ts"] + sweep["dur"] <= block["ts"] + block["dur"]


def test_create_perfetto_link_prints_the_traces_path(tmp_path, capsys):
    with trace_mining(str(tmp_path), create_perfetto_link=True):
        Miner(MinerConfig(difficulty_bits=8, n_blocks=1,
                          backend="cpu")).mine_chain()
    (trace,) = _traces(tmp_path)
    assert f"trace_mining: {trace}" in capsys.readouterr().err


def test_no_span_is_annotated_outside_a_capture(tmp_path):
    with trace_mining(str(tmp_path / "a")):
        pass
    Miner(MinerConfig(difficulty_bits=8, n_blocks=1,
                      backend="cpu")).mine_chain()
    (trace,) = _traces(tmp_path / "a")
    assert _annotations(trace) == {}


@pytest.mark.parametrize("form", [[], ["--fused", "--blocks-per-call", "2"]],
                         ids=["per_block", "fused"])
def test_mine_profile_mines_the_unprofiled_chain(form, tmp_path, capsys):
    flags = ["mine", "--device", "cpu", "--difficulty", "8", "--blocks",
             "3", "--batch-pow2", "8", *form]
    plain, profiled = tmp_path / "plain.bin", tmp_path / "profiled.bin"
    assert main([*flags, "--out", str(plain)]) == 0
    logdir = tmp_path / "trace"
    assert main([*flags, "--out", str(profiled), "--profile",
                 str(logdir)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["height"] == 3
    assert profiled.read_bytes() == plain.read_bytes()
    (trace,) = _traces(logdir)
    spans = _annotations(trace)
    if form:
        assert len(spans["fused.dispatch"]) == 2
        assert len(spans["miner.append"]) == 3
    else:
        assert len(spans["miner.block"]) == 3
