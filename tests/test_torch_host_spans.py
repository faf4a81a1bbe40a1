"""The port's own host spans, on the CPU: where each is filed, how often,
under which parent, that the kill switch files none of them, and that a
profiler capture holds each as an annotation.

The spans name the host work that would otherwise fall between spans while
the card waits: ``fused.inputs`` and ``fused.validate`` around a k-block
call's input build and its blocks' validation, ``miner.issue`` and
``miner.window`` around a pipelined sweep's issue and the record of its
device window, ``backend.cuda.midstate`` and ``backend.cuda.launch`` inside
``backend.cuda.dispatch``, and ``blocktrace.observe`` around each miner's
critical-path observation (a block's in ``Miner``, a call's in
``FusedMiner``).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.telemetry import registry

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST_SPANS = ("fused.inputs", "fused.validate", "miner.issue",
              "miner.window", "backend.cuda.midstate", "backend.cuda.launch",
              "blocktrace.observe")


def _cfg(n_blocks: int = 3) -> MinerConfig:
    return MinerConfig(difficulty_bits=8, n_blocks=n_blocks, device="cpu",
                       batch_pow2=10)


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    yield
    registry.set_telemetry_disabled(False)


def _spans(name: str) -> list:
    return telemetry.default_registry().spans(name)


def test_fused_miner_files_its_host_spans_per_call_and_per_span():
    miner = FusedMiner(_cfg(), blocks_per_call=2, log_fn=lambda d: None)
    miner.mine_chain()
    assert miner.node.height == 3
    inputs, calls = _spans("fused.inputs"), _spans("fused.dispatch")
    validates = _spans("fused.validate")
    # One of each a k-block call: (k, height) of calls of 2 and 1 blocks.
    for spans in (inputs, calls, validates):
        assert [(s.attrs["k"], s.attrs["height"]) for s in spans] == \
            [(2, 0), (1, 2)]
    # The input build is the dispatch's sibling, not its parent.
    assert all(s.parent is None and s.depth == 0 for s in inputs + calls)
    appends = _spans("miner.append")
    assert [s.attrs["height"] for s in appends] == [1, 2, 3]
    assert all(s.parent == "fused.validate" and s.depth == 1
               for s in appends)
    # One observation a call: the first while the second is queued, the
    # second, the span's last, after the span drained.
    observe = _spans("blocktrace.observe")
    assert len(observe) == 2
    assert all(s.parent is None and s.depth == 0 for s in observe)
    assert _spans("miner.issue") == _spans("miner.window") == []


def test_fused_miner_observes_once_per_span_of_calls():
    # The name predates the per-call rule: each call of each span is
    # observed once, mine_chain(2)'s one call and mine_chain(3)'s two.
    miner = FusedMiner(_cfg(), blocks_per_call=2, log_fn=lambda d: None)
    miner.mine_chain(2)
    miner.mine_chain(3)
    assert miner.node.height == 5
    assert len(_spans("blocktrace.observe")) == 3
    assert len(_spans("fused.validate")) == len(_spans("fused.inputs")) == 3


@pytest.mark.parametrize("pipeline", [True, False])
def test_miner_files_its_host_spans_per_sweep_and_per_block(pipeline):
    miner = Miner(_cfg(), pipeline=pipeline, log_fn=lambda d: None)
    miner.mine_chain()
    assert miner.node.height == 3
    dispatch = _spans("backend.cuda.dispatch")
    sweeps = _spans("miner.sweep")
    assert len(dispatch) == len(sweeps) == 3
    for name in ("backend.cuda.midstate", "backend.cuda.launch"):
        halves = _spans(name)
        assert len(halves) == len(dispatch)
        assert all(s.parent == "backend.cuda.dispatch" for s in halves)
        assert {s.depth for s in halves} == {dispatch[0].depth + 1}
    issues, windows = _spans("miner.issue"), _spans("miner.window")
    if pipeline:
        # One issue a sweep put on the backend's search_async seam (the
        # next block's first sweep is issued inside the block before), one
        # window record a consumed sweep, beside the consume's span.
        assert len(issues) == len(windows) == len(sweeps)
        assert all(s.parent == "miner.issue" for s in dispatch)
        assert all(s.parent == "miner.block" for s in issues + windows)
        assert [s.attrs["height"] for s in windows] == [1, 2, 3]
    else:
        # The sequential oracle searches inside its sweep span and issues
        # nothing through the seam.
        assert issues == windows == []
        assert all(s.parent == "miner.sweep" for s in dispatch)
    observe = _spans("blocktrace.observe")
    assert len(observe) == 3
    assert all(s.parent is None for s in observe)


def test_the_kill_switch_files_none_of_the_host_spans():
    registry.set_telemetry_disabled(True)
    Miner(_cfg(2), log_fn=lambda d: None).mine_chain()
    Miner(_cfg(2), pipeline=False, log_fn=lambda d: None).mine_chain()
    FusedMiner(_cfg(2), blocks_per_call=2, log_fn=lambda d: None
               ).mine_chain()
    assert telemetry.default_registry().spans() == []


def test_telemetry_off_in_the_environment_files_none_of_the_host_spans():
    code = (
        "import json, torch\n"
        "torch.set_num_threads(1)\n"
        "from mpi_blockchain_tpu_torch import telemetry\n"
        "from mpi_blockchain_tpu_torch.config import MinerConfig\n"
        "from mpi_blockchain_tpu_torch.models.fused import FusedMiner\n"
        "from mpi_blockchain_tpu_torch.models.miner import Miner\n"
        "cfg = MinerConfig(difficulty_bits=8, n_blocks=2, device='cpu',\n"
        "                  batch_pow2=10)\n"
        "for pipeline in (True, False):\n"
        "    Miner(cfg, pipeline=pipeline, log_fn=lambda d: None"
        ").mine_chain()\n"
        "FusedMiner(cfg, blocks_per_call=2, log_fn=lambda d: None"
        ").mine_chain()\n"
        "print(json.dumps([telemetry.telemetry_disabled(),\n"
        "                  [s.name for s in "
        "telemetry.default_registry().spans()]]))\n")
    env = dict(os.environ, MPIBT_TELEMETRY_OFF="1", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    off, names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert off is True and names == []


def test_a_profiler_capture_holds_each_host_span_as_an_annotation():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        Miner(_cfg(1), log_fn=lambda d: None).mine_chain()
        FusedMiner(_cfg(1), log_fn=lambda d: None).mine_chain()
    keys = {e.key for e in prof.key_averages()}
    assert set(HOST_SPANS) <= keys, sorted(set(HOST_SPANS) - keys)
