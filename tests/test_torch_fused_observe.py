"""The fused driver's critical-path observation, on the CPU.

``FusedMiner`` observes each k-block call's blocks from the call's own
record once they are appended, while later calls are queued, and the
span's last call (or the call a recovery cut short) after the
``on_progress`` seam, from the records opened since it. These tests hold
that to one pass of ``observe_batch_metrics`` over all of the span's
records (the same observations of ``block_critical_path_ms{stage}`` and
``block_trace_gap_pct``, in the same order), through spans whose last call
is partial, a checkpoint segment written through ``segment_on_last`` and
a recovery bail-out in the middle of a call; they bound what the
observation reads to the span's own records however full the profiler's
ring is, and count ``fused_observed_blocks_total{at}``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from mpi_blockchain_tpu_torch import core, telemetry
from mpi_blockchain_tpu_torch.backend import get_backend
from mpi_blockchain_tpu_torch.blocktrace import critical_path
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.meshwatch.pipeline import profiler, \
    reset_profiler
from mpi_blockchain_tpu_torch.models import fused
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.telemetry import registry
from test_exhaustion import ExhaustFirstSpace

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIFF = 8
HISTS = ("block_critical_path_ms", "block_trace_gap_pct")
COUNTER = "fused_observed_blocks_total"
#: The recovery case: the call at height 3 (blocks 4 to 6) brings the
#: sentinel for its second block, 5.
BAD_CALL, BAD_J = 3, 1


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    reset_profiler()
    yield
    registry.set_telemetry_disabled(False)


def _cfg() -> MinerConfig:
    return MinerConfig(difficulty_bits=DIFF, n_blocks=8, device="cpu",
                       batch_pow2=10, data_prefix="observe")


def _checkpoint(height: int) -> None:
    """The CLI's checkpoint seam: a segment on the newest record."""
    with profiler().segment_on_last("checkpoint"):
        core.sha256d(str(height).encode())


def _sentinel_in_one_call(monkeypatch) -> None:
    """The k-block programs as built, but the first call at ``BAD_CALL``
    brings 0xFFFFFFFF for its block ``BAD_J``, which fails validation."""
    real_make = fused.make_fused_miner
    hit = []

    def make(k, *args, **kwargs):
        fn = real_make(k, *args, **kwargs)

        def spy(prev, data, height):
            nonces, tip = fn(prev, data, height)
            if height == BAD_CALL and not hit:
                hit.append(height)
                values = nonces.tolist()
                values[BAD_J] = 0xFFFFFFFF
                nonces = torch.tensor(values, dtype=torch.uint32)
            return nonces, tip

        return spy

    monkeypatch.setattr(fused, "make_fused_miner", make)


def _mine(case: str, monkeypatch) -> tuple[FusedMiner, list[int]]:
    """Mines the case's 8 blocks; returns the miner and how many blocks
    each span left to its drain."""
    cfg = _cfg()
    drains = []
    if case == "spans":
        # Calls of 2, 2, 1, then of 2, 1: each span's last is partial.
        fm = FusedMiner(cfg, blocks_per_call=2, log_fn=lambda d: None)
        fm.mine_chain(5)
        fm.mine_chain(3)
        drains = [1, 1]
    elif case == "checkpoint":
        fm = FusedMiner(cfg, blocks_per_call=3, log_fn=lambda d: None)
        fm.mine_chain(4, on_progress=_checkpoint)
        fm.mine_chain(4, on_progress=_checkpoint)
        drains = [1, 1]
    else:
        _sentinel_in_one_call(monkeypatch)
        fm = FusedMiner(cfg, blocks_per_call=3, log_fn=lambda d: None,
                        recovery_backend=ExhaustFirstSpace(
                            get_backend("cpu"), cfg))
        fm.mine_chain(on_progress=_checkpoint)
        # Block 5 rolled over to a fresh space, so it is the recovery's.
        f = core.HeaderFields.unpack(fm.node.block_header(5))
        assert f.data_hash == core.sha256d(cfg.payload(5, extra_nonce=1))
        # The cut call keeps block 4 and the recovered 5; the next span's
        # one call of 3 drains.
        drains = [2, 3]
    assert fm.node.height == 8
    return fm, drains


def _observations(monkeypatch) -> list:
    """Every observation of the two histograms from here on, in order."""
    seen = []
    observe = registry.Histogram.observe

    def spy(self, value):
        if self.name in HISTS:
            seen.append((self.name, self.labels, value))
        observe(self, value)

    monkeypatch.setattr(registry.Histogram, "observe", spy)
    return seen


def _hist_snapshot() -> dict:
    snap = telemetry.default_registry().snapshot()
    return {name: snap.get(name) for name in HISTS}


@pytest.mark.parametrize("case", ["spans", "checkpoint", "recovery"])
def test_per_call_observation_is_one_pass_over_the_spans_records(
        case, monkeypatch):
    seen = _observations(monkeypatch)
    fm, _ = _mine(case, monkeypatch)
    got, got_snap = list(seen), _hist_snapshot()
    records = profiler().records()
    # The expectation, on a fresh registry: one pass over every record
    # the spans opened, for every height mined.
    telemetry.reset()
    seen.clear()
    want = critical_path.observe_batch_metrics(
        list(range(1, fm.node.height + 1)), records)
    assert sorted(want) == list(range(1, 9))
    assert got == seen
    assert got_snap == _hist_snapshot()
    if case != "spans":
        # Each span's checkpoint joined its newest block.
        checkpoints = [s for s in got if ("stage", "checkpoint") in s[1]]
        assert len(checkpoints) == 2


@pytest.mark.parametrize("case", ["spans", "recovery"])
def test_the_observation_reads_only_the_spans_records(case, monkeypatch):
    # A ring of unrelated fused records, as a long run leaves it.
    prof = profiler()
    for i in range(4000):
        rec = prof.dispatch(kind="fused", height=10 ** 6 + 100 * i, k=100)
        rec.add_segment("enqueue", 0.0, 1.0)
    first = prof.records(tail=1)[0]["dispatch"] + 1
    passed, tails = [], []
    observe = fused.observe_batch_metrics

    def spy_observe(heights, records, **labels):
        passed.append([r["dispatch"] for r in records])
        return observe(heights, records, **labels)

    read = prof.records

    def spy_records(tail=None):
        tails.append(tail)
        return read(tail)

    monkeypatch.setattr(fused, "observe_batch_metrics", spy_observe)
    monkeypatch.setattr(prof, "records", spy_records)
    fm, drains = _mine(case, monkeypatch)
    opened = read(tail=1)[0]["dispatch"] + 1 - first
    assert passed and all(i >= first for ids in passed for i in ids)
    assert all(t is not None and 1 <= t <= opened for t in tails)
    by_at = {m["labels"]["at"]: m["value"] for m in
             telemetry.default_registry().snapshot()[COUNTER]}
    assert by_at["in_flight"] + by_at["drain"] == fm.node.height
    assert by_at["drain"] == sum(drains)


def test_the_kill_switch_observes_and_counts_nothing(monkeypatch):
    registry.set_telemetry_disabled(True)
    calls = []
    monkeypatch.setattr(fused, "observe_batch_metrics",
                        lambda *a, **kw: calls.append(a))
    monkeypatch.setattr(profiler(), "records",
                        lambda tail=None: calls.append(tail))
    fm, _ = _mine("checkpoint", monkeypatch)
    assert calls == []
    assert COUNTER not in telemetry.default_registry().snapshot()


def test_telemetry_off_in_the_environment_files_no_observation():
    code = (
        "import json, torch\n"
        "torch.set_num_threads(1)\n"
        "from mpi_blockchain_tpu_torch import telemetry\n"
        "from mpi_blockchain_tpu_torch.config import MinerConfig\n"
        "from mpi_blockchain_tpu_torch.models.fused import FusedMiner\n"
        "cfg = MinerConfig(difficulty_bits=8, n_blocks=5, device='cpu',\n"
        "                  batch_pow2=10)\n"
        "FusedMiner(cfg, blocks_per_call=2, log_fn=lambda d: None"
        ").mine_chain()\n"
        "print(json.dumps(sorted(telemetry.default_registry()"
        ".snapshot())))\n")
    env = dict(os.environ, MPIBT_TELEMETRY_OFF="1", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not {COUNTER, *HISTS} & set(names)
