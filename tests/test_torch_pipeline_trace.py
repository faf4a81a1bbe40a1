"""The port's dispatch pipeline profiler and per-block tracing against the
reference's, on the CPU.

Pure functions: ``pipeline_report``, ``to_chrome_trace`` and
``strip_block_identity`` of both packages give equal results on the same
record sets (numpy-seeded, and the reference's hand cases), exactly; the
trace differs only in the producer it names. The same d12/n6 chain on the
C++ sweep, through both packages' ``Miner``, sequential and pipelined,
with and without stale speculative templates, leaves the same pipeline
records once times are stripped (kinds, meta, stage sequence, heights,
templates, stripped identities), the same discards and the same
critical-path heights; ``mine``'s summary has the reference's keys,
``pipeline`` included, and its checkpoint segments join the same blocks.
``FusedMiner`` on the plain step against the reference's at k 2 and 3.
The card's device window (``Miner._card_window``) is held on fake launches
with known times: windows never overlap, each opens at the later of its
launch and the previous window's end, and the bubble is the idle time put
in.
"""
import collections
import concurrent.futures
import contextlib
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.backend.cpu import CpuBackend as RefCpuBackend
from mpi_blockchain_tpu.blocktrace import critical_path as ref_cp
from mpi_blockchain_tpu.cli import main as ref_main
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.meshwatch import pipeline as ref_pipeline
from mpi_blockchain_tpu.models.fused import FusedMiner as RefFusedMiner
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.backend import SearchResult
from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
from mpi_blockchain_tpu_torch.blocktrace import critical_path
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import KernelError, MinerConfig
from mpi_blockchain_tpu_torch.meshwatch import pipeline
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.ops import sha256_cuda

torch.set_num_threads(1)

DIFFICULTY, BLOCKS = 12, 6
STAGES = ("enqueue", "device", "collective", "validate", "append",
          "checkpoint", "mystery")


def _reset():
    for tel, pipe in ((telemetry, pipeline), (ref_telemetry, ref_pipeline)):
        tel.reset()
        tel.clear_events()
        tel.set_mesh_rank(0)
        tel.set_telemetry_disabled(False)
        pipe.reset_profiler()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _quiet(_event):
    return None


def stripped(records: list[dict]) -> list[dict]:
    """Records with every time taken out."""
    return [{"dispatch": r["dispatch"], "rank": r["rank"],
             "meta": r["meta"],
             "segments": [{k: v for k, v in s.items()
                           if k not in ("t0", "t1")}
                          for s in r["segments"]]} for r in records]


# ---- pure functions ---------------------------------------------------------


def seeded_records(seed: int) -> list[dict]:
    """Records of several ranks with device windows that overlap, host
    segments, heights, fused batches and segment stamps."""
    rng = np.random.default_rng(seed)
    records = []
    next_id = collections.Counter()
    for _ in range(int(rng.integers(1, 10))):
        rank = int(rng.integers(0, 3))
        meta = {"kind": "sweep"}
        if rng.uniform() < 0.7:
            meta["height"] = int(rng.integers(1, 6))
            if rng.uniform() < 0.3:
                meta["k"] = int(rng.integers(1, 4))
        t = float(rng.uniform(0, 10))
        segments = []
        for _ in range(int(rng.integers(0, 6))):
            t0 = t + float(rng.uniform(-0.5, 0.5))
            s = {"stage": STAGES[int(rng.integers(0, len(STAGES)))],
                 "t0": t0, "t1": t0 + float(rng.uniform(0.0, 1.0))}
            if rng.uniform() < 0.3:
                s["height"] = int(rng.integers(1, 6))
            if rng.uniform() < 0.2:
                s["template"] = int(rng.integers(1, 3))
            segments.append(s)
            t = t0 + float(rng.uniform(0.0, 1.0))
        records.append({"dispatch": next_id[rank], "rank": rank,
                        "meta": meta, "segments": segments})
        next_id[rank] += 1
    return records


def _dev(t0, t1, **kw):
    return {"stage": "device", "t0": t0, "t1": t1, **kw}


REF_CASES = {
    # Two dispatches, device windows [0,4] and [6,8]; host [3,5] and [5,6].
    "interval_math": [
        {"dispatch": 0, "rank": 0, "meta": {}, "segments": [
            _dev(0.0, 4.0), {"stage": "append", "t0": 3.0, "t1": 5.0}]},
        {"dispatch": 1, "rank": 0, "meta": {}, "segments": [
            {"stage": "validate", "t0": 5.0, "t1": 6.0}, _dev(6.0, 8.0)]}],
    "overlapping_windows": [
        {"dispatch": 0, "rank": 0, "meta": {}, "segments": [_dev(0, 3.0)]},
        {"dispatch": 1, "rank": 0, "meta": {}, "segments": [_dev(2.0, 5.0)]}],
    "multi_rank": [
        {"dispatch": 0, "rank": 0, "meta": {}, "segments": [_dev(0, 2.0)]},
        {"dispatch": 0, "rank": 1, "meta": {}, "segments": [
            _dev(0.0, 1.0), {"stage": "append", "t0": 1.0, "t1": 2.0}]}],
    "async_slices": [
        {"dispatch": 0, "rank": 0, "meta": {}, "segments": [_dev(0, 3.0)]},
        {"dispatch": 1, "rank": 0, "meta": {}, "segments": [
            _dev(2.0, 5.0), {"stage": "append", "t0": 2.5, "t1": 2.8}]}],
    "empty": [],
    "no_segments": [{"dispatch": 0, "rank": 0, "meta": {},
                     "segments": []}],
}
SETS = {**REF_CASES, **{f"seed_{s}": seeded_records(s) for s in range(12)}}


@pytest.mark.parametrize("name", sorted(SETS))
def test_pipeline_report_and_trace_equal_the_references(name):
    records = SETS[name]
    assert pipeline.pipeline_report(records) == \
        ref_pipeline.pipeline_report(records)
    assert pipeline.pipeline_report(records, max_dispatches=2) == \
        ref_pipeline.pipeline_report(records, max_dispatches=2)
    got = pipeline.to_chrome_trace(records)
    want = ref_pipeline.to_chrome_trace(records)
    # The producer is the one difference.
    assert got["metadata"].pop("source") == pipeline.SOURCE
    want["metadata"].pop("source")
    assert got == want


def test_hand_computed_interval_math():
    r = pipeline.pipeline_report(REF_CASES["interval_math"])["ranks"]["0"]
    assert (r["wall_s"], r["device_busy_s"], r["bubble_fraction"]) == \
        (8.0, 6.0, 0.25)
    assert (r["host_busy_s"], r["overlap_s"]) == (3.0, 1.0)
    assert r["host_overlapped_fraction"] == round(1 / 3, 4)
    union = pipeline.pipeline_report(REF_CASES["overlapping_windows"])
    assert union["ranks"]["0"]["device_busy_s"] == 5.0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("keep_k, segments", [(None, False), (None, True),
                                              (2, False), (0, True)])
def test_strip_block_identity_equals_the_references(seed, keep_k, segments):
    for got, want in zip(seeded_records(seed), seeded_records(seed)):
        old_meta, old_segments = got["meta"], got["segments"]
        pipeline.strip_block_identity(got, keep_k=keep_k, segments=segments)
        ref_pipeline.strip_block_identity(want, keep_k=keep_k,
                                          segments=segments)
        assert got == want
        # Rebound, never mutated in place.
        if got["meta"] is not old_meta:
            assert "height" in old_meta
        if got["segments"] is not old_segments:
            assert any("height" in s or "template" in s
                       for s in old_segments)


def test_profiler_ring_segment_on_last_and_kill_switch():
    prof = pipeline.PipelineProfiler(capacity=4)
    for _ in range(9):
        with prof.dispatch().segment("append"):
            pass
    assert len(prof.records()) == 4 and prof.records()[-1]["dispatch"] == 8
    assert len(prof.records(tail=2)) == 2
    fresh = pipeline.PipelineProfiler()
    with fresh.segment_on_last("checkpoint"):
        pass
    (r,) = fresh.records()
    assert r["meta"] == {"kind": "checkpoint"}
    assert r["segments"][0]["stage"] == "checkpoint"
    telemetry.set_telemetry_disabled(True)
    null = fresh.dispatch(kind="x")
    with null.segment("device"):
        pass
    assert len(fresh.records()) == 1 and null.now() > 0


@pytest.mark.parametrize("mod", [pipeline, ref_pipeline],
                         ids=["port", "reference"])
def test_a_chained_segment_opens_at_the_latest_end_so_far(mod):
    """A chained segment opens at the record's latest segment end while
    that end is past, whatever order the segments came in (the port keeps
    the latest end as segments arrive; the reference scans them), also
    once discarded speculation's identity is stripped; otherwise at
    entry, as an unchained segment does."""
    rec = mod.PipelineProfiler().dispatch(kind="sweep")
    now = rec.now()
    rec.add_segment("device", now - 0.5, now - 0.1)
    rec.add_segment("enqueue", now - 0.9, now - 0.6)
    with rec.segment("validate"):
        pass
    assert rec.record["segments"][-1]["t0"] == now - 0.1
    mod.strip_block_identity(rec.record, segments=True)
    with rec.segment("append"):
        pass
    last = rec.record["segments"][-1]
    assert last["t0"] == rec.record["segments"][-2]["t1"]
    rec.add_segment("device", now, now + 100.0)
    entered = rec.now()
    with rec.segment("checkpoint"):
        pass
    assert entered <= rec.record["segments"][-1]["t0"] < now + 100.0
    before = rec.now()
    with rec.segment("collective", chained=False):
        pass
    assert rec.record["segments"][-1]["t0"] >= before


# ---- the same chain through both packages -----------------------------------


def _stale_first_read(miner_cls):
    """``miner_cls`` whose first read of each height's payload is stale,
    so the pipelined driver discards its speculation (``restripe``)."""

    class Stale(miner_cls):
        def payload_for(self, height):
            self.reads = getattr(self, "reads", collections.Counter())
            self.reads[height] += 1
            if self.reads[height] == 1:
                return b"stale:%d" % height
            return super().payload_for(height)
    return Stale


def _chain(mode: str):
    """The d12/n6 chain on the C++ sweep in both packages: (port records,
    reference records, port discards, reference discards)."""
    pipelined = mode != "sequential"
    ref_cls, port_cls = RefMiner, Miner
    if mode == "pipelined_restripe":
        ref_cls, port_cls = _stale_first_read(RefMiner), \
            _stale_first_read(Miner)
    ref = ref_cls(RefConfig(difficulty_bits=DIFFICULTY, n_blocks=BLOCKS,
                            backend="cpu"),
                  backend=RefCpuBackend(), log_fn=_quiet, pipeline=pipelined)
    ref.mine_chain()
    port = port_cls(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=BLOCKS,
                                backend="cpu"),
                    backend=CpuBackend(), pipeline=pipelined)
    port.mine_chain()
    assert port.chain_hashes() == ref.chain_hashes()
    return (pipeline.profiler().records(), ref_pipeline.profiler().records(),
            _discards(telemetry), _discards(ref_telemetry))


def _discards(tel) -> int:
    return sum(m.value for m in tel.default_registry().metrics()
               if m.name == "speculative_discards_total")


@pytest.mark.parametrize("mode", ["sequential", "pipelined",
                                  "pipelined_restripe"])
def test_chain_leaves_the_references_pipeline_records(mode):
    got, want, discards, ref_discards = _chain(mode)
    assert stripped(got) == stripped(want)
    assert discards == ref_discards == \
        (BLOCKS - 1 if mode == "pipelined_restripe" else 0)
    report = critical_path.critical_path_report(got)
    assert report == ref_cp.critical_path_report(got)
    assert report["heights"] == list(range(1, BLOCKS + 1))
    stages = {s["stage"] for r in got for s in r["segments"]}
    assert stages == {"enqueue", "device", "validate", "append"}
    if mode == "pipelined_restripe":
        # The discarded speculation kept its device window, with no
        # block identity (unattributed).
        assert report["unattributed_segments"] == \
            ref_cp.critical_path_report(want)["unattributed_segments"] > 0


def test_the_resilient_c_sweep_leaves_every_block_complete():
    """Behind ``ResilientBackend`` the C++ sweep runs on its backend's
    search thread from the issue, as the reference's runs on its dispatch
    worker, so no block of the d12/n6 chain has a gap of 5% or more, in
    either package."""
    for miner_cls, cfg_cls, cp, pipe in (
            (Miner, MinerConfig, critical_path, pipeline),
            (RefMiner, RefConfig, ref_cp, ref_pipeline)):
        pipe.reset_profiler()
        kwargs = {} if miner_cls is Miner else {"log_fn": _quiet}
        miner = miner_cls(cfg_cls(difficulty_bits=DIFFICULTY,
                                  n_blocks=BLOCKS, backend="cpu"),
                          pipeline=True, **kwargs)
        miner.mine_chain()
        report = cp.critical_path_report(pipe.profiler().records())
        assert report["heights"] == list(range(1, BLOCKS + 1))
        for h in report["heights"]:
            block = report["blocks"][str(h)]
            assert block["complete"], (miner_cls, h, block)
            assert block["gap_pct"] < cp.COMPLETE_GAP_PCT, (miner_cls, h)


#: Host work after each append, longer than any d12 search here.
HOST_WORK_S = 0.03
#: What a window may add to its C++ sweep: the span and the fault check
#: around it on the search thread.
WINDOW_SLACK_S = 0.005


def test_the_c_sweeps_device_window_is_its_search(monkeypatch):
    """The C++ sweep's device window counts the search and nothing the
    host does meanwhile: with 30 ms of host work after each append, each
    consumed dispatch's window lies between its issue and the end of its
    sweep on the search thread, and lasts that sweep's time (within the
    span and fault check around it)."""
    from mpi_blockchain_tpu_torch import core

    runs = []
    real = core.cpu_search

    def timed_search(*args):
        t0 = time.perf_counter()
        res = real(*args)
        runs.append((t0, time.perf_counter(),
                     threading.current_thread() is threading.main_thread()))
        return res
    monkeypatch.setattr(core, "cpu_search", timed_search)
    pipeline.reset_profiler()
    miner = Miner(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=BLOCKS,
                              backend="cpu"), pipeline=True)
    miner.mine_chain(on_block=lambda rec: time.sleep(HOST_WORK_S))
    records = pipeline.profiler().records()
    anchor = pipeline.profiler().at(0.0)
    assert len(runs) == len(records) == BLOCKS
    assert not any(on_main for _, _, on_main in runs)
    for rec, (s, e, _) in zip(records, runs):
        seg = {x["stage"]: x for x in rec["segments"]}
        t0, t1 = seg["device"]["t0"] - anchor, seg["device"]["t1"] - anchor
        assert seg["enqueue"]["t0"] - anchor <= t0 and t1 <= e, (rec, s, e)
        assert e - s <= t1 - t0 <= e - s + WINDOW_SLACK_S, (rec, s, e)


def _summary(fn, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("device", ["cpu_backend", "cuda_backend_on_cpu"])
def test_mine_summary_has_the_references_keys_and_pipeline(device):
    args = ["mine", "--difficulty", str(DIFFICULTY), "--blocks",
            str(BLOCKS)]
    want = _summary(ref_main, args + ["--backend", "cpu"])
    port_args = (["--backend", "cpu"] if device == "cpu_backend"
                 else ["--device", "cpu", "--batch-pow2", "12"])
    got = _summary(main, args + port_args)
    assert got["tip_hash"] == want["tip_hash"]
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"kernel", "rung"}
    assert set(got["pipeline"]) == set(want["pipeline"]) == {
        "host_overlapped_fraction", "bubble_fraction",
        "speculative_discards"}
    assert got["pipeline"]["speculative_discards"] == 0
    assert 0.0 <= got["pipeline"]["bubble_fraction"] <= 1.0


def test_checkpoint_segments_join_the_blocks_that_paid_them(tmp_path):
    args = ["mine", "--difficulty", str(DIFFICULTY), "--blocks",
            str(BLOCKS), "--backend", "cpu", "--checkpoint-every", "2"]
    _summary(ref_main, args + ["--checkpoint", str(tmp_path / "ref.bin")])
    _summary(main, args + ["--checkpoint", str(tmp_path / "port.bin")])
    got = stripped(pipeline.profiler().records())
    want = stripped(ref_pipeline.profiler().records())
    assert got == want
    heights = [s.get("height") for r in got for s in r["segments"]
               if s["stage"] == "checkpoint"]
    assert heights == [2, 4, 6]


@pytest.mark.parametrize("k", [2, 3])
def test_fused_miner_leaves_the_references_records(k):
    ref = RefFusedMiner(RefConfig(difficulty_bits=10, n_blocks=BLOCKS,
                                  batch_pow2=12, backend="tpu",
                                  kernel="jnp"),
                        blocks_per_call=k, log_fn=_quiet)
    ref.mine_chain()
    port = FusedMiner(MinerConfig(difficulty_bits=10, n_blocks=BLOCKS,
                                  batch_pow2=12, device="cpu"),
                      blocks_per_call=k)
    port.mine_chain()
    assert port.chain_hashes() == ref.chain_hashes()
    got = pipeline.profiler().records()
    want = ref_pipeline.profiler().records()
    assert stripped(got) == stripped(want)
    assert [r["meta"] for r in got] == [
        {"kind": "fused", "height": h, "k": min(k, BLOCKS - h)}
        for h in range(0, BLOCKS, k)]
    # The device window opens when the call returns and closes when its
    # nonces are back: after the call's enqueue segment.
    for r in got:
        enqueue, device = r["segments"][:2]
        assert (enqueue["stage"], device["stage"]) == ("enqueue", "device")
        assert device["t0"] >= enqueue["t1"]
    report = critical_path.critical_path_report(got)
    assert report == ref_cp.critical_path_report(got)
    assert report["heights"] == list(range(1, BLOCKS + 1))


# ---- the device window on the card ----------------------------------------


def test_card_window_reconstruction_on_known_launches():
    """Sweeps on one stream run in order: a window opens at the later of
    its launch and the previous window's end; the idle time put in is
    the bubble."""
    miner = Miner(MinerConfig(difficulty_bits=8, n_blocks=1, backend="cpu"),
                  backend=CpuBackend())
    prof = pipeline.PipelineProfiler()
    base = time.perf_counter()
    launches = [(0.0, 1.0), (0.5, 1.0), (3.0, 1.0), (3.2, 0.5), (9.0, 0.0)]
    windows = []
    for launched, device_s in launches:
        prec = prof.dispatch(kind="sweep")
        t0, t1 = miner._card_window(prec, base + launched, device_s)
        prec.add_segment("device", t0, t1)
        windows.append((t0 - prof._anchor - base, t1 - prof._anchor - base))
    want = [(0.0, 1.0), (1.0, 2.0), (3.0, 4.0), (4.0, 4.5), (9.0, 9.0)]
    for (t0, t1), (w0, w1) in zip(windows, want):
        assert t0 == pytest.approx(w0, abs=1e-5)
        assert t1 == pytest.approx(w1, abs=1e-5)
    assert all(a[1] <= b[0] + 1e-9 for a, b in zip(windows, windows[1:]))
    rep = pipeline.pipeline_report(prof.records())["ranks"]["0"]
    assert rep["device_busy_s"] == pytest.approx(3.5, abs=1e-5)
    # The idle put in: [2, 3] and [4.5, 9] of a 9 s wall (the last window
    # is empty).
    assert rep["wall_s"] == pytest.approx(9.0, abs=1e-5)
    assert rep["bubble_fraction"] == pytest.approx(5.5 / 9.0, abs=1e-4)


class _FakeSweep:
    """A sweep on a fake card: launched now, ``device_s`` long, with timing
    events when its launch asked for them (``timed``, as
    ``sha256_cuda.sweep_launch`` does); ``done`` False keeps it on the
    card until its result is read, and ``fail`` is what asking about it
    raises."""

    def __init__(self, device_s: float, done: bool = True,
                 fail: Exception | None = None):
        self.launched = time.perf_counter()
        self.device_s = device_s
        self.timed = sha256_cuda.timing_requested()
        self.done, self.fail = done, fail
        self.reads = 0

    def ready(self) -> bool:
        if self.fail is not None:
            raise self.fail
        return self.done

    def timing(self) -> tuple[float, float]:
        assert self.timed and self.done
        self.reads += 1
        return self.launched, self.device_s


class _FakeDispatch(concurrent.futures.Future):
    """The resilient backend's future in form: resolved when asked, with
    the sweep it put on the card."""

    def __init__(self, fn, sweep):
        super().__init__()
        self.fn, self.sweep, self.from_launch = fn, sweep, False

    def result(self, timeout=None):
        if not self.done():
            self.set_result(self.fn())
            self.sweep.done = self.from_launch = True
        return super().result(timeout)


class _FakeCard(CpuBackend):
    """The C++ sweep behind futures whose sweeps run ``device_s`` on a
    fake card."""

    def __init__(self, device_s: float, **sweep_kwargs):
        super().__init__()
        self.device_s = device_s
        self.sweep_kwargs = sweep_kwargs
        self.sweeps: list[_FakeSweep] = []

    def search_async(self, header80, difficulty_bits, start_nonce=0,
                     max_count=1 << 32):
        sweep = _FakeSweep(self.device_s, **self.sweep_kwargs)
        self.sweeps.append(sweep)
        return _FakeDispatch(
            lambda: self.search(header80, difficulty_bits,
                                start_nonce=start_nonce,
                                max_count=max_count), sweep)


@pytest.mark.parametrize("stale", [False, True], ids=["plain", "restripe"])
def test_pipelined_miner_takes_device_windows_from_the_card(stale):
    card = _FakeCard(device_s=0.004)
    cls = _stale_first_read(Miner) if stale else Miner
    miner = cls(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=BLOCKS,
                            backend="cpu"), backend=card, pipeline=True)
    miner.mine_chain()
    anchor = pipeline.profiler()._anchor
    records = pipeline.profiler().records()
    windows = sorted((s["t0"] - anchor, s["t1"] - anchor)
                     for r in records for s in r["segments"]
                     if s["stage"] == "device")
    # Every sweep that reached the card has its window, discarded ones
    # (as unattributed work) included.
    assert len(windows) == len(card.sweeps) == \
        BLOCKS + (BLOCKS - 1 if stale else 0)
    prev_end = 0.0
    for (t0, t1), sweep in zip(windows, card.sweeps):
        assert t0 == pytest.approx(max(sweep.launched, prev_end), abs=1e-5)
        assert t1 - t0 == pytest.approx(0.004, abs=1e-6)
        prev_end = t1
    rep = pipeline.pipeline_report(records)["ranks"]["0"]
    assert rep["device_busy_s"] == pytest.approx(0.004 * len(windows),
                                                 abs=1e-5)
    assert rep["bubble_fraction"] == pytest.approx(
        1 - rep["device_busy_s"] / rep["wall_s"], abs=1e-4)
    report = critical_path.critical_path_report(records)
    assert report["heights"] == list(range(1, BLOCKS + 1))
    assert report["unattributed_segments"] == (
        2 * (BLOCKS - 1) if stale else 0)


def test_telemetry_off_reads_no_card_timing():
    card = _FakeCard(device_s=0.004)
    telemetry.set_telemetry_disabled(True)
    miner = Miner(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=3,
                              backend="cpu"), backend=card, pipeline=True)
    miner.mine_chain()
    assert pipeline.profiler().records() == []
    # The off driver launches no timing events and reads none.
    assert card.sweeps and not any(s.timed for s in card.sweeps)
    assert sum(s.reads for s in card.sweeps) == 0


def test_only_the_traced_issue_asks_for_timing_events():
    card = _FakeCard(device_s=0.004)
    miner = Miner(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=3,
                              backend="cpu"), backend=card, pipeline=True)
    miner.mine_chain()
    assert card.sweeps and all(s.timed and s.reads == 1
                               for s in card.sweeps)
    # Outside the issue nothing asks for them.
    assert not sha256_cuda.timing_requested()


def test_timed_launches_is_per_thread_and_restores():
    assert not sha256_cuda.timing_requested()
    seen = []
    with sha256_cuda.timed_launches():
        with sha256_cuda.timed_launches(False):
            seen.append(sha256_cuda.timing_requested())
        seen.append(sha256_cuda.timing_requested())
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            seen.append(pool.submit(sha256_cuda.timing_requested).result())
    seen.append(sha256_cuda.timing_requested())
    assert seen == [False, True, False, False]


def test_a_dropped_timed_sweep_gives_its_event_pair_back():
    """A timed sweep's pair returns to the pool only when nothing holds
    the sweep, and the next timed launch on that device takes it."""
    pool = sha256_cuda._TimingPairs()
    device = torch.device("cpu")
    start, end = object(), object()
    sweep = sha256_cuda.LaunchedSweep(torch.zeros(4, dtype=torch.int32),
                                      end, start, launched=1.0)
    assert sweep.timed and sweep.device == device
    sweep.__del__(_give=pool.give)
    assert pool.take(device) == (start, end)
    # The module's own pool never sees these stand-ins.
    sweep.start = None
    del sweep
    assert device not in sha256_cuda._timing_pairs.free
    plain = sha256_cuda.LaunchedSweep(torch.zeros(4, dtype=torch.int32),
                                      end)
    assert not plain.timed
    plain.__del__(_give=pool.give)
    assert pool.free == {device: []}


def test_the_pool_lends_each_pair_to_one_sweep_at_a_time():
    pool = sha256_cuda._TimingPairs()
    device = torch.device("cpu")
    pairs = [(object(), object()) for _ in range(3)]
    for pair in pairs:
        pool.give(device, pair)
    taken = [pool.take(device) for _ in range(3)]
    assert sorted(map(id, taken)) == sorted(map(id, pairs))
    assert pool.free[device] == []
    # Another device has its own pairs.
    pool.give(torch.device("cuda", 1), pairs[0])
    assert pool.free[device] == []


class _TwoWindows(Miner):
    """Two windows a template: the second window's sweep is a speculation
    that a winner in the first discards."""

    def search_windows(self):
        return ((0, 1 << 31), (1 << 31, 1 << 32))


def _winner_discards(card) -> tuple[Miner, list]:
    miner = _TwoWindows(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=3,
                                    backend="cpu"), backend=card,
                        pipeline=True)
    records = miner.mine_chain()
    assert len(records) == 3
    # Every winner lies in the first window here, so each block discarded
    # its second window's sweep.
    assert all(r.nonce < 1 << 31 for r in records)
    assert telemetry.default_registry().total(
        "speculative_discards_total") == 3
    return miner, card.sweeps[1::2]


def test_a_discarded_sweep_still_on_the_card_is_not_waited_for():
    """The chain ends without waiting for discarded sweeps still on the
    card: they stay unrecorded, and nothing reads their timing."""
    miner, discarded = _winner_discards(_FakeCard(device_s=0.004,
                                                  done=False))
    assert all(s.timed and s.reads == 0 for s in discarded)
    assert miner._draining == []
    devices = [s for r in pipeline.profiler().records()
               for s in r["segments"] if s["stage"] == "device"]
    # Only the consumed sweeps, done at their consume, have windows.
    assert len(devices) == 3


def test_done_discarded_sweeps_are_drained_as_unattributed_work():
    _winner_discards(_FakeCard(device_s=0.004))
    report = critical_path.critical_path_report(
        pipeline.profiler().records())
    assert report["heights"] == [1, 2, 3]
    assert report["unattributed_segments"] == 3 * 2


def test_a_failing_discarded_sweep_is_an_event_not_a_failure():
    fault = KernelError("sha256d_sweep completion query: an illegal "
                        "memory access was encountered")
    miner, discarded = _winner_discards(_FakeCard(device_s=0.004,
                                                  fail=fault))
    failed = telemetry.recent_events(event="speculative_dispatch_failed")
    assert len(failed) == 3
    assert "illegal memory access" in failed[0]["error"]
    assert miner._draining == []


def test_a_retried_search_falls_back_to_the_consume_window():
    """A result that is not the launched sweep's (a retry) is not timed
    by that sweep."""
    card = _FakeCard(device_s=10.0)
    real = card.search_async

    def first_not_from_launch(*args, **kwargs):
        fut = real(*args, **kwargs)
        fut.result()
        fut.from_launch = False
        return _Pending(fut)

    class _Pending(concurrent.futures.Future):
        def __init__(self, inner):
            super().__init__()
            self.inner, self.sweep, self.from_launch = inner, inner.sweep, \
                False

        def result(self, timeout=None):
            if not self.done():
                self.set_result(self.inner.result())
            return super().result(timeout)

    card.search_async = first_not_from_launch
    miner = Miner(MinerConfig(difficulty_bits=DIFFICULTY, n_blocks=2,
                              backend="cpu"), backend=card, pipeline=True)
    miner.mine_chain()
    devices = [s for r in pipeline.profiler().records()
               for s in r["segments"] if s["stage"] == "device"]
    assert len(devices) == 2
    assert all(s["t1"] - s["t0"] < 10.0 for s in devices)


def test_search_result_type_is_the_backends():
    """The fake card returns the C++ sweep's results unchanged."""
    card = _FakeCard(device_s=0.0)
    res = card.search_async(bytes(80), 1).result()
    assert isinstance(res, SearchResult)
