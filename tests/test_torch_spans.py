"""The port's spans and histograms against the reference's, on the CPU.

``telemetry/spans.py`` and the registry's ``Histogram`` against the
reference's on the same inputs: span nesting, parents and depths,
``span_seconds``, the kill switch, and the seeded reservoir (the same
quantiles and the same Prometheus text after the reservoir is full). The
span sites of the port's drivers and backends against the reference's,
and the bridge into PyTorch's profiler.
"""
import threading

import pytest
import torch

from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu.telemetry import registry as ref_registry
from mpi_blockchain_tpu.telemetry import spans as ref_spans
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.telemetry import registry, spans

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

SITE_NAMES = ("miner.block", "miner.sweep", "miner.append",
              "backend.cpu.search")


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    ref_registry.reset()
    yield
    registry.set_telemetry_disabled(False)
    ref_registry.set_telemetry_disabled(False)


def _observations(n: int) -> list[float]:
    """A fixed, uneven sequence of values."""
    return [((i * 7919) % 1013) / 7.0 + (i % 3) * 0.5 for i in range(n)]


@pytest.mark.parametrize("n, cap", [(10, None), (5000, None), (300, 16)])
def test_histogram_reservoir_matches_the_reference(n, cap):
    ours = registry.Histogram("lat", labels=(("backend", "cpu"),),
                              reservoir_size=cap)
    ref = ref_registry.Histogram("lat", labels=(("backend", "cpu"),),
                                 reservoir_size=cap)
    for v in _observations(n):
        ours.observe(v)
        ref.observe(v)
    assert ours.snapshot() == ref.snapshot()
    assert ours.sample_lines() == ref.sample_lines()
    assert ours.to_dict() == ref.to_dict()
    for q in (0.0, 0.3, 0.5, 0.95, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    with pytest.raises(registry.MetricError):
        ours.quantile(1.5)


def test_empty_histogram_and_kind_conflicts_match_the_reference():
    ours, ref = registry.Registry(), ref_registry.Registry()
    assert ours.histogram("h").snapshot() == ref.histogram("h").snapshot()
    assert ours.render_prometheus() == ref.render_prometheus()
    ours.counter("x")
    ref.counter("x")
    with pytest.raises(registry.MetricError):
        ours.histogram("x")
    with pytest.raises(ref_registry.MetricError):
        ref.histogram("x")


def _nest(span_fn, active_fn, reg) -> list:
    """The same nested spans in one package; returns what each saw as the
    active span."""
    seen = []
    with span_fn("miner.block", registry=reg, height=1):
        seen.append(active_fn().name)
        with span_fn("miner.sweep", registry=reg, height=1, extra_nonce=0):
            seen.append(active_fn().name)
            with span_fn("backend.cpu.search", registry=reg, n_ranks=1):
                seen.append(active_fn().depth)
        with span_fn("miner.append", registry=reg, height=1):
            pass
    seen.append(active_fn())
    return seen


def _shape(reg) -> list:
    return [{k: v for k, v in s.to_dict().items() if k != "duration_s"}
            for s in reg.spans()]


def test_span_nesting_matches_the_reference():
    ours, ref = registry.Registry(), ref_registry.Registry()
    assert _nest(spans.span, spans.active_span, ours) == \
        _nest(ref_spans.span, ref_spans.active_span, ref)
    assert _shape(ours) == _shape(ref)
    assert [s.name for s in ours.spans("miner.sweep")] == ["miner.sweep"]
    assert all(s.duration_s >= 0 for s in ours.spans())
    # span_seconds: one observation per span, labeled by name.
    for name in ("miner.block", "miner.sweep", "miner.append"):
        h = ours.histogram("span_seconds", span=name)
        assert h.count == ref.histogram("span_seconds", span=name).count == 1
    outer = ours.histogram("span_seconds", span="miner.block").sum
    inner = ours.histogram("span_seconds", span="miner.sweep").sum
    assert outer >= inner


def test_span_survives_an_exception_as_the_reference():
    ours, ref = registry.Registry(), ref_registry.Registry()
    for span_fn, reg in ((spans.span, ours), (ref_spans.span, ref)):
        with pytest.raises(ValueError):
            with span_fn("miner.block", registry=reg):
                raise ValueError("boom")
    assert _shape(ours) == _shape(ref)
    assert spans.active_span() is None


def test_disabled_spans_record_nothing_as_the_reference():
    ours, ref = registry.Registry(), ref_registry.Registry()
    assert registry.set_telemetry_disabled(True) is False
    ref_registry.set_telemetry_disabled(True)
    with spans.span("miner.block", registry=ours) as s:
        assert spans.active_span() is None
    with ref_spans.span("miner.block", registry=ref) as r:
        pass
    assert s.to_dict() == r.to_dict()
    assert ours.spans() == [] and ref.spans() == []
    assert ours.render_prometheus() == ref.render_prometheus() == ""
    assert registry.telemetry_disabled()
    assert registry.set_telemetry_disabled(False) is True


def test_spans_on_two_threads_keep_their_own_stacks():
    ours = registry.Registry()
    barrier = threading.Barrier(2, timeout=30)
    parents = {}

    def work(tag):
        with spans.span(f"outer.{tag}", registry=ours):
            barrier.wait()
            with spans.span(f"inner.{tag}", registry=ours) as s:
                parents[tag] = s.parent
            barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert parents == {"a": "outer.a", "b": "outer.b"}


def test_spans_enter_the_profiler_only_while_it_records():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("miner.sweep"):
            torch.ones(4).sum()
    assert "miner.sweep" in {e.key for e in prof.key_averages()}
    assert spans._profiler_range("x").__class__.__name__ == "nullcontext"
    assert telemetry.span_seconds("miner.sweep") > 0


def _site_counts() -> dict:
    return {n: len(telemetry.default_registry().spans(n))
            for n in SITE_NAMES}


@pytest.mark.parametrize("pipeline", [True, False])
def test_miner_span_sites_match_the_reference(pipeline):
    """The port's Miner on the C++ backend files the reference's spans, as
    many of each name as the reference's Miner for the same chain."""
    port = Miner(MinerConfig(difficulty_bits=10, n_blocks=4, backend="cpu"),
                 pipeline=pipeline)
    port.mine_chain()
    ref = RefMiner(RefConfig(difficulty_bits=10, n_blocks=4, backend="cpu"),
                   pipeline=pipeline, log_fn=lambda d: None)
    ref.mine_chain()
    assert port.node.tip_hash == ref.node.tip_hash
    want = {n: len(ref_registry.default_registry().spans(n))
            for n in SITE_NAMES}
    assert _site_counts() == want
    assert want["miner.block"] == want["miner.append"] == 4
    blocks = telemetry.default_registry().spans("miner.block")
    assert [s.attrs["height"] for s in blocks] == [1, 2, 3, 4]


def test_cuda_backend_and_fused_span_sites():
    """One ``backend.cuda.dispatch`` and one ``backend.cuda.host_tail`` per
    search of the CUDA backend (plain version on the CPU); one
    ``fused.dispatch`` per k-block call and one ``miner.append`` per block
    of the fused miner."""
    cfg = MinerConfig(difficulty_bits=8, n_blocks=3, device="cpu",
                      batch_pow2=10)
    Miner(cfg).mine_chain()
    reg = telemetry.default_registry()
    assert len(reg.spans("backend.cuda.dispatch")) == 3
    assert len(reg.spans("backend.cuda.host_tail")) == 3
    assert len(reg.spans("miner.sweep")) == 3
    telemetry.reset()
    FusedMiner(cfg, blocks_per_call=2).mine_chain()
    reg = telemetry.default_registry()
    calls = reg.spans("fused.dispatch")
    assert [(s.attrs["k"], s.attrs["height"]) for s in calls] == \
        [(2, 0), (1, 2)]
    assert len(reg.spans("miner.append")) == 3
