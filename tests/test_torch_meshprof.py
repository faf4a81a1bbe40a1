"""The port's meshprof against the reference's, on the CPU.

Skew spans: the same spans (site, round, ok, height, template) in both
packages, rounds per site, copies out of the ring, the kill switch and
``clear_spans``. Memory: ``device_memory_stats`` reads PyTorch's caching
allocator where the reference reads the JAX device, and never initializes
CUDA in a process that has not (here, with no card, it stays cold); the
watermarks and the throttle over the same device stats equal the
reference's.
"""
import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.blocktrace import trace_block as ref_trace_block
from mpi_blockchain_tpu.meshprof import memory as ref_memory
from mpi_blockchain_tpu.meshprof import spans as ref_spans
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.blocktrace import trace_block
from mpi_blockchain_tpu_torch.meshprof import memory, spans

torch.set_num_threads(1)

PORT = {"spans": spans, "memory": memory, "telemetry": telemetry,
        "trace_block": trace_block}
REF = {"spans": ref_spans, "memory": ref_memory, "telemetry": ref_telemetry,
       "trace_block": ref_trace_block}


def _reset():
    for pkg in (PORT, REF):
        pkg["spans"].clear_spans()
        pkg["memory"].clear_memory()
        pkg["telemetry"].set_telemetry_disabled(False)


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _span_story(pkg) -> list:
    skew_span, tail = pkg["spans"].skew_span, pkg["spans"].spans_tail
    for _ in range(2):
        with skew_span(site="mesh.sweep"):
            pass
    with skew_span(site="block.step"):
        pass
    with pytest.raises(RuntimeError):
        with skew_span(site="winner_select"):
            raise RuntimeError("timeout")
    with pkg["trace_block"](7, template=2):
        with skew_span(site="block.step"):
            pass
    with pkg["trace_block"](8):
        with skew_span(site="mesh.sweep"):
            pass
    pkg["telemetry"].set_telemetry_disabled(True)
    with skew_span(site="mesh.sweep"):
        pass
    pkg["telemetry"].set_telemetry_disabled(False)
    with skew_span(site="mesh.sweep"):
        pass
    out = [{k: v for k, v in r.items() if k not in ("t_enter", "t_exit")}
           for r in tail()]
    assert all(r["t_exit"] >= r["t_enter"] for r in tail())
    copy = tail(2)
    copy[0]["site"] = "mutated"
    out.append([r["site"] for r in tail(2)])
    pkg["spans"].clear_spans()
    with skew_span(site="mesh.sweep"):
        pass
    out.append([(r["site"], r["round"]) for r in tail()])
    return out


def test_skew_spans_match_the_reference():
    got, want = _span_story(PORT), _span_story(REF)
    assert got == want
    assert got[0] == {"site": "mesh.sweep", "round": 0, "ok": True}
    assert got[3]["ok"] is False
    assert got[4]["height"] == 7 and got[4]["template"] == 2
    assert got[-1] == [("mesh.sweep", 0)]
    with pytest.raises(TypeError):
        spans.skew_span("mesh.sweep")


def test_memory_stays_cold_without_initializing_cuda(monkeypatch):
    """In a process that has not initialized CUDA the sampler returns
    nothing and initializes nothing."""
    def boom(*a, **k):
        raise AssertionError("the sampler initialized CUDA")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "_lazy_init", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    monkeypatch.setattr(torch.cuda, "get_device_properties", boom)
    assert memory.device_memory_stats() == {}
    assert memory.sample_memory(force=True) == {}
    assert memory.memory_snapshot() == {}


def test_memory_reads_the_caching_allocator_of_an_initialized_card(
        monkeypatch):
    stats = {0: {"allocated_bytes.all.current": 4096,
                 "allocated_bytes.all.peak": 8192,
                 "allocation.all.allocated": 12,
                 "reserved_bytes.all.current": 2 << 20},
             1: {}}
    asked = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: asked.append(i) or type(
                            "Props", (), {"total_memory": 80 << 30})())
    assert memory.device_memory_stats() == {"cuda:0": {
        "bytes_in_use": 4096, "peak_bytes_in_use": 8192, "num_allocs": 12,
        "bytes_limit": 80 << 30}}
    # A device with no allocation is skipped.
    assert asked == [0]
    snap = memory.memory_snapshot()
    assert snap["cuda:0"]["last_bytes_in_use"] == 4096


def _watermark_story(pkg, monkeypatch) -> list:
    mod = pkg["memory"]
    calls = []

    def growing():
        calls.append(1)
        return {"cuda:0": {"bytes_in_use": 100 + 50 * len(calls),
                           "peak_bytes_in_use": 400, "bytes_limit": 1000,
                           "num_allocs": len(calls)}}

    monkeypatch.setattr(mod, "device_memory_stats", growing)
    mod.sample_memory(force=True)
    mod.sample_memory()                 # throttled: no device query
    out = [len(calls), mod.memory_snapshot(), len(calls)]
    monkeypatch.setattr(mod, "device_memory_stats",
                        lambda: {"cuda:0": {"bytes_in_use": 10,
                                            "bytes_limit": 900}})
    out.append(mod.memory_snapshot())
    pkg["telemetry"].set_telemetry_disabled(True)
    out += [mod.sample_memory(force=True), mod.memory_snapshot()]
    pkg["telemetry"].set_telemetry_disabled(False)
    return out


def test_watermarks_and_throttle_match_the_reference(monkeypatch):
    got = _watermark_story(PORT, monkeypatch)
    want = _watermark_story(REF, monkeypatch)
    assert got == want
    assert got[:3] == [1, got[1], 2]
    assert got[1]["cuda:0"]["bytes_in_use"] == 200
    assert got[3]["cuda:0"]["bytes_in_use"] == 200        # high water
    assert got[3]["cuda:0"]["last_bytes_in_use"] == 10
    assert got[4:] == [{}, {}]


def test_the_profilers_dispatch_samples_memory(monkeypatch):
    from mpi_blockchain_tpu_torch.meshwatch.pipeline import PipelineProfiler

    calls = []
    monkeypatch.setattr(memory, "device_memory_stats",
                        lambda: calls.append(1) or {})
    prof = PipelineProfiler()
    prof.dispatch(kind="sweep")
    prof.dispatch(kind="sweep")         # inside the throttle interval
    assert calls == [1]
