"""The port's three multi-rank smokes, on the CPU (``--device cpu``).

``meshwatch smoke`` (four ranks, one SIGKILLed), ``chainwatch smoke`` (a
faulted four-rank world fires exactly one ``event_storm`` with a complete
bundle, a clean one none) and ``blocktrace smoke`` (two ranks, every
height's critical path complete) pass with their ranks on the C++ sweep.
The trace smoke's two overhead gates are fed fixed reads here (one over
the bound, then one under), so the test holds the gate's logic and not
the host's weather. With no card and no ``--device cpu``, each smoke
refuses at once with the port's clean error (rc 2), spawning nothing.
"""
import contextlib
import io
import json

import pytest
import torch

from mpi_blockchain_tpu_torch.blocktrace import __main__ as trace_cli
from mpi_blockchain_tpu_torch.blocktrace import overhead
from mpi_blockchain_tpu_torch.chainwatch import __main__ as watch_cli
from mpi_blockchain_tpu_torch.meshwatch import __main__ as mesh_cli
from mpi_blockchain_tpu_torch.meshwatch import world

torch.set_num_threads(1)

CLIS = {"meshwatch": mesh_cli, "chainwatch": watch_cli,
        "blocktrace": trace_cli}


def _run(cli, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_meshwatch_smoke_on_the_cpu():
    rc, out = _run(mesh_cli, ["smoke", "--device", "cpu"])
    assert rc == 0 and out["ok"] is True
    assert out["stale_ranks"] == [mesh_cli.SMOKE_VICTIM]
    assert out["ranks"] == [0, 1, 2, 3] and out["pipeline_dispatches"] > 0


def test_chainwatch_smoke_on_the_cpu():
    rc, out = _run(watch_cli, ["smoke", "--device", "cpu"])
    assert rc == 0
    assert out == {"event": "incident_smoke", "ok": True,
                   "incident_rule": "event_storm",
                   "incident_rank": watch_cli.VICTIM,
                   "bundle_keys": out["bundle_keys"], "clean_incidents": 0}
    assert out["bundle_keys"] >= 20


def test_blocktrace_smoke_on_the_cpu(monkeypatch):
    reads = iter([4.5, 1.25])
    monkeypatch.setattr(overhead, "measure_trace_overhead",
                        lambda **kw: {"overhead_pct": next(reads),
                                      "device": kw["device"]})
    monkeypatch.setattr(overhead, "measure_block_observe",
                        lambda device: {"block_observe_us": 25.0})
    monkeypatch.setattr(trace_cli, "OVERHEAD_PAUSE_S", 0.0)
    rc, out = _run(trace_cli, ["smoke", "--device", "cpu"])
    assert rc == 0
    assert out["heights"] == list(range(1, trace_cli.SMOKE_WORLD[1] + 1))
    assert out["max_gap_pct"] < 5 and out["critical_slices"] > 0
    assert (out["overhead_pct"], out["block_observe_us"]) == (1.25, 25.0)


@pytest.mark.parametrize("name", sorted(CLIS))
def test_a_smoke_asked_for_the_card_refuses_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(world, "spawn_rank", no_spawn)
    rc, out = _run(CLIS[name], ["smoke"])
    assert rc == 2 and out["event"] == "error"
    assert "no CUDA device" in out["error"]


def _shard(step_downs: int = 0, retries: int = 0) -> dict:
    registry = {}
    if step_downs:
        registry["backend_degradations_total"] = [
            {"labels": {}, "value": float(step_downs)}]
    if retries:
        registry["retries_total"] = [
            {"labels": {"site": "dispatch.cuda:cuda"}, "value": 1.0},
            {"labels": {"site": "dispatch.cuda:torch"},
             "value": float(retries - 1)}]
    return {"rank": 1, "registry": registry}


def _out(**summary) -> str:
    return "block log\n" + json.dumps({"event": "chain_mined", **summary})


@pytest.mark.parametrize("device, shard, out, retries, fault", [
    ("cuda", _shard(), _out(rung="cuda:cuda"), 0, None),
    ("cpu", _shard(), _out(rung="cpu"), 0, None),
    ("cuda", _shard(), None, 0, None),
    ("cuda", _shard(retries=2), _out(rung="cuda:cuda"), 2, None),
    ("cuda", _shard(), _out(rung="cuda:torch"), 0, "mined on cuda:torch"),
    ("cuda", _shard(), _out(rung="cuda:cuda", degraded=True,
                            degraded_to="cpu"), 0, "degraded to cpu"),
    ("cpu", _shard(), _out(rung="cuda:cuda"), 0, "not cpu"),
    ("cuda", _shard(step_downs=1), None, 0, "1 step-downs"),
    ("cuda", _shard(retries=2), _out(rung="cuda:cuda"), 0, "2 retries"),
    ("cuda", _shard(), _out(rung="cuda:cuda"), 2, "0 retries"),
])
def test_rung_fault_names_a_rank_off_its_rung(device, shard, out, retries,
                                               fault):
    """Each smoke holds every rank to its device's rung: the summary's
    rung, no step-down in the summary or the shard, and exactly the
    retries its fault plan causes."""
    got = world.rung_fault(1, device, shard, out, retries=retries)
    if fault is None:
        assert got is None
    else:
        assert got.startswith("rank 1") and fault in got
