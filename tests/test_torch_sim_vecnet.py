"""The port's vectorized scenario engine (``sim/``) against the
reference's, on the CPU. The engine is host numpy in both packages (a
seeded lottery stands in for mining), so a scenario must give the same
summary and the same causal dump, byte for byte, and ``adversarial-bench``
the pin that ``PERF_HISTORY.jsonl`` records for the reference."""
import json
import pathlib

import pytest

from mpi_blockchain_tpu import sim as ref
from mpi_blockchain_tpu.config import ConfigError as RefConfigError
from mpi_blockchain_tpu.resilience import injection as ref_injection
from mpi_blockchain_tpu.resilience.faultplan import FaultPlan as RefPlan
from mpi_blockchain_tpu_torch import sim
from mpi_blockchain_tpu_torch.bench_lib import bench_sim_adversarial
from mpi_blockchain_tpu_torch.config import ConfigError
from mpi_blockchain_tpu_torch.resilience import injection
from mpi_blockchain_tpu_torch.resilience.faultplan import FaultPlan

REPO = pathlib.Path(__file__).resolve().parent.parent
PIN_KEYS = ("converged", "blocks_total", "reorgs", "sync_rejections",
            "final_bits", "n_nodes", "steps")


def _dump(net, path) -> bytes:
    net.dump_causal(path, meta={"case": "equality"})
    return path.read_bytes()


def test_smoke_preset_equals_the_reference_with_its_dump(tmp_path):
    net, summary = sim.run_scenario(sim.SCENARIO_PRESETS["adversarial-smoke"])
    ref_net, ref_summary = ref.run_scenario(
        ref.SCENARIO_PRESETS["adversarial-smoke"])
    assert summary == ref_summary
    assert summary["converged"] and summary["sync_rejections"] > 0
    assert _dump(net, tmp_path / "p.json") == _dump(ref_net,
                                                    tmp_path / "r.json")


def _pinned_bench() -> dict:
    """The reference's recorded ``sim_adversarial`` payloads of
    adversarial-bench; every record must agree on the outcome."""
    rows = [json.loads(line) for line in
            (REPO / "PERF_HISTORY.jsonl").read_text().splitlines()
            if line.strip()]
    pins = [r["payload"] for r in rows
            if r.get("key") == "sim_adversarial/adversarial-bench"]
    assert pins
    outcomes = {tuple(p[k] for k in PIN_KEYS) for p in pins}
    assert len(outcomes) == 1, outcomes
    return pins[0]


def test_bench_preset_reproduces_the_references_pin():
    got = bench_sim_adversarial()
    pin = _pinned_bench()
    assert {k: got[k] for k in PIN_KEYS} == {k: pin[k] for k in PIN_KEYS}
    assert got == {**got, "converged": True, "blocks_total": 419,
                   "reorgs": 5506, "sync_rejections": 37, "final_bits": 16}
    assert set(got) == set(pin) - {"reps", "spread_pct",
                                   "all_steps_per_sec"}
    assert got["preset"] == "adversarial-bench" and got["steps_per_sec"] > 0


def test_scenario_preset_names_match_the_reference():
    from mpi_blockchain_tpu_torch.cli import SCENARIO_PRESET_NAMES
    assert sorted(SCENARIO_PRESET_NAMES) == sorted(sim.SCENARIO_PRESETS) \
        == sorted(ref.SCENARIO_PRESETS)
    for name, sc in sim.SCENARIO_PRESETS.items():
        assert repr(sc).replace("mpi_blockchain_tpu_torch", "") == \
            repr(ref.SCENARIO_PRESETS[name]).replace("mpi_blockchain_tpu",
                                                     "")


def _parsed(parse, arg):
    try:
        return ("ok", repr(parse(arg)))
    except (ConfigError, RefConfigError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("kind,arg", [
    ("adversary", "selfish:node=1,hashrate=8"),
    ("adversary", "eclipse:node=2,victim=5,start=50,until=120"),
    ("adversary", "flood:node=3,every=25"),
    ("adversary", "eclipse:node=2"),
    ("adversary", "ddos:node=1"),
    ("adversary", "flood:node"),
    ("adversary", "selfish:node=-1"),
    ("adversary", "selfish:node=1,hashrate=0"),
    ("adversary", "flood:node=1,every=0"),
    ("adversary", "eclipse:node=1,victim=1"),
    ("adversary", "selfish:node=x"),
    ("latency", "2"),
    ("latency", "1-3"),
    ("latency", "0"),
    ("latency", "3-1"),
    ("latency", "a"),
    ("latency", "-1"),
    ("retarget", "2000:1:20"),
    ("retarget", "50"),
    ("retarget", "a:b"),
    ("retarget", "1:2:3:4"),
    ("retarget", "-1"),
    ("churn", (7, 24, 420, 4)),
    ("churn", (11, 200, 1500, 10)),
    ("churn", (0, 3, 10, 50)),
    ("churn", (1, 8, 100, -1)),
])
def test_spec_parsing_equals_the_reference(kind, arg):
    """What each parser makes of a spec, or the error it raises, is the
    reference's, message included."""
    parsers = {
        "adversary": (sim.AdversarySpec.parse, ref.AdversarySpec.parse),
        "latency": (sim.LatencySpec.parse, ref.LatencySpec.parse),
        "retarget": (sim.RetargetRule.parse, ref.RetargetRule.parse),
        "churn": (lambda a: sim.ChurnSchedule.from_seed(*a),
                  lambda a: ref.ChurnSchedule.from_seed(*a)),
    }
    port_parse, ref_parse = parsers[kind]
    got, want = _parsed(port_parse, arg), _parsed(ref_parse, arg)
    assert got[0] in ("ok", "ConfigError") and got[0] == want[0]
    assert got[1].replace("mpi_blockchain_tpu_torch", "") == \
        want[1].replace("mpi_blockchain_tpu", "")


def _churned(mod, plan, inj, sc):
    inj.arm(plan)
    try:
        return mod.run_scenario(sc)
    finally:
        inj.disarm()


def test_sim_churn_fault_crashes_nodes_as_the_reference(tmp_path):
    """An armed plan's ``sim.churn`` site crash-restarts seeded-chosen
    nodes, recorded causally, and the run is the reference's, dump and
    all; unarmed, no churn happens."""
    spec = {"version": 1, "seed": 1, "faults": [
        {"site": "sim.churn", "kind": "partial", "call": 10, "times": 2}]}
    kw = dict(n_nodes=8, steps=80, seed=6, difficulty_bits=8,
              hashes_per_step=16, record_deliveries=True,
              converge_margin=200)
    net, summary = _churned(sim, FaultPlan.from_dict(spec), injection,
                            sim.Scenario(**kw))
    ref_net, ref_summary = _churned(ref, RefPlan.from_dict(spec),
                                    ref_injection, ref.Scenario(**kw))
    injected = [e for e in net.bus_log.events()
                if e["kind"] == "churn" and e.get("injected")]
    assert len(injected) == 2 and all(e["action"] == "crash"
                                      for e in injected)
    assert summary == ref_summary and summary["converged"]
    assert _dump(net, tmp_path / "p.json") == _dump(ref_net,
                                                    tmp_path / "r.json")
    again, _ = _churned(sim, FaultPlan.from_dict(spec), injection,
                        sim.Scenario(**kw))
    assert again.bus_log.events() == net.bus_log.events()
    quiet, _ = sim.run_scenario(sim.Scenario(**kw))
    assert not [e for e in quiet.bus_log.events() if e["kind"] == "churn"]


@pytest.mark.parametrize("kind", ["raise", "hang"])
def test_sim_churn_raise_or_hang_crashes_the_step(kind):
    from mpi_blockchain_tpu_torch.resilience import FaultInjected
    plan = FaultPlan.from_dict({"version": 1, "faults": [
        {"site": "sim.churn", "kind": kind, "call": 3, "seconds": 0.01}]})
    with pytest.raises(FaultInjected):
        _churned(sim, plan, injection,
                 sim.Scenario(n_nodes=4, steps=20, seed=1,
                              difficulty_bits=8))


def test_composed_scenario_equals_the_reference(tmp_path):
    """Churn, a partition, drops, retargeting and every adversary in one
    ad-hoc scenario."""
    def build(mod):
        return mod.Scenario(
            n_nodes=12, steps=200, seed=4, difficulty_bits=9,
            hashes_per_step=16,
            retarget=mod.RetargetRule(interval=30, step_bits=1, max_bits=11),
            latency=mod.LatencySpec("uniform", 0, 2), drop_rate_pct=5,
            partitions=(mod.PartitionWindow(start=40, until=70, groups=3),),
            churn=mod.ChurnSchedule.from_seed(4, 12, 200, 3),
            adversaries=(mod.AdversarySpec.parse("selfish:node=1,hashrate=6"),
                         mod.AdversarySpec.parse(
                             "eclipse:node=2,victim=7,start=90,until=130"),
                         mod.AdversarySpec.parse("flood:node=3,every=30")),
            record_deliveries=True, converge_margin=300)
    net, summary = sim.run_scenario(build(sim))
    ref_net, ref_summary = ref.run_scenario(build(ref))
    assert summary == ref_summary
    assert _dump(net, tmp_path / "p.json") == _dump(ref_net,
                                                    tmp_path / "r.json")
