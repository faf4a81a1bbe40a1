"""The port's skew analyzer and Perfetto export against the reference's.

``analyze_skew``, ``skew_shape``, ``skew_summary`` and ``collect_spans``
give the reference's output, as JSON, exactly, on span sets made from
numpy seeds (several sites, rounds that miss ranks, per-rank clock
offsets, malformed spans); ``publish_skew`` fills the same registry
series, and chainwatch's ``collective_skew_spike`` rule fires on them at
the same samples in both packages. ``to_critical_path_trace`` gives the
reference's trace on the same report and records, with the collective,
incident and compile rows (the producer and the compile row keep the
port's names). The
pipeline-bubble audit's payload has the reference's keys and a chain
identical to the sequential oracle's, and the detector judges fixed
payloads as the reference's does.
"""
import json
import types

import numpy as np
import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.blocktrace import critical_path as ref_cp
from mpi_blockchain_tpu.blocktrace import export as ref_export
from mpi_blockchain_tpu.chainwatch import rules as ref_rules
from mpi_blockchain_tpu.meshprof import analyzer as ref_analyzer
from mpi_blockchain_tpu.meshwatch import bubble as ref_bubble
from mpi_blockchain_tpu.perfwatch import detector as ref_detector
from mpi_blockchain_tpu.perfwatch import history as ref_history
from mpi_blockchain_tpu.telemetry import registry as ref_registry
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.blocktrace import critical_path, export
from mpi_blockchain_tpu_torch.chainwatch import rules
from mpi_blockchain_tpu_torch.meshprof import analyzer
from mpi_blockchain_tpu_torch.meshwatch import bubble, pipeline
from mpi_blockchain_tpu_torch.perfwatch import detector, history
from mpi_blockchain_tpu_torch.telemetry import registry
from test_torch_blocktrace import RECORD_SETS

torch.set_num_threads(1)

SITES = ("mesh.sweep", "winner_select", "block.step")


def _reset():
    for tel in (telemetry, ref_telemetry):
        tel.reset()
        tel.clear_events()
        tel.set_telemetry_disabled(False)


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _json(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def span_shards(seed: int) -> list[dict]:
    """Shards of 1 to 6 ranks, each with a clock offset, a lag and a
    random subset of the rounds of up to three sites, plus malformed
    spans and a shard with no usable rank."""
    rng = np.random.default_rng(seed)
    world = int(rng.integers(1, 7))
    sites = [s for s in SITES if rng.uniform() < 0.7] or [SITES[0]]
    shards = []
    for rank in range(world):
        offset = float(rng.uniform(-5.0, 5.0))
        lag = float(rng.exponential(0.002))
        spans = []
        for site in sites:
            for rnd in range(int(rng.integers(1, 12))):
                if rng.uniform() < 0.15:
                    continue            # this rank missed the round
                t = 1000.0 + rnd * 0.05 + offset + lag \
                    + float(rng.uniform(0, 0.003))
                spans.append({"site": site, "round": rnd, "t_enter": t,
                              "t_exit": t + 0.001, "ok": True,
                              "height": rnd + 1})
        spans += [{"site": 7, "round": 1, "t_enter": 1.0},
                  {"site": "mesh.sweep", "round": None, "t_enter": 1.0},
                  {"site": "mesh.sweep", "round": "x", "t_enter": 1.0},
                  "not a span"]
        shards.append({"rank": rank, "skew_spans": spans})
    shards.append({"rank": "nope", "skew_spans": [
        {"site": "mesh.sweep", "round": 0, "t_enter": 0.0}]})
    return shards


SEEDS = range(20)


@pytest.mark.parametrize("seed", SEEDS)
def test_skew_analysis_equals_the_references(seed):
    shards = span_shards(seed)
    assert analyzer.collect_spans(shards) == \
        ref_analyzer.collect_spans(shards)
    for min_ranks in (1, 2, 3):
        got = analyzer.analyze_skew(shards, min_ranks=min_ranks)
        want = ref_analyzer.analyze_skew(shards, min_ranks=min_ranks)
        assert _json(got) == _json(want)
        assert _json(analyzer.skew_shape(got)) == \
            _json(ref_analyzer.skew_shape(want))
        assert _json(analyzer.skew_summary(got)) == \
            _json(ref_analyzer.skew_summary(want))


def test_the_seeded_sets_join_rounds_and_name_stragglers():
    joined = [analyzer.analyze_skew(span_shards(s)) for s in SEEDS]
    assert sum(r["site_count"] for r in joined) > 20
    assert {r["straggler_rank"] for r in joined} >= {-1, 0, 1}


def _fixed_clock(monkeypatch):
    """One clock for both registries: each gauge's ``age_s`` is read from
    its registry module's ``time.monotonic`` at the snapshot, so two
    snapshots taken a moment apart would differ by the moment."""
    clock = types.SimpleNamespace(monotonic=lambda: 1000.0)
    for module in (registry, ref_registry):
        monkeypatch.setattr(module, "time", clock)


@pytest.mark.parametrize("seed", [1, 4, 9])
def test_publish_skew_feeds_the_skew_rule_as_the_reference(seed,
                                                          monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_SKEW_MS", "1.0")
    monkeypatch.setenv("MPIBT_CHAINWATCH_SKEW_MIN_ROUNDS", "2")
    _fixed_clock(monkeypatch)
    report = analyzer.analyze_skew(span_shards(seed))
    analyzer.publish_skew(report)
    ref_analyzer.publish_skew(report)
    assert telemetry.default_registry().snapshot() == \
        ref_telemetry.default_registry().snapshot()
    rule, ref_rule = rules.CollectiveSkewSpike(), \
        ref_rules.CollectiveSkewSpike()
    ctx = {"height": None, "source": "test", "now": 0.0}
    got = [rule.evaluate(ctx) for _ in range(3)]
    assert got == [ref_rule.evaluate(ctx) for _ in range(3)]


@pytest.mark.parametrize("seed", [1, 4, 9])
def test_publish_skew_comparison_fails_on_a_gauge_left_unset(seed,
                                                             monkeypatch):
    """The fixed clock keeps the comparison's teeth: the port's overall
    straggler gauge left unset (registered, never set: no value, no age)
    must not compare equal to the reference's."""
    _fixed_clock(monkeypatch)
    report = analyzer.analyze_skew(span_shards(seed))
    set_gauge = registry.Gauge.set

    def skip_overall(self, value):
        if not (self.name == "mesh_straggler_rank" and not self.labels):
            set_gauge(self, value)

    monkeypatch.setattr(registry.Gauge, "set", skip_overall)
    analyzer.publish_skew(report)
    ref_analyzer.publish_skew(report)
    got = telemetry.default_registry().snapshot()
    want = ref_telemetry.default_registry().snapshot()
    assert got != want
    unset = [g for g in got["mesh_straggler_rank"] if not g["labels"]]
    assert unset and unset[0]["age_s"] is None


def test_the_skew_rule_fires_on_a_published_straggler(monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_SKEW_MS", "10.0")
    shards = [{"rank": r, "skew_spans": [
        {"site": "mesh.sweep", "round": i,
         "t_enter": 100.0 + i + (0.05 * (i % 2) if r == 1 else 0.0)}
        for i in range(8)]} for r in (0, 1)]
    analyzer.publish_skew(analyzer.analyze_skew(shards))
    rule = rules.CollectiveSkewSpike()
    fired = [rule.evaluate({"height": None, "source": "t", "now": 0.0})
             for _ in range(rule.debounce_n)]
    assert fired[-1] is not None and fired[-1]["site"] == "mesh.sweep"


# ---- the Perfetto export ----------------------------------------------------


def _lanes(seed: int):
    rng = np.random.default_rng(seed)
    spans = {str(r): [{"site": "mesh.sweep", "round": i,
                       "t_enter": 0.001 * i + float(rng.uniform(0, 1e-3)),
                       "t_exit": 0.001 * i + 2e-3, "height": i + 1}
                      for i in range(3)] + [{"site": "bad"}]
             for r in range(int(rng.integers(1, 4)))}
    incidents = [{"rule": "event_storm", "severity": "warn",
                  "incident_seq": 1, "opened_at": 0.004, "heights": [2],
                  "rank": 1}, {"rule": "broken"}]
    compiles = {"0": [{"site": "ops.sha256_cuda", "ms": 12.5, "t": 0.02,
                       "stage": "nvcc"}, {"site": "x"}],
                "1": [{"site": "fused", "ms": 1.0, "t": 0.01}]}
    return spans, incidents, compiles


def _as_the_ports(trace: dict) -> dict:
    """The reference's trace with the port's producer and its compile row
    under the port's name: the two differences."""
    if "source" in trace.get("metadata", {}):
        trace["metadata"]["source"] = pipeline.SOURCE
    for e in trace["traceEvents"]:
        if e.get("pid") == ref_export.COMPILE_PID and \
                e.get("name") == "process_name":
            assert e["args"]["name"] == "xla compiles"
            e["args"]["name"] = export.COMPILE_ROW
    return trace


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_critical_path_trace_equals_the_references(name):
    records = RECORD_SETS[name]
    report = critical_path.critical_path_report(records)
    assert _json(export.to_critical_path_trace(report, records)) == \
        _json(_as_the_ports(ref_export.to_critical_path_trace(report,
                                                              records)))
    lanes = _lanes(len(name))
    got = export.to_critical_path_trace(report, records, *lanes)
    want = ref_export.to_critical_path_trace(report, records, *lanes)
    assert _json(got) == _json(_as_the_ports(want))


def test_the_trace_rows_are_the_references():
    for pid in ("CRITICAL_PID", "COLLECTIVE_PID", "INCIDENT_PID",
                "COMPILE_PID"):
        assert getattr(export, pid) == getattr(ref_export, pid)
    records = RECORD_SETS["pipelined_overlap"] + RECORD_SETS["fused_batch"]
    report = ref_cp.critical_path_report(records)
    trace = export.to_critical_path_trace(report, records, *_lanes(2))
    pids = {e["pid"] for e in trace["traceEvents"]}
    assert {export.CRITICAL_PID, export.COLLECTIVE_PID,
            export.INCIDENT_PID, export.COMPILE_PID} <= pids
    flows = {e["ph"] for e in trace["traceEvents"]
             if e.get("pid") == export.CRITICAL_PID and e["ph"] in "stf"}
    assert flows >= {"s", "f"}


# ---- the pipeline-bubble audit ----------------------------------------------


def test_the_bubble_audit_payload_is_the_references():
    got = bubble.measure_pipeline_bubble(difficulty=12, blocks=4)
    want = ref_bubble.measure_pipeline_bubble(difficulty=12, blocks=4)
    assert set(got) == set(want)
    assert got["chain_identical"] is True
    assert (got["backend"], got["difficulty_bits"], got["n_blocks"],
            got["blocks"], got["dispatches"]) == \
        (want["backend"], 12, 4, 4, want["dispatches"])
    assert (bubble.AUDIT_DIFFICULTY, bubble.AUDIT_BLOCKS,
            bubble.AUDIT_PREFIX) == (ref_bubble.AUDIT_DIFFICULTY,
                                     ref_bubble.AUDIT_BLOCKS,
                                     ref_bubble.AUDIT_PREFIX)


@pytest.mark.parametrize("fraction", [0.0, 0.1499, 0.15, 0.1501, 0.9])
def test_the_detector_judges_the_bubble_as_the_reference(tmp_path,
                                                         fraction):
    payload = {"bubble_fraction": fraction, "backend": "cpu",
               "difficulty_bits": 15, "n_blocks": 12,
               "chain_identical": True}
    got = detector.check_candidate(
        history.HistoryStore(tmp_path / "p.jsonl"), "pipeline_bubble",
        payload)
    want = ref_detector.check_candidate(
        ref_history.HistoryStore(tmp_path / "r.jsonl"), "pipeline_bubble",
        payload)
    assert got.verdict == want.verdict
    assert got.verdict == ("regression" if fraction > 0.15 else "ok")
