"""BENCHMARK.json and the files it names: found by name, shaped to the
contract, extended by adding files alone."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import harness, spec

SPEC = spec.load_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "-m", "benchmark"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found_by_name(w):
    c = spec.cell(w)
    assert c.chips in (1, 4)
    assert spec.driver_file(c.traffic["driver"]).is_file()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert spec.metric_file(m["name"]).is_file()


def test_names_units_and_entries():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[kind]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/configs/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_the_issue_s_metrics():
    # The issue's metrics of the one-card cells, and fused-d20's rate
    # under a name of its own (PERF.md: its spread would otherwise set
    # the d24 cells' bound). The world's cell waits for a steadier world.
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"nonces_per_s", "nonces_per_s.d20", "block_p95_ms",
                        "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]
    assert set(e2e["nonces_per_s"]["workloads"]) == {"fused-d24",
                                                     "miner-d24"}
    assert e2e["nonces_per_s.d20"]["workloads"] == ["fused-d20"]
    assert e2e["block_p95_ms"]["workloads"] == ["miner-d24"]
    layers = {m["name"]: m for m in SPEC["per_layer"]}
    base = {"sweep_roofline", "step_us_per_block", "device_idle_pct",
            "dispatch_ms_per_block", "append_us_per_block"}
    assert set(layers) == base | {
        f"{n}.d20" for n in ("sweep_roofline", "step_us_per_block",
                             "device_idle_pct", "append_us_per_block")}
    for name, m in layers.items():
        if name.endswith(".d20"):
            assert m["workloads"] == ["fused-d20"]
            assert m["layer"] == layers[name[:-4]]["layer"]


def test_the_world_s_files_wait_beside_the_cells():
    # The four-card world's driver, configuration, traffic and metrics
    # stay loadable, so a cell is an entry away (PERF.md, §7).
    assert (spec.HERE / "configs" / "d24-mesh4.json").is_file()
    assert (spec.HERE / "workloads" / "fused-world.json").is_file()
    spec.load_module(spec.driver_file("fused-world"))
    for name in ("mesh_nonces_per_s", "select_ms_per_round"):
        spec.load_module(spec.metric_file(name))


def test_each_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w]), (m["name"], w)


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.cell("no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.cell("bad name")
    with pytest.raises(spec.SpecError):
        spec.metric_file("no_such_metric")
    with pytest.raises(spec.SpecError):
        spec.driver_file("no-such-driver")
    broken = dict(SPEC, workloads=[dict(SPEC["workloads"][0],
                                        traffic="no-such-traffic")])
    with pytest.raises(spec.SpecError):
        spec.cell(SPEC["workloads"][0]["name"], spec=broken)


def test_a_throwaway_workload_runs_from_a_temporary_directory(tiny):
    # A cell, a configuration and a traffic mix that exist only as files
    # and entries under a temporary directory; nothing else changes.
    c = tiny("t-fused")
    assert c.here != spec.HERE and c.config["difficulty_bits"] == 8
    result, rc = harness.run(c.name, 77, 0.05, False, device="cpu", cell=c)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert {"nonces_per_s", "setup_s"} <= set(result["metrics"])


def test_a_throwaway_metric_is_found_by_name(tiny, tmp_path):
    c = tiny("t-miner")
    (c.here / "metrics" / "blocks_in_window.py").write_text(
        "def read(run):\n    return float(len(run.blocks))\n")
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["per_layer"].append({"name": "blocks_in_window", "unit": "blocks",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "nonces_per_s",
                              "workloads": ["t-miner"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    c = spec.cell("t-miner", root=tmp_path, here=c.here)
    result, rc = harness.run(c.name, 78, 0.05, True, device="cpu", cell=c)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["blocks_in_window"]["value"] >= 1
