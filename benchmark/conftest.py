"""Fixtures of the benchmark's own tests: a throwaway copy of the
benchmark with cells small enough for the CPU, found by name from a
temporary directory as the real cells are from the checkout."""
from __future__ import annotations

import json
import shutil

import pytest

from benchmark import spec

TINY_TRAFFIC = {"span_nonces_pow2": 10, "trace_nonces_pow2": 10,
                "check_nonces_pow2": 14, "blocks_per_call": 4,
                "warmup_blocks": 2}
TINY_CELLS = {
    # name: (config file, config changes, traffic, chips)
    "t-fused": ("d24-b24", {"difficulty_bits": 8, "batch_pow2": 8},
                "fused", 1),
    "t-miner": ("d24-b24", {"difficulty_bits": 8, "batch_pow2": 8},
                "pipelined", 1),
    "t-world": ("d24-mesh4", {"difficulty_bits": 8, "batch_pow2": 6,
                              "devices": 2}, "fused-world", 2),
}


def make_tiny(tmp_path):
    """A copy of ``benchmark/`` and a BENCHMARK.json of CPU-sized cells
    under ``tmp_path``; returns the copy's folder."""
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    real = spec.load_spec()
    out = dict(real, configs=[], workloads=[])
    for name, (config, changes, traffic, chips) in TINY_CELLS.items():
        conf = json.loads((spec.HERE / "configs" / f"{config}.json")
                          .read_text())
        conf.update(changes)
        (here / "configs" / f"{name}.json").write_text(json.dumps(conf))
        tr = json.loads((spec.HERE / "workloads" / f"{traffic}.json")
                        .read_text())
        tr.update(TINY_TRAFFIC)
        (here / "workloads" / f"tiny-{traffic}.json").write_text(
            json.dumps(tr))
        out["configs"].append({"name": name, "source": "test",
                               "file": f"benchmark/configs/{name}.json",
                               "reduced": [], "why": "test"})
        out["workloads"].append({"name": name, "config": name,
                                 "traffic": f"tiny-{traffic}",
                                 "chips": chips, "why": "test"})
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(TINY_CELLS)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(out))
    return here


@pytest.fixture
def tiny(tmp_path):
    """``cell(name)`` of the throwaway benchmark."""
    here = make_tiny(tmp_path)
    return lambda name: spec.cell(name, root=tmp_path, here=here)
