"""The port's elastic and skew smokes on the CPU, their ranks on the C++
sweep as ``--device cpu`` asks: the SIGKILL phase (the survivors evict the
killed rank through the shard oracle while still mining, each firing one
``stale_rank`` incident), the seeded ``mesh.rank_death`` determinism
phase, the skew smoke's join and bound, and both smokes' clean refusal
without a card."""
import contextlib
import io
import json

import pytest
import torch

from mpi_blockchain_tpu_torch.meshwatch import __main__ as mesh_cli
from mpi_blockchain_tpu_torch.meshwatch.aggregate import (rank_status,
                                                          read_shards)
from mpi_blockchain_tpu_torch.resilience import __main__ as res_cli


def _run(main, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else {})


def test_sigkilled_rank_is_evicted_by_the_shard_oracle(tmp_path):
    got = res_cli.smoke_elastic_sigkill(tmp_path, "cpu")
    victim = got["victim"]
    assert victim == res_cli.ELASTIC_VICTIM
    status = rank_status(read_shards(tmp_path / "sigkill" / "mesh"),
                         stall_s=2.0)["ranks"][str(victim)]
    assert (status["recommended_action"], status["stale_reason"]) == \
        ("evict", "dead-shard")
    assert sorted(got["summaries"]) == [0, 1, 3]
    for r, summary in got["summaries"].items():
        # Evicted while still mining: blocks after the eviction were
        # mined on the re-striped windows.
        assert got["eviction_heights"][r] < summary["height"]
        assert summary["mesh"]["live"] == [0, 1, 3]
        incidents = [m for m in got["shards"][r]["registry"].get(
            "incidents_total", []) if m["labels"]["rule"] == "stale_rank"]
        assert sum(m["value"] for m in incidents) == 1


def test_rank_death_determinism_phase(tmp_path):
    got = res_cli.smoke_elastic_determinism(tmp_path, "cpu")
    assert got["victim"] != 0 and got["height"] == 3
    assert sorted(got["dump_bytes"]) == sorted(
        set(range(res_cli.ELASTIC_WORLD)) - {got["victim"]})


def test_skew_smoke_joins_every_rank_within_the_bound():
    rc, out = _run(mesh_cli.main, ["skew-smoke", "--device", "cpu"])
    assert rc == 0 and out["ok"] and out["verdict"] != "regression"
    assert out["world"] == 4 and out["rounds"] >= 8
    assert 0 <= out["straggler_rank"] < 4


@pytest.mark.parametrize("main,argv", [
    (res_cli.main, ["elastic-smoke"]),
    (mesh_cli.main, ["skew-smoke"]),
], ids=["elastic", "skew"])
def test_smokes_refuse_to_run_elsewhere_without_a_card(monkeypatch, main,
                                                       argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run(main, argv)
    assert rc == 2 and "no CUDA device" in out["error"]
