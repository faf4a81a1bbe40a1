"""The plain helpers of ``chip_smoke.py``, on synthetic input: those that
turn its measurements into numbers, and those that build phase 6's fault
plans, environments and checks. No card needed."""
import os

import numpy as np
import pytest

import chip_smoke
from chip_smoke import M32, block_gaps, spread


def _call(start: float, sweeps: list[float], step: float, copy: float,
          first_step: float = 50.0) -> dict:
    """Event times of one k-block call starting at ``start``: the first
    step takes ``first_step``, then each block the copy, its sweep of the
    given length, the next step and so on."""
    t = start + first_step
    out = {"sweeps": [], "steps": [t]}
    for length in sweeps:
        t += copy
        out["sweeps"].append((t, t + length))
        t += length + step
        out["steps"].append(t)
    return out


def test_gaps_are_taken_within_a_call_only():
    calls = [_call(0.0, [10.0, 20.0, 30.0], step=2.0, copy=0.5),
             _call(1000.0, [5.0, 5.0], step=3.0, copy=1.0)]
    split = block_gaps(calls)
    # 2 gaps in the first call, 1 in the second; none across the 900 ms
    # between the calls, nor before a call's first sweep.
    assert split["gap"] == pytest.approx([2.5, 2.5, 4.0])
    assert split["step"] == pytest.approx([2.0, 2.0, 3.0])
    assert split["copy"] == pytest.approx([0.5, 0.5, 1.0])
    one = block_gaps([_call(0.0, [7.0], step=1.0, copy=1.0)])
    assert one == {"gap": [], "step": [], "copy": []}


def test_gaps_without_step_events_are_not_split():
    call = _call(0.0, [1.0, 1.0, 1.0], step=4.0, copy=2.0)
    del call["steps"]
    assert block_gaps([call]) == {"gap": [6.0, 6.0], "step": [], "copy": []}


def test_spread_gives_median_p90_and_max():
    values = [float(v) for v in np.random.default_rng(3).permutation(100)]
    assert spread(values) == {"n": 100, "median": 50.0, "p90": 90.0,
                              "max": 99.0}
    assert spread([4.0]) == {"n": 1, "median": 4.0, "p90": 4.0, "max": 4.0}
    assert spread([]) == {"n": 0, "median": None, "p90": None, "max": None}
    # Over the gaps of a run: 99 a call at K = 100, 990 over 10 calls.
    calls = [_call(2000.0 * i, [1.0] * 100, step=float(i + 1), copy=1.0)
             for i in range(10)]
    gaps = spread(block_gaps(calls)["gap"])
    assert gaps == {"n": 990, "median": 7.0, "p90": 11.0, "max": 11.0}


def test_step_edge_cases_cover_every_edge():
    groups = chip_smoke.step_edge_cases(np.random.default_rng(0))
    assert [bits for *_, bits in groups] == list(chip_smoke.STEP_EDGE_BITS)
    for prev, data, heights, nonces, bits in groups:
        assert prev.dtype == data.dtype == nonces.dtype == np.uint32
        assert data.shape == (len(prev), 2, 8) and nonces.shape == (
            len(prev), 2)
        assert {int(w) for w in prev.ravel()} == {0, M32}
        assert all(len(set(row)) == 1 for row in prev.tolist())
        assert set(heights.tolist()) == {0, M32}
        assert set(nonces[:, 0].tolist()) == set(nonces[:, 1].tolist()) \
            == {0, M32}
        combos = {(int(p[0]), int(h), int(n[0]))
                  for p, h, n in zip(prev, heights, nonces)}
        assert len(combos) == len(prev) == 8


def test_fault_plan_is_what_mine_reads():
    from mpi_blockchain_tpu_torch.resilience.faultplan import FaultPlan

    plan = chip_smoke.fault_plan("backend.cuda.dispatch", "corrupt")
    spec = FaultPlan.from_dict(plan).faults[0]
    assert (spec.site, spec.kind, spec.call, spec.times) == (
        "backend.cuda.dispatch", "corrupt", 0, 1)
    plan = chip_smoke.fault_plan("backend.cpu.search", "hang", call=5,
                                 times=-1, seconds=0.01)
    spec = FaultPlan.from_dict(plan).faults[0]
    assert (spec.call, spec.times, spec.seconds) == (5, -1, 0.01)


def test_without_nvcc_hides_every_nvcc(tmp_path, monkeypatch):
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    bins = []
    for name in ("cuda_bin", "other_bin"):
        d = tmp_path / name
        d.mkdir()
        bins.append(d)
    (bins[0] / "nvcc").write_text("#!/bin/sh\n")
    (bins[0] / "nvcc").chmod(0o755)
    env = {"PATH": os.pathsep.join(str(b) for b in bins),
           "CUDA_HOME": str(bins[0].parent), "HOME": "/home/x"}
    got = chip_smoke.without_nvcc(env, str(tmp_path / "missing"))
    assert got["PATH"] == str(bins[1]) and got["HOME"] == "/home/x"
    assert got["CUDA_HOME"] == got["CUDA_PATH"] == str(tmp_path / "missing")
    for key in ("PATH", "CUDA_HOME"):
        monkeypatch.setenv(key, got[key])
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME",
                        got["CUDA_HOME"])
    assert sha256_cuda.find_nvcc() is None


def test_metric_total_sums_a_metrics_samples():
    from mpi_blockchain_tpu_torch import telemetry

    reg = telemetry.Registry()
    reg.counter("retries_total", site="dispatch.cuda:cuda").inc(2)
    reg.counter("retries_total", site="checkpoint.write").inc()
    reg.counter("retries_total_other").inc(7)
    reg.gauge("backend_degraded").set(1)
    text = reg.render_prometheus()
    assert chip_smoke.metric_total(text, "retries_total") == 3
    assert chip_smoke.metric_total(text, "backend_degraded") == 1
    assert chip_smoke.metric_total(text, "backend_degradations_total") == 0
    assert chip_smoke.metric_total("", "retries_total") == 0


def test_check_no_step_down():
    chip_smoke.check_no_step_down({"rung": "cuda:cuda"}, "cuda:cuda", "x")
    for summary in ({"rung": "cpu", "degraded": True, "degraded_to": "cpu"},
                    {"rung": "cuda:cuda", "degraded": True},
                    {"rung": "cuda:torch"}, {}):
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_no_step_down(summary, "cuda:cuda", "x")


def test_host_time_per_block():
    run = {"wall_s": 2.8, "kernel_s": 2.3}
    assert chip_smoke.host_ms_per_block(run, 1000) == pytest.approx(0.5)


def test_run_cli_returns_the_summary(capsys):
    rc, out = chip_smoke.run_cli(["mine", "--backend", "cpu",
                                  "--difficulty", "8", "--blocks", "2"])
    assert rc == 0 and out["height"] == 2 and out["rung"] == "cpu"
    assert capsys.readouterr().out == ""
