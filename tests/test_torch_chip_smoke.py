"""The plain helpers of ``chip_smoke.py``, on synthetic input: those that
turn its measurements into numbers, those that build phase 6's fault
plans, environments and checks, and phase 9's bounded-search cases and
pins. No card needed."""
import contextlib
import hashlib
import io
import json
import os
import types

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


def test_chain_nonces_and_mesh_hashes_tried_follow_the_chain():
    """Phase 8 reads each block's nonce from the chain file and sums the
    reference's accounting over them: held against the port's own miner
    with 8 logical miners, which counts each block as it mines."""
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner

    miner = Miner(MinerConfig(difficulty_bits=10, n_blocks=4, device="cpu",
                              n_miners=8, batch_pow2=6))
    miner.mine_chain()
    blob = miner.node.save()
    assert chip_smoke.chain_nonces(blob) == [r.nonce for r in miner.records]
    assert chip_smoke.mesh_hashes_tried(chip_smoke.chain_nonces(blob),
                                        8 << 6) == miner.total_hashes()
    assert chip_smoke.chain_nonces(blob[:80]) == []


def test_last_block_reads_the_verbose_log():
    err = "\n".join([
        "fault plan armed: x",
        '{"event": "block_mined", "height": 1, "hash": "aa"}',
        "[W1017 socket.cpp:207] a warning",
        '{"event": "block_mined", "height": 2, "hash": "bb"}',
        '{"event": "retry", "site": "dispatch"}'])
    assert chip_smoke.last_block(err) == {"event": "block_mined",
                                          "height": 2, "hash": "bb"}
    assert chip_smoke.last_block("") == {}


def test_span_ms_per_block_reads_span_seconds():
    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.telemetry.spans import Span

    telemetry.reset()
    reg = telemetry.default_registry()
    for name, seconds in (("miner.sweep", 0.002), ("miner.sweep", 0.004),
                          ("miner.append", 0.001)):
        reg.record_span(Span(name=name, duration_s=seconds))
    got = chip_smoke.span_ms_per_block(2)
    assert got["miner.sweep"] == pytest.approx(3.0)
    assert got["miner.append"] == pytest.approx(0.5)
    assert got["backend.cuda.host_tail"] == 0.0
    assert set(got) == set(chip_smoke.SPAN_NAMES)


def test_bounded_search_cases_cover_every_budget_and_start():
    from mpi_blockchain_tpu_torch import core

    cases = chip_smoke.bounded_search_cases(np.random.default_rng(5))
    seen = {(d, n) for _, d, _, n in cases}
    for d in chip_smoke.SIM_BOUNDED_DBITS:
        for count in chip_smoke.SIM_BOUNDED_COUNTS:
            assert (d, count) in seen
    assert all(0 <= start and start + n <= 1 << 32 and n >= 1
               for _, _, start, n in cases)
    ends = [start + n for _, _, start, n in cases]
    assert ends.count(1 << 32) >= 4 * len(chip_smoke.SIM_BOUNDED_COUNTS)
    assert any(start == 0 for _, _, start, _ in cases)
    odd = [(start, n) for _, _, start, n in cases
           if 0 < start and start + n < 1 << 32]
    assert odd and all(start % n == 0 and (start // n) % 2 == 1
                       for start, n in odd)
    winners = [c for c in cases
               if core.cpu_search(c[0], c[2], c[3], c[1])[0] is not None]
    assert {d for _, d, _, _ in winners} == set(chip_smoke.SIM_BOUNDED_DBITS)


@pytest.mark.parametrize("which", ["preset", "never"])
def test_sim_pins_are_what_the_cpp_sweep_gives(tmp_path, which):
    """Phase 9's pins, made once by the reference package, hold for the
    port's ``sim`` on the C++ sweep here: the same summary and dump."""
    from mpi_blockchain_tpu_torch import cli
    from mpi_blockchain_tpu_torch.telemetry import reset

    reset()
    if which == "preset":
        argv, pin = ["--difficulty", "16", "--blocks", "20"], \
            chip_smoke.SIM_PRESET_PIN
    else:
        argv, pin = list(chip_smoke.SIM_NEVER_ARGS), {
            **chip_smoke.SIM_NEVER_PIN["summary"],
            "dump_sha256": chip_smoke.SIM_NEVER_PIN["dump_sha256"]}
    dump = tmp_path / f"{which}.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["sim", *argv, "--backend", "cpu", "--events-dump",
                       str(dump)])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == (0 if which == "preset" else 1)
    assert {k: summary.get(k) for k in pin if k != "dump_sha256"} == \
        {k: v for k, v in pin.items() if k != "dump_sha256"}
    assert hashlib.sha256(dump.read_bytes()).hexdigest() == \
        pin["dump_sha256"]


def test_determinism_pin_is_the_cpp_sweeps(tmp_path):
    from mpi_blockchain_tpu_torch.resilience.__main__ import \
        smoke_determinism
    got = smoke_determinism(tmp_path, device="cpu")
    assert got["sha256"] == chip_smoke.SIM_DETERMINISM_SHA256


def test_phase_10_constants_are_the_serve_shapes():
    from mpi_blockchain_tpu_torch.service import __main__ as serve_smoke
    from mpi_blockchain_tpu_torch.service import frontdoor, mempool

    args = dict(zip(chip_smoke.SERVE_ARGS[::2], chip_smoke.SERVE_ARGS[1::2]))
    assert args == {"--difficulty": "24", "--batch-pow2": "24",
                    "--blocks": "1000"}
    assert chip_smoke.SERVE_LOAD == {"seed": 1337, "n": 2000, "workers": 4}
    assert sorted(chip_smoke.SERVE_TURNS) == ["load", "load", "quiet",
                                              "quiet"]
    assert chip_smoke.SERVE_TURNS[0] == chip_smoke.SERVE_TURNS[-1]
    # The default door knobs the full-width run takes.
    assert (mempool.DEFAULT_CAP, frontdoor.DEFAULT_TEMPLATE_TXS,
            frontdoor.DEFAULT_DEADLINE_S) == (512, 16, 5.0)
    # The smoke's shape is the reference's.
    assert (serve_smoke.SMOKE_SEED, serve_smoke.SMOKE_DIFFICULTY,
            serve_smoke.SMOKE_BLOCKS, serve_smoke.SMOKE_CAP,
            serve_smoke.SMOKE_TEMPLATE_TXS, serve_smoke.SMOKE_BATCH_A,
            serve_smoke.SMOKE_BATCH_B, serve_smoke.SMOKE_DEADLINE_S) == \
        (1337, 12, 6, 8, 4, 10, 16, 5.0)
    assert chip_smoke.SERVE_PROBE_HEIGHTS == {"healthz": 5, "metrics": 10}
    assert "--blocks" in chip_smoke.SERVE_METRICS_ARGS


def test_checked_heights_come_from_the_seed():
    hs = chip_smoke.checked_heights(1337, 1000)
    assert hs == chip_smoke.checked_heights(1337, 1000)
    assert len(set(hs)) == chip_smoke.SERVE_CHECKED_HEIGHTS
    assert all(1 <= h <= 1000 for h in hs) and hs == sorted(hs)
    assert chip_smoke.checked_heights(7, 3) != [] and \
        max(chip_smoke.checked_heights(7, 3)) <= 3


def test_lowest_winner_reads_the_chain_file():
    from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner

    miner = Miner(MinerConfig(difficulty_bits=10, n_blocks=3,
                              backend="cpu"), backend=CpuBackend())
    miner.mine_chain()
    blob = miner.node.save()
    for h, rec in enumerate(miner.records, start=1):
        assert chip_smoke.lowest_winner(blob, h, 10) == (rec.nonce,
                                                         rec.nonce)


def test_serve_run_streams_the_load_and_records_every_payload():
    """Phase 10 (b)'s run on the C++ sweep at a small size: the CLI's
    ``serve`` on a thread, the load from this one; the recorded payloads
    replay to the served tip through the sequential ``Miner``."""
    from mpi_blockchain_tpu_torch import service
    from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.service.frontdoor import TemplateFeed

    real, install = TemplateFeed.payload_for, service.install_service
    run = chip_smoke.serve_run(["--backend", "cpu", "--difficulty", "14",
                                "--blocks", "24"],
                               {"seed": 1337, "n": 40, "workers": 4})
    assert TemplateFeed.payload_for is real
    assert service.install_service is install
    assert service.active_service() is None
    summary, report = run["summary"], run["report"]
    assert summary["event"] == "chain_served" and summary["height"] == 24
    chip_smoke.check_load(report, run["state"], 40, "cpu")
    assert sorted(run["payloads"]) == list(range(1, 25))
    replay = Miner(MinerConfig(difficulty_bits=14, n_blocks=24,
                               backend="cpu"), backend=CpuBackend(),
                   pipeline=False)
    replay.payload_for = lambda h: run["payloads"][h]
    replay.mine_chain()
    assert replay.node.tip_hash.hex() == summary["tip_hash"]
    assert run["launches"] == 0 and run["step_launches"] == 0
    assert set(run["discards"]) <= {"restripe", "winner", "error"}
    assert set(run["span_s"]) == {"miner.sweep", "backend.cuda.dispatch"}
    row = chip_smoke.serve_row(run, 24)
    assert row["wall_s"] == summary["wall_s"]
    assert row["load_wall_s"] == report["wall_s"]
    assert row["included"] == summary["service"]["mempool"]["included_total"]
    assert row["requests_per_sec"] == report["requests_per_sec"]
    quiet = chip_smoke.serve_run(["--backend", "cpu", "--difficulty", "10",
                                  "--blocks", "3"], None)
    assert quiet["report"] is None
    assert all(b"|" not in d for d in quiet["payloads"].values())
    row = chip_smoke.serve_row(quiet, 3)
    assert row["wall_s"] == quiet["summary"]["wall_s"] is not None
    assert row["load_wall_s"] is None and row["discarded_share"] is None


def test_probing_blocks_scrapes_the_metrics_server_mid_run():
    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.models.miner import Miner

    telemetry.reset()
    real = Miner._block_mined
    with chip_smoke.probing_blocks(chip_smoke.SERVE_PROBE_HEIGHTS) as got:
        rc, summary = chip_smoke.run_cli(
            ["mine", "--backend", "cpu", "--difficulty", "12", "--blocks",
             "10", "--serve-metrics", "0"])
    assert Miner._block_mined is real and rc == 0
    code, body = got["healthz"]
    health = json.loads(body)
    assert (code, health["status"]) == (200, "ok")
    assert health["heartbeats"]["miner_heartbeat"]["value"] == 5
    prom = got["metrics"][1]
    assert chip_smoke.metric_total(prom, "blocks_mined_total") == 10
    assert chip_smoke.metric_total(prom, "hashes_tried_total") == \
        summary["hashes_tried"]


def test_discards_by_reason_reads_the_counter():
    from mpi_blockchain_tpu_torch import telemetry

    telemetry.reset()
    assert chip_smoke.discards_by_reason() == {}
    telemetry.counter("speculative_discards_total", reason="restripe").inc(3)
    telemetry.counter("speculative_discards_total", reason="winner").inc()
    assert chip_smoke.discards_by_reason() == {"restripe": 3, "winner": 1}


def test_tree_turns_runs_only_helpers_every_tree_has():
    """The tree-turns tool runs each checkout's own ``chip_smoke``
    helpers; they are here, as they are in the earlier trees it compares
    with."""
    from mpi_blockchain_tpu_torch.tools import tree_turns

    for name in ("mine_timed", "host_ms_per_block", "span_ms_per_block"):
        assert f"chip_smoke.{name}(" in tree_turns._RUN
        assert callable(getattr(chip_smoke, name))
    compile(tree_turns._RUN, "tree_turns._RUN", "exec")


def test_tree_turns_sim_runs_only_helpers_every_tree_has():
    """The config 5 workload runs ``chip_smoke.sim_run``, which the trees
    since the simulation's port have too."""
    from mpi_blockchain_tpu_torch.tools import tree_turns

    script, keys, describe = tree_turns.WORKLOADS["sim"]
    assert "chip_smoke.sim_run(" in script
    assert callable(chip_smoke.sim_run)
    compile(script, "tree_turns._SIM", "exec")
    assert "host_ms_per_search" in keys
    line = describe({"wall_s": 1.5, "launches": 4346,
                     "host_ms_per_search": 0.345, "cpp_wall_s": 1.1,
                     "dispatch_ms_per_search": 0.2})
    assert "4346 launches" in line and "0.345000 ms a search" in line


def test_tree_turns_step_runs_only_helpers_every_tree_has():
    """The step workload runs phase 5's step timing and the nvidia-smi
    reader, which the trees since the step's redesign have too, and
    reports the body in SM clocks beside the fused chain's wall."""
    import inspect

    from mpi_blockchain_tpu_torch.tools import tree_turns

    script, keys, describe = tree_turns.WORKLOADS["step"]
    for name in ("phase_step", "nvidia_smi"):
        assert f"chip_smoke.{name}(" in script
        assert callable(getattr(chip_smoke, name))
    assert list(inspect.signature(chip_smoke.phase_step).parameters) == \
        ["rng", "device", "clock_mhz"]
    compile(script, "tree_turns._STEP", "exec")
    assert keys == ("step_us", "body_clocks", "fused_wall_s")
    line = describe({"step_us": 6.5073, "body_clocks": 9331,
                     "fused_wall_s": 2.266})
    assert "body 9331 SM clocks" in line and "2.266000 s" in line


def test_tree_turns_trace_runs_only_helpers_every_tree_has():
    """The trace workload runs phase 11 a's miner with the helpers the
    trees since the tracing's port have, and reads the pipeline's bubble
    beside the sweeps' events."""
    from mpi_blockchain_tpu_torch.meshwatch import pipeline
    from mpi_blockchain_tpu_torch.tools import tree_turns

    script, keys, describe = tree_turns.WORKLOADS["trace"]
    for name in ("mine_timed", "host_ms_per_block"):
        assert f"chip_smoke.{name}(" in script
        assert callable(getattr(chip_smoke, name))
    assert callable(pipeline.pipeline_report)
    compile(script, "tree_turns._TRACE", "exec")
    assert keys == ("wall_s", "host_ms_per_block", "bubble_fraction",
                    "events_bubble")
    line = describe({"wall_s": 2.8, "kernel_s": 2.29,
                     "host_ms_per_block": 0.51, "bubble_fraction": 0.19,
                     "events_bubble": 0.1821, "pipeline_wall_s": 2.79})
    assert "bubble_fraction 0.19 against 1 - sweeps / wall 0.1821" in line


def test_tree_turns_overhead_reads_each_trees_audit():
    """The audit workload runs each tree's own overhead audit, whose
    payload the line describes."""
    from mpi_blockchain_tpu_torch.blocktrace.overhead import \
        measure_trace_overhead
    from mpi_blockchain_tpu_torch.tools import tree_turns

    script, keys, describe = tree_turns.WORKLOADS["overhead"]
    assert "measure_trace_overhead(device=\"cuda\")" in script
    compile(script, "tree_turns._OVERHEAD", "exec")
    assert keys == ("overhead_pct",)
    run = measure_trace_overhead(seconds=0.05, reps=1)
    assert describe(run) == (
        f"overhead {run['overhead_pct']}% (repetitions "
        f"{run['all_overhead_pct']}), {run['pairs']} pairs")


def test_tracing_cost_pairs_each_traced_run_with_its_neighbour():
    turns = chip_smoke.TRACE_TURNS[:8]
    host = [0.80, 0.50, 0.55, 0.70, 0.65, 0.60, 0.52, 0.66]
    rows = {"traced": [], "off": []}
    for turn, ms in zip(turns, host):
        rows[turn].append({"host_ms_per_block": ms, "wall_s": 2 + ms})
    cost = chip_smoke.tracing_cost(rows)
    # (0.80, 0.50), (0.70, 0.55), (0.65, 0.60), (0.66, 0.52)
    assert cost["pair_ms_per_block"] == [0.3, 0.15, 0.05, 0.14]
    assert cost["median_ms_per_block"] == pytest.approx(0.145)
    assert cost["median_wall_s"]["traced"] == pytest.approx(2.68)
    assert cost["median_wall_s"]["off"] == pytest.approx(2.535)


def test_telemetry_us_per_block_prices_the_miners_calls():
    from mpi_blockchain_tpu_torch import telemetry

    telemetry.reset()
    got = chip_smoke.telemetry_us_per_block(200)
    assert set(got) == {"on", "off", "cost"}
    assert got["on"] > 0 and got["off"] > 0
    assert got["cost"] == got["on"] - got["off"]
    assert not telemetry.telemetry_disabled()
    # With the switch off nothing was counted; with it on, every call.
    assert telemetry.default_registry().total("blocks_mined_total") == 400


def test_served_cases_window_each_winner_of_a_chain():
    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner

    miner = Miner(MinerConfig(difficulty_bits=12, n_blocks=4,
                              backend="cpu"), backend=CpuBackend())
    miner.mine_chain()
    blob = miner.node.save()
    cases = chip_smoke.served_cases(blob, [1, 2, 3, 4], 12, half=1 << 10)
    assert [c[0] for c in cases] == [blob[80 * h:80 * h + 80]
                                     for h in (1, 2, 3, 4)]
    for (header, d, start, n), rec in zip(cases, miner.records):
        assert d == 12 and start <= rec.nonce < start + n
        assert start == max(0, rec.nonce - (1 << 10))
        # The chain's winner is the lowest from 0, so the lowest in its
        # window is the winner itself.
        assert core.cpu_search(header, start, n, d)[0] == rec.nonce
    top = chip_smoke.served_cases(bytes(80) + bytes(76) + b"\xff" * 4,
                                  [1], 8, half=16)
    assert top[0][2] + top[0][3] == 1 << 32


# ---- phase 11: per-block tracing ------------------------------------------


def test_device_union_may_not_exceed_the_sweeps_events():
    chip_smoke.check_device_union(2.30, 2.39, "ok")
    chip_smoke.check_device_union(2.39, 2.39, "equal")
    with pytest.raises(chip_smoke.SmokeFailure, match="exceeds"):
        chip_smoke.check_device_union(2.39 * 1.001, 2.39, "over")
    # A window stamped at the consume reads the whole wall as busy.
    with pytest.raises(chip_smoke.SmokeFailure, match="exceeds"):
        chip_smoke.check_device_union(3.66, 2.39, "consume-stamped")


def test_bubble_check_holds_the_pipeline_to_the_sweeps_events():
    assert chip_smoke.check_bubble(0.2004, 2.332377, 2.853362, "ok") == (
        pytest.approx(1 - 2.332377 / 2.853362))
    # The refused run: the launch wrapper's host work on an idle card,
    # timed as busy, pulled the event-based share down by 0.0655.
    with pytest.raises(chip_smoke.SmokeFailure, match="bubble_fraction"):
        chip_smoke.check_bubble(0.2735, 0.792, 1.0, "over")
    # Windows stamped at the consume read an idle card as busy.
    with pytest.raises(chip_smoke.SmokeFailure, match="bubble_fraction"):
        chip_smoke.check_bubble(0.0, 2.332377, 2.853362, "consume-stamped")


class _Log:
    def __init__(self):
        self.calls = []

    def event(self):
        log = self.calls
        n = sum(1 for c in log if c[0] == "new")
        log.append(("new", n))

        class Event:
            def record(self):
                log.append(("record", n))
        return Event()


def test_library_bracket_times_the_librarys_call_alone():
    log = _Log()

    def entry(name):
        def call(*args):
            log.calls.append((name, args))
            return 7
        return call

    lib = types.SimpleNamespace(**{n: entry(n)
                                   for n in chip_smoke.SWEEP_ENTRIES},
                                sha256d_block_step_launch=entry("step"))
    saved = dict(vars(lib))
    events = []
    with chip_smoke.timed_library_calls(lib, events, log.event):
        assert lib.sha256d_sweep_launch(1, 2) == 7
        assert lib.sha256d_sweep_launch_timed(3) == 7
        assert lib.sha256d_block_step_launch(4) == 7
    # Each sweep entry between its own pair; the step is not a sweep.
    assert log.calls == [
        ("new", 0), ("new", 1), ("record", 0),
        ("sha256d_sweep_launch", (1, 2)), ("record", 1),
        ("new", 2), ("new", 3), ("record", 2),
        ("sha256d_sweep_launch_timed", (3,)), ("record", 3),
        ("step", (4,))]
    assert len(events) == 2
    assert vars(lib) == saved
    with pytest.raises(RuntimeError):
        with chip_smoke.timed_library_calls(lib, events, log.event):
            raise RuntimeError
    assert vars(lib) == saved
    with pytest.raises(ValueError, match="bracket"):
        chip_smoke.mine_timed(None, bracket="kernel")


def _report(gaps: dict) -> dict:
    from mpi_blockchain_tpu_torch.blocktrace.critical_path import \
        critical_path_report

    records = []
    for h, gap in gaps.items():
        t = float(h)
        records.append({"dispatch": h, "rank": 0, "meta": {"height": h},
                        "segments": [
                            {"stage": "enqueue", "t0": t, "t1": t + 0.001},
                            {"stage": "device", "t0": t + 0.001 + gap,
                             "t1": t + 0.01}]})
    return critical_path_report(records)


def test_critical_path_check_needs_every_height_complete():
    assert chip_smoke.check_critical_path(
        _report({1: 0.0, 2: 0.0001, 3: 0.0}), 3, "ok") < 5.0
    with pytest.raises(chip_smoke.SmokeFailure, match="block 2 "
                       "incomplete"):
        chip_smoke.check_critical_path(
            _report({1: 0.0, 2: 0.002, 3: 0.0}), 3, "gap")
    with pytest.raises(chip_smoke.SmokeFailure, match="heights"):
        chip_smoke.check_critical_path(_report({1: 0.0, 3: 0.0}), 3,
                                       "missing")


def test_no_incident_check_fails_on_any_trace_of_one(tmp_path):
    from mpi_blockchain_tpu_torch.telemetry.registry import Registry

    reg = Registry()
    chip_smoke.check_no_incident(str(tmp_path), [], reg, "clean")
    (tmp_path / "incident_0001_event_storm.json").write_text("{}")
    with pytest.raises(chip_smoke.SmokeFailure, match="raised incidents"):
        chip_smoke.check_no_incident(str(tmp_path), [], reg, "bundle")
    (tmp_path / "incident_0001_event_storm.json").unlink()
    with pytest.raises(chip_smoke.SmokeFailure, match="raised incidents"):
        chip_smoke.check_no_incident(str(tmp_path), [{"rule": "x"}], reg,
                                     "event")
    reg.counter("incidents_total", rule="x", severity="warn").inc()
    with pytest.raises(chip_smoke.SmokeFailure, match="raised incidents"):
        chip_smoke.check_no_incident(str(tmp_path), [], reg, "counter")


def test_phase_11_plan_and_knobs_are_what_mine_reads():
    from mpi_blockchain_tpu_torch.chainwatch.rules import EventStorm
    from mpi_blockchain_tpu_torch.resilience.faultplan import FaultPlan

    spec = FaultPlan.from_dict({"version": 1, "strict": True, "faults": [
        chip_smoke.INCIDENT_FAULT]}).faults[0]
    assert (spec.site, spec.kind, spec.call, spec.times) == (
        "backend.cuda.dispatch", "raise", 2, 2)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in chip_smoke.INCIDENT_ENV.items():
            mp.setenv(k, v)
        rule = EventStorm()
    assert (rule.storm_n, rule.window_s) == (3, 60.0)
    assert chip_smoke.TRACE_TURNS == ("traced", "off", "off", "traced") * 3
    assert chip_smoke.OVERHEAD_ATTEMPTS[0] == {}
    assert len(chip_smoke.OVERHEAD_ATTEMPTS) == 4


def test_phase_12_final_shard_check_needs_the_cards_watermarks(tmp_path):
    from mpi_blockchain_tpu_torch import telemetry

    telemetry.reset()
    rc, summary = chip_smoke.run_cli(["mine", "--backend", "cpu",
                                      "--difficulty", "8", "--blocks", "3",
                                      "--mesh-obs", str(tmp_path)])
    assert rc == 0
    # A CPU rank carries no cuda:0 watermarks: the card's check refuses it.
    with pytest.raises(chip_smoke.SmokeFailure, match="memory"):
        chip_smoke.check_final_shard(str(tmp_path), summary, "cpu")
    with pytest.raises(chip_smoke.SmokeFailure, match="hashes_tried_total"):
        chip_smoke.check_final_shard(
            str(tmp_path), {**summary, "hashes_tried": 1}, "cpu")


def test_phase_12_flush_cost_prices_a_full_shard(tmp_path):
    from mpi_blockchain_tpu_torch.meshwatch.pipeline import reset_profiler

    reset_profiler()
    chip_smoke.run_cli(["mine", "--backend", "cpu", "--difficulty", "8",
                        "--blocks", "20"])
    got = chip_smoke.flush_cost_ms(str(tmp_path), n=3)
    assert set(got) == {"payload_ms", "dumps_ms", "flush_ms", "bytes",
                        "pipeline_records"}
    assert got["pipeline_records"] == 20 and got["bytes"] > 0
    from mpi_blockchain_tpu_torch import chainwatch
    assert not chainwatch.installed()


def test_phase_12_run_module_reads_the_smokes_refusal():
    got = chip_smoke.run_module("mpi_blockchain_tpu_torch.chainwatch",
                                ["smoke"], 120)
    assert got["rc"] == 2 and got["out"]["event"] == "error"
    assert [name for name, *_ in chip_smoke.SMOKES] == [
        "meshwatch", "chainwatch", "blocktrace"]
    assert chip_smoke.MESH_OBS_TURNS == ("off", "obs", "obs", "off")


def test_phase_13_counting_entry_reports_a_ranks_launches(tmp_path):
    """A rank started through ``COUNTING_ENTRY`` mines as ``-m
    mpi_blockchain_tpu_torch`` would and reports the library's launch
    counter (0 on the C++ sweep) as its last stderr line."""
    from mpi_blockchain_tpu_torch.meshwatch.world import spawn_rank

    proc = spawn_rank(0, 1, tmp_path / "mesh",
                      ["--elastic", "--difficulty", "8", "--blocks", "2"],
                      "cpu", entry=chip_smoke.COUNTING_ENTRY)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-600:]
    assert json.loads(out.strip().splitlines()[-1])["mesh"]["live"] == [0]
    assert chip_smoke.rank_launches(err) == 0
    with pytest.raises(chip_smoke.SmokeFailure, match="no launch count"):
        chip_smoke.rank_launches("a rank that died\n")


def test_phase_13_registry_total_sums_labeled_samples():
    shard = {"registry": {"speculative_discards_total": [
        {"kind": "counter", "labels": {"reason": "restripe"}, "value": 2},
        {"kind": "counter", "labels": {"reason": "winner"}, "value": 5},
        {"kind": "counter", "labels": {"reason": "restripe"}, "value": 1}]}}
    assert chip_smoke.registry_total(shard, "speculative_discards_total",
                                     reason="restripe") == 3
    assert chip_smoke.registry_total(shard,
                                     "speculative_discards_total") == 8
    assert chip_smoke.registry_total(shard, "incidents_total") == 0


def test_phase_13_forensics_run_checks_sections_and_rows(tmp_path):
    from mpi_blockchain_tpu_torch import telemetry

    telemetry.reset()
    dump = str(tmp_path / "attack.json")
    rc, _ = chip_smoke.run_cli([*chip_smoke.FORENSICS_ATTACK_ARGS,
                                "--events-dump", dump])
    assert rc == 0
    got = chip_smoke.forensics_run(dump, str(tmp_path / "trace.json"))
    assert got["attacks"] and got["converged"] and got["blocks"] > 0
    # A dump the reader cannot read fails the phase.
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(chip_smoke.SmokeFailure, match="rc 2"):
        chip_smoke.forensics_run(str(bad), str(tmp_path / "t2.json"))


def test_phase_13_mesh_fault_shrinks_the_logical_miners(tmp_path):
    """13 c's plan and flags through the CLI on the CPU (the plain sweep,
    an easier chain): the fault lands mid-run, the miners shrink 4 -> 3,
    and the tip is the C++ oracle's."""
    from mpi_blockchain_tpu_torch import telemetry

    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"version": 1, "faults": [
        chip_smoke.ELASTIC_COLLECTIVE_FAULT]}))
    argv = list(chip_smoke.ELASTIC_MESH_ARGS)
    argv[argv.index("--difficulty") + 1] = "10"
    argv[argv.index("--batch-pow2") + 1] = "10"
    telemetry.reset()
    rc, got = chip_smoke.run_cli([*argv, "--device", "cpu",
                                  "--fault-plan", str(plan)])
    assert rc == 0
    mesh = got["mesh"]["device_mesh"]
    assert (mesh["n_miners"], mesh["n_live"], mesh["shrunk"]) == (4, 3, True)
    rc, oracle = chip_smoke.run_cli(["mine", "--backend", "cpu",
                                     "--difficulty", "10", "--blocks",
                                     "10"])
    assert rc == 0 and got["tip_hash"] == oracle["tip_hash"]
    assert chip_smoke.ELASTIC_CHAIN[:2] == ("--difficulty", "20")


def test_phase_13_run_module_reads_the_skew_smokes_refusal():
    got = chip_smoke.run_module("mpi_blockchain_tpu_torch.meshwatch",
                                ["skew-smoke"], 120)
    assert got["rc"] == 2 and got["out"]["event"] == "error"


def test_phase_15_world_argv_runs_the_cli_through_the_counting_entry():
    argv = chip_smoke.world_argv(chip_smoke.FUSED_WORLD_CHAIN,
                                 ["--fused"], 4321, 1)
    assert argv[1:5] == ["-X", "faulthandler",
                         *chip_smoke.WORLD_COUNTING_ENTRY]
    assert argv[5:] == ["mine", *chip_smoke.FUSED_WORLD_CHAIN, "--fused",
                        "--verbose", "--coordinator", "127.0.0.1:4321",
                        "--num-processes", "2", "--process-id", "1"]
    assert (24, 1000, 24) in chip_smoke.PINNED_TIPS
    assert chip_smoke.FUSED_WORLD_CHAIN == ("--difficulty", "24", "--blocks",
                                            "1000", "--batch-pow2", "24")


def test_phase_15_gloo_world_mines_a_given_chain_fused(tmp_path,
                                                       monkeypatch):
    """The generalized ``gloo_world`` on the CPU (the plain versions, an
    easier chain pinned to the C++ sweep's tip): both ranks reach the pin,
    rank 0 alone prints, and each rank reports its launches (none of a
    card kernel here) and one block_mined a block."""
    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner

    oracle = Miner(MinerConfig(difficulty_bits=11, n_blocks=4,
                               backend="cpu"))
    oracle.mine_chain()
    monkeypatch.setitem(chip_smoke.PINNED_TIPS, (11, 4, 9),
                        oracle.node.tip_hash.hex())
    out = tmp_path / "world.bin"
    summary, got, wall = chip_smoke.gloo_world(
        str(tmp_path), ["--device", "cpu", "--fused", "--blocks-per-call",
                        "2", "--out", str(out)], "15a on the CPU",
        chain=("--difficulty", "11", "--blocks", "4", "--batch-pow2", "9"),
        pin=(11, 4, 9))
    assert summary["fused"] and wall > 0
    assert out.read_bytes() == oracle.node.save()
    for _, err in got:
        assert chip_smoke.rank_counts(err) == {"sweep_launches": 0,
                                               "step_launches": 0}
        assert chip_smoke.block_heights(err) == [1, 2, 3, 4]
    nonces = chip_smoke.chain_nonces(out.read_bytes())
    assert chip_smoke.world_rounds(nonces, 2 << 9) == sum(
        n // 1024 + 1 for n in nonces) >= 4
    assert core.Node(11).load(out.read_bytes())


def test_phase_15_world_rounds_and_block_heights():
    assert chip_smoke.world_rounds([0, 1023, 1024, 5000], 1024) == \
        1 + 1 + 2 + 5
    assert chip_smoke.world_rounds([], 1024) == 0
    err = "\n".join(['{"event": "block_mined", "height": 1}',
                     "[W socket.cpp] a warning",
                     '{"event": "retry"}',
                     '{"event": "block_mined", "height": 2}'])
    assert chip_smoke.block_heights(err) == [1, 2]


def _matrix(status="tool_unusable", usable=False, errors=0, poisoned=1,
            plain_rc=0, cases=chip_smoke.SANITIZER_CASES):
    tool_run = {"usable": usable, "errors": errors, "rc": 0,
                "cases_failed": 0, "cases_passed": cases,
                "by_kernel": {"sha256d_sweep": errors},
                "tool_error": None if usable else
                "Error: Device not supported.", "tail": ""}
    return {"status": status, "reason": "", "sanitizer": "/cs",
            "plain": {"rc": plain_rc, "cases_failed": 0,
                      "cases_passed": cases, "tail": ""},
            "clean": {t: dict(tool_run) for t in
                      ("memcheck", "racecheck", "synccheck", "initcheck")},
            "poisoned": ({"memcheck:short": {"errors": poisoned},
                          "initcheck:uninit": {"errors": poisoned}}
                         if usable else {})}


def test_phase_16_sanitizer_verdicts():
    """A tool that cannot check here is said so on a line of its own; a
    usable one must run clean and catch its poisoned run; the driver's
    known answers must hold with no tool in every case."""
    lines = chip_smoke.sanitizer_verdicts(_matrix())
    assert len(lines) == 4 and all("cannot check on this machine" in ln
                                   for ln in lines)
    lines = chip_smoke.sanitizer_verdicts(_matrix("ok", usable=True))
    assert len(lines) == 4 and all("0 errors" in ln for ln in lines)
    for bad in (_matrix("errors", usable=True, errors=2),
                _matrix("errors", usable=True, poisoned=0),
                _matrix(plain_rc=1), _matrix(cases=3),
                {"status": "no_tool", "reason": "not found"}):
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.sanitizer_verdicts(bad)


def test_phase_17_budget_verdict_reads_the_movers_check(tmp_path):
    """Phase 17 holds each mover's ``--check`` to rc 0 and its
    ``reproduces`` line: a real check of the collective budget on the CPU
    passes, and the same check against a drifted budget fails the phase
    with the mover's own verdict."""
    module = "mpi_blockchain_tpu_torch.analysis.shard_budget"
    res = chip_smoke.run_module(module, ["--check", "--device", "cpu"], 240)
    line = chip_smoke.budget_verdict(res, "shard_budget", "17c")
    assert "reproduces" in line and "[2, 2] collectives" in line
    budget = json.loads((chip_smoke.pathlib.Path(chip_smoke.REPO_ROOT)
                         / "mpi_blockchain_tpu_torch/analysis/"
                           "SHARDBUDGET.json").read_text())
    budget["traced"]["cuda_world"]["sequence"][1]["reduce_op"] = "MAX"
    drifted = tmp_path / "SHARDBUDGET.json"
    drifted.write_text(json.dumps(budget, indent=1, sort_keys=True) + "\n")
    res = chip_smoke.run_module(module, ["--check", "--device", "cpu",
                                         "--baseline", str(drifted)], 240)
    with pytest.raises(chip_smoke.SmokeFailure, match="is stale"):
        chip_smoke.budget_verdict(res, "shard_budget", "17c")


def test_phase_17_fails_on_any_drifted_or_unarmed_census(monkeypatch):
    ok = {"transfer_budget": {"rc": 0, "wall_s": 1.0, "out": {"t": 1},
                              "err": "warning\ntransfer_budget: "
                                     "TRANSFERBUDGET.json reproduces (...)"},
          "opbudget": {"rc": 0, "wall_s": 1.0, "out": {
              "nvcc_release": "12.9, V12.9.86", "classes": {"1": {
                  "difficulty_bits": 24, "loop_instructions": 3122,
                  "alu_only": 1897, "source_adds": 1081,
                  "bound_sm_clocks_per_nonce": 29.640625}}},
              "err": "opbudget: OPBUDGET.json reproduces (...)"}}
    world = [{"rc": 0, "wall_s": 2.0,
              "err": "shard_budget: SHARDBUDGET.json reproduces (...)"}] * 2
    results = dict(ok)
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda q: "card, 700 W")
    monkeypatch.setattr(chip_smoke, "run_module",
                        lambda m, a, t: results[m.rsplit(".", 1)[1]])
    monkeypatch.setattr(chip_smoke, "budget_world", lambda: world)
    out = chip_smoke.phase_budgets()
    assert out["transfers"] == {"t": 1} and out["world_wall_s"] == 2.0
    bad = [("transfer_budget", {"rc": 1, "wall_s": 1.0, "out": {},
                                "err": "transfer_budget: the traced memcpy "
                                       "census drifted: ..."}),
           ("opbudget", {"rc": 1, "wall_s": 1.0, "out": {},
                         "err": "opbudget: the library was built by nvcc "
                                "release 13.0, the committed census by "
                                "12.9"}),
           ("opbudget", {"rc": 2, "wall_s": 1.0, "out": {},
                         "err": "opbudget: not armed: ..."})]
    for mover, res in bad:
        results = dict(ok, **{mover: res})
        with pytest.raises(chip_smoke.SmokeFailure, match=mover):
            chip_smoke.phase_budgets()
    results = dict(ok)
    world = [world[0], {"rc": 1, "wall_s": 2.0, "err": "shard_budget: "
                        "RATCHET INCREASE: traced collective census"}]
    with pytest.raises(chip_smoke.SmokeFailure, match="17c rank 1"):
        chip_smoke.phase_budgets()


def _gate_stdout(names, verdict="resolves"):
    lines = ["gate: device cuda: NVIDIA H100 80GB HBM3 (NVIDIA H100 80GB "
             "HBM3, 700.00 W)"]
    lines += [f"gate: {n}: {verdict}: python -m x --device cuda"
              for n in names]
    lines.append(f"gate: resolved {len(names)} step(s) on cuda in 2.0 s")
    return "\n".join(lines) + "\n"


def test_phase_18_gate_verdict_needs_every_step_resolved(monkeypatch):
    from mpi_blockchain_tpu_torch.gate import STEPS

    names = [s.name for s in STEPS]
    ok = {"rc": 0, "stdout": _gate_stdout(names), "err": "", "wall_s": 2.5}
    assert len(chip_smoke.gate_verdict(ok)) == len(STEPS) + 2
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda q: "card, 700 W")
    monkeypatch.setattr(chip_smoke, "run_module", lambda m, a, t: ok)
    assert chip_smoke.phase_gate() == {"wall_s": 2.5, "steps": len(STEPS)}
    bad = [dict(ok, rc=2, stdout='{"error": "no CUDA device is available"}'),
           dict(ok, stdout=_gate_stdout(names[:-1])),
           dict(ok, stdout=_gate_stdout(names).replace(
               "gate: lint: resolves", "gate: lint: its parser refused the "
               "arguments (exit 2)")),
           dict(ok, stdout=_gate_stdout(names).replace("device cuda",
                                                       "device cpu"))]
    for res in bad:
        with pytest.raises(chip_smoke.SmokeFailure, match="phase 18"):
            chip_smoke.gate_verdict(res)
