"""The port's perf sentinel CLI (``python -m
mpi_blockchain_tpu_torch.perfwatch``) against the reference's, on the CPU.

Seeding a history from the repo's bench round records gives the same
entries line for line. ``record``, ``check`` (text and ``--json``, with
and without ``--candidate``) and ``report`` give the same findings, exit
codes and series on the reference's synthetic histories and on the seeded
one; only ``roofline`` differs by design (the card's bound, pinned here
on a synthetic card payload). The mesh views (``critical-path``,
``mesh-skew``, ``incidents``, ``compiles --no-probe``) over the shards of
a two-rank CPU world give the reference CLI's JSON, ``source`` aside.
``record`` without ``--history`` exits 2 and the repo's
``PERF_HISTORY.jsonl`` is never written. Exact.
"""
import hashlib
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from mpi_blockchain_tpu import dispatchwatch as ref_dispatchwatch
from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.meshwatch import pipeline as ref_pipeline
from mpi_blockchain_tpu.perfwatch import attribution as ref_attribution
from mpi_blockchain_tpu.perfwatch import history as ref_history
from mpi_blockchain_tpu.perfwatch.__main__ import main as ref_main
from mpi_blockchain_tpu.telemetry.spans import Span as RefSpan
from mpi_blockchain_tpu_torch import dispatchwatch, telemetry
from mpi_blockchain_tpu_torch.meshwatch import pipeline as port_pipeline
from mpi_blockchain_tpu_torch.meshwatch.world import REPO_ROOT, reap
from mpi_blockchain_tpu_torch.perfwatch import attribution, history
from mpi_blockchain_tpu_torch.perfwatch.__main__ import main
from mpi_blockchain_tpu_torch.telemetry.spans import Span

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPO_HISTORY = ROOT / history.DEFAULT_HISTORY_NAME
REPO_HISTORY_SHA = hashlib.sha256(REPO_HISTORY.read_bytes()).hexdigest()
SWEEP_ID = {"kernel": "pallas", "batch_pow2": 28, "n_miners": 1}
#: A card record of ``bench_lib.bench_cuda`` at 2^28 a call, with the
#: rate and the bound of the PERF.md kernel table.
CARD_SWEEP = {"backend": "cuda", "kernel": "cuda", "batch_pow2": 28,
              "n_miners": 1, "platform": "cuda",
              "hashes_per_sec_per_chip": 7.648e9, "kernel_ms": 34.5,
              "bound_ms": 30.443, "spread_pct": 0.5}
NOW = "2026-09-01T00:00:00Z"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    # One clock for both packages: entries recorded without their own
    # recorded_at take it, and findings carry it as baseline_at.
    for mod in (history, ref_history):
        monkeypatch.setattr(mod, "_utc_now", lambda: NOW)
    for pkg in (telemetry, ref_telemetry):
        pkg.reset()
        pkg.clear_events()
    dispatchwatch.clear_compiles()
    ref_dispatchwatch.clear_compiles()
    # `report` reads the in-process pipeline records; a test file run
    # before this one in the same process may have left some in either.
    port_pipeline.reset_profiler()
    ref_pipeline.reset_profiler()
    yield
    for pkg in (telemetry, ref_telemetry):
        pkg.reset()


def _cli(fn, argv, capsys) -> tuple[int, str, str]:
    rc = fn(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _both(argv, capsys) -> tuple[tuple, tuple]:
    return _cli(main, argv, capsys), _cli(ref_main, argv, capsys)


def _no_roofline(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "roofline"}


def _stderr_lines(err: str) -> list[str]:
    """stderr without the reference's VPU roofline line (the port's
    roofline is the card's, and a CPU history has none)."""
    return [line for line in err.splitlines()
            if not line.startswith("perfwatch: newest")]


def _write(path, series) -> None:
    store = history.HistoryStore(path)
    for section, metric, value, spread in series:
        store.record(section, {**SWEEP_ID, metric: value,
                               "spread_pct": spread}, source="t")


_SW, _CH = ("sweep", "hashes_per_sec_per_chip"), ("chain", "wall_s")
SERIES = {
    "drop": [(*_SW, v, 0.5) for v in (970e6, 969e6, 776e6)],
    "noise": [(*_SW, v, 0.5) for v in (970e6, 965e6)],
    "spread": [(*_SW, v, 9.0) for v in (970e6, 820e6)],
    "lower": [(*_CH, v, 0.5) for v in (18.6, 23.0)],
    "improved": [(*_CH, v, 0.5) for v in (23.0, 18.6)],
    "single": [(*_SW, 970e6, 0.5)],
}


@pytest.fixture(params=[*SERIES, "seeded"])
def hist(request, tmp_path) -> tuple[pathlib.Path, str, dict, float]:
    """A history file, the section and identity of the series a candidate
    is judged in, and that series' best value."""
    path = tmp_path / "h.jsonl"
    if request.param == "seeded":
        store = history.HistoryStore(path)
        history.seed_from_bench_rounds(store, ROOT)
        series = store.by_key("sweep")["sweep/pallas/tpu/b28/m1"]
        return path, "sweep", series[-1].payload, max(e.value
                                                      for e in series)
    series = SERIES[request.param]
    _write(path, series)
    section = series[0][0]
    pick = max if section == "sweep" else min
    return path, section, {**SWEEP_ID, "spread_pct": 0.5}, \
        pick(v for _, _, v, _ in series)


def test_check_text_equals_the_references(hist, capsys):
    path = hist[0]
    (rc, out, err), (ref_rc, ref_out, ref_err) = _both(
        ["check", "--history", str(path)], capsys)
    assert rc == ref_rc and out == ref_out and out
    assert _stderr_lines(err) == _stderr_lines(ref_err)


def test_check_json_and_report_equal_the_references(hist, capsys):
    path = hist[0]
    for argv in (["check", "--json"], ["report"]):
        (rc, out, _), (ref_rc, ref_out, _) = _both(
            [*argv, "--history", str(path)], capsys)
        got, want = json.loads(out), json.loads(ref_out)
        assert rc == ref_rc
        assert "roofline" not in got
        assert got == _no_roofline(want)


def test_check_candidate_equals_the_references(hist, tmp_path, capsys):
    """A candidate 20% worse than its series' best fails (rc 1), one equal
    to it passes; neither is recorded."""
    path, section, base, best = hist
    metric = history.SECTION_METRICS[section][0]
    before = path.read_bytes()
    worse = best * (0.8 if section == "sweep" else 1.25)
    for value, want_rc in ((worse, 1), (best, 0)):
        cand = tmp_path / "cand.json"
        cand.write_text(json.dumps({**base, metric: value}))
        argv = ["check", "--history", str(path), "--section", section,
                "--candidate", str(cand)]
        (rc, out, err), (ref_rc, ref_out, ref_err) = _both(argv, capsys)
        assert rc == ref_rc == want_rc and out == ref_out
        assert _stderr_lines(err) == _stderr_lines(ref_err)
        (rc, out, _), (_, ref_out, _) = _both([*argv, "--json"], capsys)
        assert rc == want_rc
        assert json.loads(out) == _no_roofline(json.loads(ref_out))
    assert path.read_bytes() == before      # the gate records nothing


def test_check_usage_errors_equal_the_references(tmp_path, capsys):
    path = tmp_path / "h.jsonl"
    _write(path, SERIES["noise"])
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    for argv in (["check", "--candidate", str(bad)],
                 ["check", "--section", "sweep", "--candidate", str(bad)],
                 ["check", "--section", "sweep", "--candidate",
                  str(tmp_path / "missing.json")]):
        (rc, out, _), (ref_rc, ref_out, _) = _both(
            [*argv, "--history", str(path)], capsys)
        assert rc == ref_rc == 2 and out == ref_out == ""


def test_seeding_equals_the_references_line_for_line(tmp_path, capsys):
    got, want = tmp_path / "p.jsonl", tmp_path / "r.jsonl"
    assert history.seed_from_bench_rounds(history.HistoryStore(got), ROOT) \
        == ref_history.seed_from_bench_rounds(
            ref_history.HistoryStore(want), ROOT)
    assert got.read_text() == want.read_text()
    assert len(got.read_text().splitlines()) >= 8
    rc, out, _ = _cli(main, ["record", "--history", str(tmp_path / "c1"),
                             "--seed-bench-rounds"], capsys)
    ref_rc, ref_out, _ = _cli(ref_main, ["record", "--history",
                                         str(tmp_path / "c2"),
                                         "--seed-bench-rounds"], capsys)
    doc, ref_doc = json.loads(out), json.loads(ref_out)
    assert rc == ref_rc == 0
    assert doc.pop("history") != ref_doc.pop("history")
    assert doc == ref_doc
    assert (tmp_path / "c1").read_text() == got.read_text()


def test_record_a_payload_equals_the_references(tmp_path, capsys):
    payload = tmp_path / "sweep.json"
    payload.write_text(json.dumps({**SWEEP_ID, "spread_pct": 0.2,
                                   "hashes_per_sec_per_chip": 9.7e8}))
    runs = []
    for fn, name in ((main, "p.jsonl"), (ref_main, "r.jsonl")):
        rc, out, _ = _cli(fn, ["record", "--history", str(tmp_path / name),
                               "--section", "sweep", "--payload",
                               str(payload)], capsys)
        doc = json.loads(out)
        doc.pop("history")
        runs.append((rc, doc, (tmp_path / name).read_text()))
    assert runs[0] == runs[1]
    assert runs[0][1]["key"] == "sweep/pallas/b28/m1"
    # A section whose metric the payload lacks, and an unreadable payload.
    for argv in (["--section", "chain", "--payload", str(payload)],
                 ["--section", "sweep", "--payload", str(tmp_path / "no")],
                 []):
        (rc, out, _), (ref_rc, ref_out, _) = _both(
            ["record", "--history", str(tmp_path / "x.jsonl"), *argv],
            capsys)
        assert rc == ref_rc == 2 and out == ref_out == ""
    assert not (tmp_path / "x.jsonl").exists()


def test_record_without_history_exits_2_and_writes_nothing(tmp_path,
                                                           capsys):
    payload = tmp_path / "sweep.json"
    payload.write_text(json.dumps(CARD_SWEEP))
    for argv in (["--seed-bench-rounds"],
                 ["--section", "sweep", "--payload", str(payload)]):
        rc, out, err = _cli(main, ["record", *argv], capsys)
        assert rc == 2 and out == ""
        assert "--history" in err and history.DEFAULT_HISTORY_NAME in err
    assert hashlib.sha256(REPO_HISTORY.read_bytes()).hexdigest() == \
        REPO_HISTORY_SHA
    assert list(tmp_path.iterdir()) == [payload]


def test_the_roofline_is_the_cards_bound(tmp_path, capsys):
    """``bound_utilization_pct`` = 100 x rate x bound_ms / 1e3 / nonces a
    call; the newest sweep with a bound gives it, one without (a CPU run,
    a seeded TPU record) never does."""
    path = tmp_path / "h.jsonl"
    store = history.HistoryStore(path)
    history.seed_from_bench_rounds(store, ROOT)
    rc, out, _ = _cli(main, ["report", "--history", str(path)], capsys)
    assert rc == 0 and "roofline" not in json.loads(out)
    store.record("sweep", CARD_SWEEP, source="card",
                 recorded_at="2026-10-17T00:00:00Z")
    store.record("sweep", {**CARD_SWEEP, "backend": "cuda",
                           "platform": "cpu", "kernel": "torch",
                           "batch_pow2": 16, "bound_ms": None,
                           "kernel_ms": None,
                           "hashes_per_sec_per_chip": 2e6},
                 source="cpu", recorded_at="2026-10-18T00:00:00Z")
    want = {"measured_mhs": 7648.0, "bound_ms": 30.443,
            "nonces_per_call": 1 << 28, "bound_mhs": 8817.6,
            "bound_utilization_pct": 86.74, "kernel_ms": 34.5,
            "kernel_bound_pct": 88.24}
    for argv in (["report"], ["check", "--json"]):
        rc, out, _ = _cli(main, [*argv, "--history", str(path)], capsys)
        assert rc == 0 and json.loads(out)["roofline"] == want
    rc, _, err = _cli(main, ["check", "--history", str(path)], capsys)
    assert rc == 0
    assert "perfwatch: newest card sweep 7648.0 MH/s = 86.74% of its " \
        "bound (30.443 ms a call of 268435456 nonces)" in err
    assert attribution.utilization(7.648e9, 30.443, 1 << 28) == {
        k: v for k, v in want.items()
        if k not in ("kernel_ms", "kernel_bound_pct")}
    assert attribution.payload_utilization({"batch_pow2": 31,
                                            "n_miners": 8,
                                            "bound_ms": 2.0,
                                            "hashes_per_sec_per_chip": 1e9}
                                           )["nonces_per_call"] == 1 << 32


def test_card_keys_never_meet_the_references_records(tmp_path):
    """The port's bench payloads at the card's cells carry ``backend``, so
    no history key holds both a seeded TPU record and a card one; without
    it the chain and the single-preset cells would share the TPU's key."""
    store = history.HistoryStore(tmp_path / "h.jsonl")
    history.seed_from_bench_rounds(store, ROOT)
    seeded = set(store.by_key())
    card = {
        "sweep": {"backend": "cuda", "kernel": "cuda", "batch_pow2": 28,
                  "n_miners": 1},
        "chain": {"backend": "cuda", "n_blocks": 1000,
                  "difficulty_bits": 24, "n_miners": 1},
        "sharded_pallas": {"backend": "cuda", "kernel": "cuda",
                           "mesh": "1-device ('miners',)", "n_blocks": 30,
                           "difficulty_bits": 16, "n_miners": 1},
        "tpu_single": {"backend": "cuda", "preset": "tpu-single",
                       "n_blocks": 10, "difficulty_bits": 20,
                       "batch_pow2": 20},
    }
    keys = {s: history.entry_key(s, p) for s, p in card.items()}
    assert not set(keys.values()) & seeded, keys
    assert {s for s, p in card.items()
            if history.entry_key(s, {k: v for k, v in p.items()
                                     if k != "backend"}) in seeded} == \
        {"chain", "tpu_single"}
    # entry_key itself is the reference's.
    for s, p in card.items():
        assert keys[s] == ref_history.entry_key(s, p)


def test_attribute_spans_equals_the_references_with_the_ports_names():
    names = {"backend.tpu.dispatch": "backend.cuda.dispatch",
             "backend.tpu.host_tail": "backend.cuda.host_tail"}
    spans = (("backend.tpu.dispatch", 5.0), ("backend.tpu.host_tail", 0.75),
             ("backend.cpu.search", 0.5), ("miner.append", 1.0),
             ("fused.dispatch", 2.0), ("bench.device_init", 0.5),
             ("miner.block", 0.25))
    for name, dur in spans:
        ref_telemetry.default_registry().record_span(
            RefSpan(name=name, duration_s=dur))
        telemetry.default_registry().record_span(
            Span(name=names.get(name, name), duration_s=dur))
    got = attribution.attribute_spans()
    want = ref_attribution.attribute_spans()
    for b in want["buckets"].values():
        b["spans"] = {names.get(k, k): v for k, v in b["spans"].items()}
    assert got == want and got["dominant"] == "device"
    assert set(attribution.SPAN_BUCKETS) == {
        names.get(k, k) for k in ref_attribution.SPAN_BUCKETS}
    empty = telemetry.Registry()
    assert attribution.attribute_spans(empty)["dominant"] is None


def test_memory_axis_equals_the_references():
    shards = [{"rank": 0, "memory": {"cuda:0": {"bytes_in_use": 10,
                                                "peak_bytes_in_use": 40}}},
              {"rank": 1, "memory": {"cuda:0": {"bytes_in_use": 30}}},
              {"rank": 2, "memory": None}]
    assert attribution.memory_axis(shards) == \
        ref_attribution.memory_axis(shards)
    assert attribution.memory_axis([])["device_count"] == 0


# ---- the mesh views over a two-rank CPU world -----------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory) -> pathlib.Path:
    """The shards of two ``mine --mesh-obs`` ranks over gloo on the CPU."""
    obs = tmp_path_factory.mktemp("world") / "mesh"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
            "--device", "cpu", "--difficulty", "11", "--blocks", "3",
            "--batch-pow2", "9", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--mesh-obs", str(obs)]
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT)}
    procs = [subprocess.Popen(base + ["--process-id", str(i)], env=env,
                              cwd=str(REPO_ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in (1, 0)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        reap(procs)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return obs


def _json_both(argv, capsys) -> tuple[int, dict, dict]:
    (rc, out, _), (ref_rc, ref_out, _) = _both(argv, capsys)
    assert rc == ref_rc
    got, want = json.loads(out), json.loads(ref_out)
    return rc, got, want


@pytest.mark.parametrize("argv", [
    ["critical-path", "--json"], ["critical-path", "--json", "--height", "2"],
    ["mesh-skew", "--json"], ["incidents", "--json"],
    ["compiles", "--json", "--no-probe"]],
    ids=["critical_path", "critical_path_height", "mesh_skew", "incidents",
         "compiles"])
def test_mesh_views_equal_the_references(world, argv, capsys):
    rc, got, want = _json_both([*argv, "--mesh-dir", str(world)], capsys)
    assert rc == 0
    assert got == want
    if argv[0] == "critical-path":
        heights = [2] if "--height" in argv else [1, 2, 3]
        assert got["heights"] == heights
        assert all(got["blocks"][str(h)]["complete"] for h in heights)
    elif argv[0] == "mesh-skew":
        assert got["sites"]["mesh.sweep"]["ranks"] == [0, 1]
    elif argv[0] == "incidents":
        assert got["count"] == 0
    else:
        assert got["mesh"] == {} and got["local"]["recompiles"] == 0


def test_mesh_view_text_and_trace_equal_the_references(world, tmp_path,
                                                       capsys):
    for argv in (["critical-path"], ["mesh-skew"], ["incidents"],
                 ["compiles", "--no-probe"]):
        (rc, out, _), (ref_rc, ref_out, _) = _both(
            [*argv, "--mesh-dir", str(world)], capsys)
        assert rc == ref_rc == 0 and out == ref_out and out
    # A height with no segments exits 1, as the reference's.
    (rc, _, err), (ref_rc, _, ref_err) = _both(
        ["critical-path", "--mesh-dir", str(world), "--height", "99"],
        capsys)
    assert rc == ref_rc == 1 and err == ref_err
    trace = tmp_path / "cp.json"
    rc, out, _ = _cli(main, ["critical-path", "--json", "--mesh-dir",
                             str(world), "--trace", str(trace)], capsys)
    doc = json.loads(out)
    events = json.loads(trace.read_text())["traceEvents"]
    assert rc == 0 and doc["trace"] == {"path": str(trace),
                                        "events": len(events)}
    assert any(e.get("ph") == "s" for e in events)      # the flow chain


def test_the_repo_history_was_never_written():
    """Runs last in this file: nothing above appended to the reference's
    ``PERF_HISTORY.jsonl``."""
    assert hashlib.sha256(REPO_HISTORY.read_bytes()).hexdigest() == \
        REPO_HISTORY_SHA
