"""The port's perfwatch (history store, detector, live endpoint) against
the reference's, on the CPU.

The history store and the detector run the reference's cases on both
packages and must give the same keys and findings (``Finding.to_dict``
and ``render``), on synthetic series and on the repo's own
``PERF_HISTORY.jsonl``. The endpoint's ``/healthz``, ``/metrics`` and
``/events`` answer the reference's cases with the same codes, keys and
records (the event cursor's values are each process's own). Then
``--serve-metrics`` and ``MPIBT_METRICS_PORT`` on the port's CLI: a live
scrape of a running mine and sim, and every exit path releasing the port.
Exact.
"""
import json
import pathlib
import re
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.perfwatch import detector as ref_detector
from mpi_blockchain_tpu.perfwatch import history as ref_history
from mpi_blockchain_tpu.perfwatch import server as ref_server
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.perfwatch import detector, history, server

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SWEEP_ID = {"kernel": "pallas", "batch_pow2": 28, "n_miners": 1}

REF = types.SimpleNamespace(telemetry=ref_telemetry, detector=ref_detector,
                            history=ref_history, server=ref_server)
PORT = types.SimpleNamespace(telemetry=telemetry, detector=detector,
                             history=history, server=server)


@pytest.fixture(autouse=True)
def fresh_registry():
    for pkg in (REF, PORT):
        pkg.telemetry.reset()
        pkg.telemetry.clear_events()
    yield
    for pkg in (REF, PORT):
        pkg.telemetry.reset()
        pkg.telemetry.clear_events()


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _get_any(url, timeout=10):
    """(status, body), error statuses included."""
    try:
        return _get(url, timeout)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---- history store and detector ----------------------------------------


def _findings(pkg, path, entries):
    store = pkg.history.HistoryStore(path)
    for section, metric, value, spread, at in entries:
        store.record(section, {**SWEEP_ID, metric: value,
                               "spread_pct": spread}, source="t",
                     recorded_at=at)
    found = pkg.detector.check_history(store)
    return [(f.to_dict(), f.render()) for f in found], \
        [f.verdict for f in pkg.detector.regressions(found)]


@pytest.mark.parametrize("series", [
    [("sweep", "hashes_per_sec_per_chip", v, 0.5, None)
     for v in (970e6, 969e6, 776e6)],                     # -20%: pages
    [("sweep", "hashes_per_sec_per_chip", v, 0.5, None)
     for v in (970e6, 965e6)],                            # noise
    [("sweep", "hashes_per_sec_per_chip", v, 9.0, None)
     for v in (970e6, 820e6)],                            # spread widens
    [("sweep", "hashes_per_sec_per_chip", v, 0.5, None)
     for v in (970e6, 820e6)],                            # tight: pages
    [("chain", "wall_s", v, 0.5, None) for v in (18.6, 23.0)],
    [("chain", "wall_s", v, 0.5, None) for v in (23.0, 18.6)],
    [("sweep", "hashes_per_sec_per_chip", 970e6, 0.5,
      "2026-08-01T00:00:00Z"),
     ("sweep", "hashes_per_sec_per_chip", 600e6, 0.5,
      "2026-07-01T00:00:00Z")],                           # backfill
    [("sweep", "hashes_per_sec_per_chip", 970e6, 0.5, None)],
    [("cpu_np8", "hashes_per_sec", v, 0.5, None) for v in (2e6, 1e6)],
    [("serve", "p99_latency_ms", v, 0.0, None) for v in (9.0, 2500.0)],
], ids=["drop", "noise", "spread", "tight", "lower", "improved",
        "by_recorded_at", "single", "section_floor", "serve_bound"])
def test_detector_findings_equal_the_references(tmp_path, monkeypatch,
                                               series):
    # One clock for both packages: an entry recorded without its own
    # recorded_at is stamped with the wall clock, and a findings'
    # baseline_at carries it, so a second boundary between the two runs
    # would make them differ.
    for pkg_history in (history, ref_history):
        monkeypatch.setattr(pkg_history, "_utc_now",
                            lambda: "2026-09-01T00:00:00Z")
    got = _findings(PORT, tmp_path / "p.jsonl", series)
    assert got == _findings(REF, tmp_path / "r.jsonl", series)
    assert got[0]


def test_history_record_and_key_identity(tmp_path):
    for pkg in (REF, PORT):
        store = pkg.history.HistoryStore(tmp_path / f"{id(pkg)}.jsonl")
        e = store.record("sweep", {**SWEEP_ID,
                                   "hashes_per_sec_per_chip": 9e8,
                                   "spread_pct": 0.5}, source="t")
        assert e.key == "sweep/pallas/b28/m1"
        assert store.record("nope", {"x": 1}) is None
        assert store.record("sweep", {"kernel": "pallas"}) is None
        with store.path.open("a") as f:
            f.write("{not json\n")
        assert len(store.entries()) == 1
    assert history.SECTION_METRICS == ref_history.SECTION_METRICS
    for payload in ({**SWEEP_ID, "kernel": "jnp"},
                    {"backend": "cuda", "difficulty_bits": 24,
                     "n_blocks": 1000},
                    {"preset": "tpu-mesh8", "mesh": "m", "batch_pow2": 20}):
        for section in ("sweep", "serve", "chain"):
            assert history.entry_key(section, payload) == \
                ref_history.entry_key(section, payload)


def test_detector_candidate_is_not_recorded_and_checks_sections(tmp_path):
    for pkg in (REF, PORT):
        store = pkg.history.HistoryStore(tmp_path / f"{id(pkg)}.jsonl")
        store.record("sweep", {**SWEEP_ID, "hashes_per_sec_per_chip": 970e6,
                               "spread_pct": 0.5})
        f = pkg.detector.check_candidate(
            store, "sweep", {**SWEEP_ID, "hashes_per_sec_per_chip": 700e6,
                             "spread_pct": 0.5})
        assert f.verdict == "regression" and len(store.entries()) == 1
        with pytest.raises(ValueError, match="not regression-checked"):
            pkg.detector.check_candidate(store, "utilization",
                                         {"vpu_utilization_pct": 90})
        with pytest.raises(ValueError, match="lacks"):
            pkg.detector.check_candidate(store, "serve", {"x": 1})


def test_committed_history_gives_the_references_findings():
    port = detector.check_history(
        history.HistoryStore(ROOT / history.DEFAULT_HISTORY_NAME))
    ref = ref_detector.check_history(
        ref_history.HistoryStore(ROOT / ref_history.DEFAULT_HISTORY_NAME))
    assert [f.to_dict() for f in port] == [f.to_dict() for f in ref]
    assert [f.render() for f in port] == [f.render() for f in ref]
    assert any(f.section == "serve" for f in port)


# ---- the live endpoint ---------------------------------------------------


def test_port_zero_binds_ephemeral_and_registers():
    a, b = server.MetricsServer(port=0), server.MetricsServer(port=0)
    try:
        pa, pb = a.start(), b.start()
        assert pa != 0 and pb != 0 and pa != pb
        assert server.active_server() is b          # newest last
    finally:
        b.close()
        assert server.active_server() is a
        a.close()
        assert server.active_server() is None


def test_metrics_renders_on_demand_and_unknown_path_404():
    srv = server.MetricsServer(port=0, stall_s=60.0)
    srv.start()
    try:
        telemetry.counter("pw_probe_total", help="probe").inc(3)
        status, body = _get(srv.url("/metrics"))
        assert status == 200 and "# TYPE pw_probe_total counter" in body
        assert "pw_probe_total 3" in body
        telemetry.counter("pw_probe_total").inc()
        assert "pw_probe_total 4" in _get(srv.url("/metrics"))[1]
        code, body = _get_any(srv.url("/nope"))
        assert code == 404 and "/healthz" in body
    finally:
        srv.close()
    srv.close()                                      # idempotent
    with pytest.raises(urllib.error.URLError):
        _get(srv.url("/metrics"), timeout=1)


def _healthz_walk(pkg):
    """/healthz through starting, ok, stalled and back to ok, plus a never
    set gauge: (codes, statuses, key sets, heartbeat entries)."""
    srv = pkg.server.MetricsServer(port=0, stall_s=0.3)
    out = []
    try:
        srv.start()
        pkg.telemetry.gauge("idle_heartbeat")        # registered, never set
        for step in ("starting", "ok", "stalled", "again"):
            if step == "ok":
                pkg.telemetry.heartbeat("miner_heartbeat").set(7)
            elif step == "stalled":
                time.sleep(0.4)
            elif step == "again":
                pkg.telemetry.heartbeat("miner_heartbeat").set(8)
            code, body = _get_any(srv.url("/healthz"))
            h = json.loads(body)
            out.append((code, h["status"], h["healthy"], sorted(h),
                        {k: {"value": v["value"],
                             "age_s": None if v["age_s"] is None else "set"}
                         for k, v in h["heartbeats"].items()},
                        h["service"]))
    finally:
        srv.close()
    return out


def test_healthz_walk_equals_the_references():
    got = _healthz_walk(PORT)
    assert got == _healthz_walk(REF)
    assert [g[:2] for g in got] == [(200, "starting"), (200, "ok"),
                                    (503, "stalled"), (200, "ok")]
    assert got[0][4]["idle_heartbeat"]["age_s"] is None


def test_healthz_no_progress_after_startup_budget():
    for pkg in (REF, PORT):
        srv = pkg.server.MetricsServer(port=0, stall_s=0.2)
        try:
            srv.start()
            time.sleep(0.3)
            code, body = _get_any(srv.url("/healthz"))
            assert (code, json.loads(body)["status"]) == (503, "no-progress")
        finally:
            srv.close()


def _events_walk(pkg):
    """The reference's /events cases: redaction and the tail bound, then
    the since-cursor (relative seqs)."""
    srv = pkg.server.MetricsServer(port=0, stall_s=60.0)
    srv.start()
    out = []
    try:
        for i in range(5):
            pkg.telemetry.emit_event({"event": "pw_test", "n": i,
                                      "dump_path": f"/secret/{i}",
                                      "blob": "x" * 500})
        recs = [json.loads(ln) for ln in
                _get(srv.url("/events?n=3"))[1].splitlines()]
        base = recs[0]["seq"] - 2
        out.append([{**r, "seq": r["seq"] - base} for r in recs])
        for q in ("?since={c}", "?since={c}&n=2", "?since={t}",
                  "?since=junk&n=junk"):
            body = _get(srv.url("/events" + q.format(
                c=base + 2, t=base + 4)))[1]
            out.append([json.loads(ln)["n"] for ln in body.splitlines()])
    finally:
        srv.close()
    return out


def test_events_tail_and_cursor_equal_the_references():
    got = _events_walk(PORT)
    assert got == _events_walk(REF)
    assert [r["n"] for r in got[0]] == [2, 3, 4]
    assert got[0][0]["dump_path"] == "[redacted]"
    assert got[0][0]["blob"].endswith("...[truncated]")
    assert got[1:] == [[3, 4], [3, 4], [], [0, 1, 2, 3, 4]]
    assert telemetry.events.latest_seq() >= 5


def test_redact_event_equals_the_references():
    for rec in ({"event": "e", "argv": ["a"], "cwd": "/x", "height": 3},
                {"event": "e", "note": "y" * 300, "file_name": "f",
                 "ENV": 1, "n": None}):
        assert server.redact_event(rec) == ref_server.redact_event(rec)


# ---- the CLI: --serve-metrics and MPIBT_METRICS_PORT ---------------------


def test_mine_serve_metrics_live_scrape_then_released():
    """A running ``mine --serve-metrics 0`` answers /healthz 200 off a
    fresh ``miner_heartbeat`` and /metrics with the miner's counters; the
    port is released when the run returns."""
    result: dict = {}

    def run():
        result["rc"] = main(["mine", "--backend", "cpu", "--difficulty",
                             "17", "--blocks", "12", "--serve-metrics",
                             "0"])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    srv, health = None, None
    deadline = time.monotonic() + 60
    while t.is_alive() and time.monotonic() < deadline:
        srv = srv or server.active_server()
        if srv is not None:
            try:
                code, body = _get(srv.url("/healthz"))
                h = json.loads(body)
                beat = h["heartbeats"].get("miner_heartbeat")
                if beat and beat["age_s"] is not None:
                    health = (code, h["status"], beat)
                    metrics = _get(srv.url("/metrics"))[1]
                    break
            except urllib.error.URLError:
                break
        time.sleep(0.005)
    t.join(timeout=120)
    assert not t.is_alive() and result["rc"] == 0
    assert health is not None and health[:2] == (200, "ok")
    assert health[2]["age_s"] < 30
    assert "mining_rounds_total" in metrics or "miner_heartbeat" in metrics
    assert server.active_server() is None
    with pytest.raises(urllib.error.URLError):
        _get(srv.url("/metrics"), timeout=1)


def test_sim_serve_metrics_announces_and_releases():
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch", "sim",
         "--backend", "cpu", "--serve-metrics", "0", "--blocks", "4",
         "--partition-steps", "10"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    m = re.search(r"serving metrics on http://127\.0\.0\.1:(\d+)", err)
    assert m and proc.returncode == 0
    assert json.loads(out.splitlines()[-1])["converged"] is True
    with pytest.raises(urllib.error.URLError):
        _get(f"http://127.0.0.1:{m.group(1)}/metrics", timeout=1)


def test_env_var_enables_the_server_and_it_is_closed(monkeypatch, capsys):
    monkeypatch.setenv("MPIBT_METRICS_PORT", "0")
    assert main(["mine", "--difficulty", "8", "--blocks", "1",
                 "--backend", "cpu"]) == 0
    assert "serving metrics on http://127.0.0.1:" in capsys.readouterr().err
    assert server.active_server() is None


@pytest.mark.parametrize("port", ["taken", "70000"])
def test_a_bad_metrics_port_does_not_kill_the_run(capsys, port):
    blocker = server.MetricsServer(port=0)
    taken = blocker.start()
    try:
        assert main(["mine", "--difficulty", "8", "--blocks", "1",
                     "--backend", "cpu", "--serve-metrics",
                     str(taken) if port == "taken" else port]) == 0
        assert "serve-metrics failed" in capsys.readouterr().err
    finally:
        blocker.close()


def test_env_var_ignored_by_commands_without_a_run(monkeypatch, capsys,
                                                   tmp_path):
    monkeypatch.setenv("MPIBT_METRICS_PORT", "0")
    main(["verify", "--chain", str(tmp_path / "nope.bin"),
          "--difficulty", "8"])
    main(["info"])
    assert "serving metrics on" not in capsys.readouterr().err
    assert server.active_server() is None


def test_the_server_closes_when_the_run_fails(capsys):
    """A run that fails (rc 2: no card) still releases the port."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert main(["mine", "--difficulty", "8", "--blocks", "1",
                 "--serve-metrics", "0"]) == 2
    assert "serving metrics on" in capsys.readouterr().err
    assert server.active_server() is None
