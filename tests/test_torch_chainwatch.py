"""The port's chainwatch against the reference's, on the CPU.

Rules: each of the eight rules is fed the same sample stream in both
packages (the cases of the reference's tests of its rules) and must fire
or stay quiet at the same samples with the same details. Incidents: the
signal, the open table, bundles (``BUNDLE_KEYS``), the rate limit and the
cap, the implicated-height filter and the mesh membership follow the
reference. The watchdog: install, uninstall, the kill switch, the
throttle, a broken rule and ``notify_eviction``. End to end through
``mine --incident-dir`` on the CPU: a clean run raises no incident, and
two injected dispatch raises fire ``event_storm`` exactly once with a
complete bundle, the one-process form of the reference's chainwatch
smoke.
"""
import json
import pathlib
import time

import pytest
import torch

import mpi_blockchain_tpu.chainwatch as ref_chainwatch
import mpi_blockchain_tpu.chainwatch.incident as ref_incident
import mpi_blockchain_tpu.chainwatch.rules as ref_rules
import mpi_blockchain_tpu.dispatchwatch as ref_dispatchwatch
import mpi_blockchain_tpu.meshprof.memory as ref_memory
import mpi_blockchain_tpu.meshwatch.pipeline as ref_pipeline
import mpi_blockchain_tpu.service as ref_service
from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.telemetry import flight_recorder as ref_flight
from mpi_blockchain_tpu_torch import chainwatch, dispatchwatch, service
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.chainwatch import incident, rules
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.meshprof import memory
from mpi_blockchain_tpu_torch.meshwatch import pipeline
from mpi_blockchain_tpu_torch.telemetry import flight_recorder

torch.set_num_threads(1)

PORT = dict(chainwatch=chainwatch, incident=incident, rules=rules,
            telemetry=telemetry, memory=memory, pipeline=pipeline,
            dispatchwatch=dispatchwatch, service=service,
            flight=flight_recorder)
REF = dict(chainwatch=ref_chainwatch, incident=ref_incident, rules=ref_rules,
           telemetry=ref_telemetry, memory=ref_memory, pipeline=ref_pipeline,
           dispatchwatch=ref_dispatchwatch, service=ref_service,
           flight=ref_flight)


def _reset():
    for pkg in (PORT, REF):
        pkg["telemetry"].reset()
        pkg["telemetry"].clear_events()
        pkg["telemetry"].set_mesh_rank(0)
        pkg["telemetry"].set_telemetry_disabled(False)
        pkg["pipeline"].reset_profiler()
        pkg["chainwatch"].uninstall()
        pkg["flight"].uninstall()
        pkg["dispatchwatch"].clear_compiles()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _toggle(pkg):
    class Toggle(pkg["rules"].Rule):
        name = "toggle"
        severity = "warn"

        def __init__(self):
            super().__init__()
            self.breach = False
            self.samples = 0

        def sample(self, ctx):
            self.samples += 1
            return self.breach, {"n": self.samples}
    return Toggle()


# ---- the rules, one sample stream each -------------------------------------


def case_debounce_and_hysteresis(pkg, monkeypatch):
    r = _toggle(pkg)
    out = []
    for breach in (True, False, True, True, True, False, True, False,
                   False, True, True):
        r.breach = breach
        out.append(r.evaluate({}))
        out.append((r.open, r.fired_total))
    return out


def case_catalogue(pkg, monkeypatch):
    rs = pkg["rules"].default_rules()
    return [(r.name, r.severity, r.debounce_n, r.clear_n) for r in rs] + \
        [pkg["rules"].SEVERITIES, sorted(pkg["rules"].STORM_EVENTS),
         pkg["rules"].default_rules()[0] is not rs[0]]


def case_hashrate_collapse(pkg, monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_HASHRATE_WARMUP", "2")
    r = pkg["rules"].HashrateCollapse()
    c = pkg["telemetry"].counter("hashes_tried_total", backend="cpu")
    now, out = 100.0, []
    for inc in [100_000] * 8 + [10] * 15:
        c.inc(inc)
        now += 1.0
        out.append(r.evaluate({"now": now}))
    return out + [r.open, r.fired_total]


def case_hashrate_idle(pkg, monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_HASHRATE_WARMUP", "2")
    r = pkg["rules"].HashrateCollapse()
    c = pkg["telemetry"].counter("hashes_tried_total", backend="cpu")
    now, out = 0.0, []
    for inc in [50_000] * 6 + [0] * 10:
        if inc:
            c.inc(inc)
        now += 1.0
        out.append(r.evaluate({"now": now}))
    return out + [r.open, r.fired_total]


def case_collective_skew(pkg, monkeypatch):
    r = pkg["rules"].CollectiveSkewSpike()
    h = pkg["telemetry"].histogram("collective_skew_ms", site="mesh.sweep")
    out = []
    for _ in range(6):
        h.observe(5000.0)
        out.append(r.evaluate({}))
    return out


def case_hbm_growth(pkg, monkeypatch):
    marks = {"cuda:0": {"last_bytes_in_use": 200 * 1024 * 1024}}
    monkeypatch.setattr(pkg["memory"], "memory_snapshot", lambda: marks)
    r = pkg["rules"].HbmWatermarkGrowth()
    out = [r.evaluate({})]
    marks["cuda:0"]["last_bytes_in_use"] = 400 * 1024 * 1024
    out += [r.evaluate({}) for _ in range(4)]
    return out


def case_hbm_below_floor(pkg, monkeypatch):
    marks = {"cuda:0": {"last_bytes_in_use": 1024 * 1024}}
    monkeypatch.setattr(pkg["memory"], "memory_snapshot", lambda: marks)
    r = pkg["rules"].HbmWatermarkGrowth()
    out = [r.evaluate({})]
    marks["cuda:0"]["last_bytes_in_use"] = 10 * 1024 * 1024
    out += [r.evaluate({}) for _ in range(6)]
    return out + [r.open]


def case_stale_rank(pkg, monkeypatch):
    emit = pkg["telemetry"].emit_event
    emit({"event": "mesh_shrunk", "evicted": 9})      # before the anchor
    r = pkg["rules"].StaleRank()
    out = [r.evaluate({}), r.evaluate({})]
    emit({"event": "mesh_rank_failed", "rank": 2, "reason": "rc=2"})
    out += [r.evaluate({}), r.open, r.evaluate({}), r.evaluate({}), r.open]
    return out


def case_bubble_regression(pkg, monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_BUBBLE_WARMUP", "2")
    rep = {"bubble_fraction": 0.2}
    monkeypatch.setattr(pkg["pipeline"], "pipeline_report",
                        lambda records: rep)
    r = pkg["rules"].BubbleRegression()
    now, out = 0.0, []
    for bubble in [0.2] * 3 + [0.4] + [0.9] * 4:
        rep = {"bubble_fraction": bubble}
        now += 1.0
        out.append(r.evaluate({"now": now}))
    return out + [r._breach_streak, r.open]


def case_bubble_throttle(pkg, monkeypatch):
    calls = []
    monkeypatch.setattr(pkg["pipeline"], "pipeline_report",
                        lambda records: calls.append(1)
                        or {"bubble_fraction": 0.5})
    r = pkg["rules"].BubbleRegression()
    for now in [10.0] * 6 + [11.0]:
        r.evaluate({"now": now})
    return [len(calls)]


def case_event_storm(pkg, monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_STORM_N", "3")
    monkeypatch.setenv("MPIBT_CHAINWATCH_STORM_WINDOW", "10")
    emit = pkg["telemetry"].emit_event
    r = pkg["rules"].EventStorm()
    out = [r.evaluate({"now": 0.0})]
    emit({"event": "retry", "site": "dispatch"})
    emit({"event": "fault_injected", "site": "backend.cuda.dispatch"})
    out.append(r.evaluate({"now": 1.0}))
    emit({"event": "collective_timeout", "site": "winner_select"})
    out += [r.evaluate({"now": 2.0}), r.open, r.evaluate({"now": 20.0}),
            r.evaluate({"now": 21.0}), r.open]
    for name in ("checkpoint_saved", "block_mined", "mesh_shrunk"):
        emit({"event": name})
    out += [r.evaluate({"now": 22.0}), r._breach_streak]
    return out


def case_recompile_storm(pkg, monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_RECOMPILE_WARMUP", "1")
    r = pkg["rules"].RecompileStorm()
    census = {"fused": {"compiles": 1, "cache_entries": 1}}
    monkeypatch.setattr(pkg["dispatchwatch"], "compile_census",
                        lambda: census)
    out = []
    for n in (1, 1, 3, 5, 9, 9, 9, 11, 13):
        census["fused"]["compiles"] = n
        out.append(r.evaluate({}))
    return out + [r.fired_total]


def case_recompile_quiet(pkg, monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_RECOMPILE_WARMUP", "3")
    r = pkg["rules"].RecompileStorm()
    census = {}
    monkeypatch.setattr(pkg["dispatchwatch"], "compile_census",
                        lambda: dict(census))
    out = [r.evaluate({}) for _ in range(6)]
    for n in (1, 2, 3, 4, 4, 4, 4, 4):
        census = {"ops.sha256_cuda": {"compiles": n}}
        out.append(r.evaluate({}))
    return out + [r.fired_total, r.open]


def case_mempool_saturation(pkg, monkeypatch):
    stats = {}
    monkeypatch.setattr(pkg["service"], "service_stats", lambda: stats)
    r = pkg["rules"].MempoolSaturation()
    out = [r.evaluate({})]                  # no door: never fires
    for shed, depth in ((0, 2), (2, 3), (10, 3), (20, 3), (20, 10),
                        (20, 2), (20, 2), (20, 2), (20, 510), (20, 511)):
        stats = {"shed_total": {"full": shed}, "accept_gate": {"ok": 1},
                 "mempool": {"depth": depth, "cap": 512}}
        out.append(r.evaluate({}))
    return out + [r.open, r.fired_total]


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_fires_on_the_same_samples_as_the_references(name,
                                                          monkeypatch):
    got = CASES[name](PORT, monkeypatch)
    _reset()
    want = CASES[name](REF, monkeypatch)
    assert got == want
    assert any(o is not None for o in got)


def test_the_catalogue_is_the_references():
    names = [r.name for r in rules.default_rules()]
    assert names == ["hashrate_collapse", "collective_skew_spike",
                     "hbm_watermark_growth", "stale_rank",
                     "bubble_regression", "event_storm",
                     "recompile_storm", "mempool_saturation"]
    assert incident.BUNDLE_KEYS == ref_incident.BUNDLE_KEYS


# ---- incidents and the watchdog ---------------------------------------------


def _record(pkg, rule="r", heights=(), seq=1) -> dict:
    return {"rule": rule, "severity": "warn", "detail": {},
            "heights": heights, "incident_seq": seq,
            "opened_at": time.time()}


@pytest.mark.parametrize("pkg_name", ["port", "ref"])
def test_emit_incident_signals_on_every_surface(tmp_path, pkg_name):
    pkg = PORT if pkg_name == "port" else REF
    cw, tel = pkg["chainwatch"], pkg["telemetry"]
    cw.install(tmp_path / "inc")
    rec = cw.emit_incident(rule="event_storm", severity="warn",
                           detail={"events": 4}, heights=(7, 3),
                           source="test")
    assert rec["incident_seq"] == 1 and rec["heights"] == [3, 7]
    (m,) = tel.default_registry().snapshot()["incidents_total"]
    assert m["labels"] == {"rule": "event_storm", "severity": "warn"}
    assert m["value"] == 1
    (ev,) = tel.recent_events(event="incident")
    assert ev["rule"] == "event_storm" and ev["source"] == "test"
    (open_inc,) = cw.open_incidents()
    assert open_inc["rule"] == "event_storm"
    path = pathlib.Path(rec["bundle"])
    assert path.name == "incident_0001_event_storm.json"
    bundle = json.loads(path.read_text())
    assert set(bundle) == set(pkg["incident"].BUNDLE_KEYS)
    assert (bundle["artifact"], bundle["reason"], bundle["heights"]) == \
        ("incident", "incident:event_storm", [3, 7])
    cw.close_incident("event_storm")
    assert cw.open_incidents() == [] and path.exists()


def test_rate_limit_cap_and_open_table_match_the_reference(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_BUNDLE_CAP", "2")
    seen = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        d = tmp_path / name
        pkg["chainwatch"].install(d)
        fired = [pkg["chainwatch"].emit_incident(rule=rule, severity=sev)
                 for rule, sev in (("a", "warn"), ("a", "warn"),
                                   ("b", "critical"), ("c", "warn"))]
        seen[name] = ([("bundle" in f, f["incident_seq"]) for f in fired],
                      sorted(p.name for p in d.glob("incident_*.json")),
                      sorted(i["rule"]
                             for i in pkg["chainwatch"].open_incidents()),
                      pkg["incident"].incident_count())
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == [(True, 1), (False, 2), (True, 3), (False, 4)]


def test_incidents_without_directory_still_signal():
    chainwatch.install()
    rec = chainwatch.emit_incident(rule="x", severity="warn")
    assert "bundle" not in rec and chainwatch.open_incidents()
    assert "incidents_total" in telemetry.default_registry().snapshot()
    assert chainwatch.bundle_dir() is None


def test_bundle_filters_records_and_carries_the_mesh_as_the_reference():
    seen = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        pkg["chainwatch"].install()
        p = pkg["pipeline"].profiler()
        for h in (1, 2, 3):
            p.dispatch(kind="sweep", height=h, backend="cpu")
        build = pkg["incident"].build_bundle
        hit = build(_record(pkg, heights=(2,)))
        miss = build(_record(pkg, heights=(99,)))
        pkg["chainwatch"].notify_mesh({"live": [0, 1, 3], "evicted": [2],
                                       "reason": "stale"})
        mesh = build(_record(pkg, rule="stale_rank"))["mesh"]
        seen[name] = ([r["meta"]["height"] for r in hit["blocktrace"]],
                      len(miss["blocktrace"]), mesh, set(hit),
                      hit["compiles"], hit["service"])
    assert seen["port"] == seen["ref"]
    assert seen["port"][:3] == ([2], 3, {"live": [0, 1, 3],
                                         "evicted": [2],
                                         "reason": "stale"})


def test_bundle_default_mesh_and_memory_need_no_card(monkeypatch):
    from mpi_blockchain_tpu_torch.meshprof import clear_spans

    monkeypatch.delenv("MPIBT_MESH_WORLD", raising=False)
    clear_spans()
    memory.clear_memory()
    chainwatch.install()
    telemetry.set_mesh_rank(2)
    bundle = incident.build_bundle(_record(PORT))
    assert bundle["mesh"] == {"rank": 2, "world_size": 1}
    assert bundle["memory"] == {} and bundle["skew_spans"] == []


def test_evaluate_fires_and_holds_the_episode(tmp_path, monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_STORM_N", "2")
    chainwatch.install(tmp_path)
    assert chainwatch.evaluate(force=True) == []      # the anchor sweep
    for _ in range(2):
        telemetry.emit_event({"event": "retry", "site": "dispatch"})
    fired = chainwatch.evaluate(height=5, source="block", force=True)
    assert [f["rule"] for f in fired] == ["event_storm"]
    assert fired[0]["heights"] == [5] and fired[0]["source"] == "block"
    assert chainwatch.evaluate(force=True) == []
    assert [i["rule"] for i in chainwatch.open_incidents()] == \
        ["event_storm"]


def test_disarmed_and_telemetry_off_are_flag_checks(tmp_path):
    assert chainwatch.evaluate(force=True) == []
    assert not chainwatch.installed()
    chainwatch.install(tmp_path)
    probe = _toggle(PORT)
    probe.breach = True
    chainwatch._rules.append(probe)
    telemetry.set_telemetry_disabled(True)
    for _ in range(5):
        assert chainwatch.evaluate(force=True) == []
    assert probe.samples == 0
    assert chainwatch.notify_eviction(2, "stale") is None
    assert chainwatch.open_incidents() == []
    telemetry.set_telemetry_disabled(False)
    chainwatch.evaluate(force=True)
    assert probe.samples == 1


def test_throttle_bounds_the_sweep_rate(monkeypatch):
    monkeypatch.setenv("MPIBT_CHAINWATCH_INTERVAL", "3600")
    chainwatch.install()
    probe = _toggle(PORT)
    chainwatch._rules.append(probe)
    chainwatch.evaluate()
    first = probe.samples
    for _ in range(10):
        chainwatch.evaluate()
    assert probe.samples == first
    chainwatch.evaluate(force=True)
    assert probe.samples == first + 1


def test_a_broken_rule_never_hurts_the_run(tmp_path):
    chainwatch.install(tmp_path)

    class Broken(rules.Rule):
        name = "broken"

        def sample(self, ctx):
            raise RuntimeError("detector bug")

    chainwatch._rules.insert(0, Broken())
    assert chainwatch.evaluate(force=True) == []


def test_notify_eviction_fires_stale_rank_once(tmp_path):
    chainwatch.install(tmp_path)
    rec = chainwatch.notify_eviction(2, "stale", height=7, live=[0, 1, 3])
    assert (rec["rule"], rec["severity"]) == ("stale_rank", "critical")
    assert rec["detail"]["rank"] == 2 and rec["heights"] == [7]
    assert chainwatch.notify_eviction(3, "stale", height=8) is None
    bundle = json.loads(pathlib.Path(rec["bundle"]).read_text())
    assert bundle["mesh"]["live"] == [0, 1, 3]
    assert bundle["mesh"]["evicted"] == [2]


def test_install_uninstall_lifecycle(tmp_path):
    chainwatch.install(tmp_path)
    chainwatch.emit_incident(rule="x", severity="warn")
    assert chainwatch.installed() and chainwatch.open_incidents()
    chainwatch.uninstall()
    assert not chainwatch.installed()
    assert chainwatch.open_incidents() == []
    assert incident.incident_count() == 0
    chainwatch.install()
    assert chainwatch.emit_incident(rule="y", severity="warn")[
        "incident_seq"] == 1


def test_the_front_doors_stale_rank_stamp_reads_the_table(tmp_path):
    """An open ``stale_rank`` incident, as the eviction seam opens it, is
    what the door's degradation stamp reads."""
    chainwatch.install(tmp_path)
    chainwatch.notify_eviction(1, "stale", live=[0])
    assert [i["rule"] for i in incident.open_incidents()] == ["stale_rank"]


# ---- end to end: mine --incident-dir on the CPU -----------------------------


def _mine(argv, capsys) -> tuple[int, dict]:
    rc = main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1])


CLEAN_ENV = {"MPIBT_CHAINWATCH_INTERVAL": "0",
             "MPIBT_CHAINWATCH_STORM_N": "3",
             "MPIBT_CHAINWATCH_STORM_WINDOW": "60"}


@pytest.mark.parametrize("pipeline_on", ["1", "0"],
                         ids=["pipelined", "sequential"])
@pytest.mark.parametrize("backend", [
    ["--device", "cpu", "--batch-pow2", "12"], ["--backend", "cpu"]],
    ids=["plain_sweep", "cpp_sweep"])
def test_a_clean_mine_raises_no_incident(tmp_path, capsys, monkeypatch,
                                         pipeline_on, backend):
    for k, v in CLEAN_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("MPIBT_PIPELINE", pipeline_on)
    d = tmp_path / "inc"
    rc, summary = _mine(["mine", "--difficulty", "12", "--blocks", "8",
                         "--incident-dir", str(d), *backend], capsys)
    assert rc == 0 and summary["height"] == 8
    assert list(d.glob("incident_*.json")) == []
    assert telemetry.recent_events(event="incident") == []
    assert telemetry.default_registry().total("incidents_total") == 0
    assert not chainwatch.installed()          # disarmed on the way out


@pytest.mark.parametrize("site, argv", [
    ("backend.cuda.dispatch", ["--device", "cpu", "--batch-pow2", "12"]),
    ("backend.cpu.search", ["--backend", "cpu"])])
def test_injected_raises_fire_one_event_storm(tmp_path, capsys,
                                              monkeypatch, site, argv):
    for k, v in CLEAN_ENV.items():
        monkeypatch.setenv(k, v)
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"version": 1, "strict": True, "faults": [
        {"site": site, "kind": "raise", "call": 2, "times": 2}]}))
    d = tmp_path / "inc"
    rc, summary = _mine(["mine", "--difficulty", "12", "--blocks", "8",
                         "--incident-dir", str(d), "--fault-plan",
                         str(plan), *argv], capsys)
    assert rc == 0 and summary["height"] == 8
    assert "degraded" not in summary
    (ev,) = telemetry.recent_events(event="incident")
    assert ev["rule"] == "event_storm" and ev["detail"]["events"] >= 3
    assert [b.name for b in d.glob("incident_*.json")] == \
        ["incident_0001_event_storm.json"]
    bundle = json.loads((d / "incident_0001_event_storm.json").read_text())
    assert set(bundle) == set(incident.BUNDLE_KEYS)
    assert any(e.get("event") == "fault_injected" for e in bundle["events"])
    assert telemetry.default_registry().total("incidents_total") == 1


def test_the_incident_dir_env_arms_only_the_subcommands_with_the_flag(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MPIBT_INCIDENT_DIR", str(tmp_path / "inc"))
    armed = []
    monkeypatch.setattr(chainwatch, "install",
                        lambda d=None: armed.append(d) or [])
    rc, _ = _mine(["mine", "--backend", "cpu", "--difficulty", "8",
                   "--blocks", "2"], capsys)
    assert rc == 0 and armed == [str(tmp_path / "inc")]
    chain = tmp_path / "c.bin"
    main(["mine", "--backend", "cpu", "--difficulty", "8", "--blocks", "2",
          "--out", str(chain)])
    armed.clear()
    main(["verify", "--chain", str(chain), "--difficulty", "8"])
    assert armed == []
