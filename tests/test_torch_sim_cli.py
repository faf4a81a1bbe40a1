"""``sim`` through the port's CLI against the reference's, on the CPU: the
same ``sim_done`` line and causal dump, the reference's refusals, a clean
``ConfigError`` with no card unless the CPU is asked for, a run that does
not converge (rc 1, ``--flight-recorder`` and ``--events-dump``), a
``KernelError`` that keeps its own exit code, the flight recorder's hooks,
the bench watchdog's dump, and the resilience smoke's determinism phase."""
import contextlib
import hashlib
import io
import json
import sys
import time

import pytest

from mpi_blockchain_tpu import cli as ref_cli
from mpi_blockchain_tpu.resilience import injection as ref_injection
from mpi_blockchain_tpu.telemetry import flight_recorder as ref_recorder
from mpi_blockchain_tpu_torch import cli, telemetry
from mpi_blockchain_tpu_torch.config import KernelError
from mpi_blockchain_tpu_torch.resilience import injection
from mpi_blockchain_tpu_torch.telemetry import flight_recorder


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("MPIBT_FLIGHT_RECORDER", raising=False)
    monkeypatch.delenv("MPIBT_FAULT_PLAN", raising=False)
    telemetry.reset()
    yield
    for mod in (flight_recorder, ref_recorder):
        mod.uninstall()
    injection.disarm()
    ref_injection.disarm()


def _run(main, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else {})


SIM_ARGS = ["sim", "--blocks", "4", "--partition-steps", "10",
            "--drop-rate", "10", "--seed", "3"]


@pytest.mark.parametrize("port_args", [["--backend", "cpu"],
                                       ["--device", "cpu"]],
                         ids=["cpp_sweep", "plain_torch_sweep"])
def test_sim_done_line_and_dump_equal_the_references(tmp_path, port_args):
    rc, got = _run(cli.main, SIM_ARGS + port_args + [
        "--events-dump", str(tmp_path / "p.json")])
    ref_rc, want = _run(ref_cli.main, SIM_ARGS + [
        "--events-dump", str(tmp_path / "r.json")])
    assert rc == ref_rc == 0
    assert got == want and got["converged"] and got["stats_conserved"]
    assert not got["degraded"]
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()


def test_scenario_preset_through_both_clis(tmp_path):
    args = ["sim", "--preset", "adversarial-smoke", "--events-dump"]
    rc, got = _run(cli.main, args + [str(tmp_path / "p.json")])
    ref_rc, want = _run(ref_cli.main, args + [str(tmp_path / "r.json")])
    assert rc == ref_rc == 0
    timing = ("wall_s", "steps_per_sec")
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in want.items() if k not in timing}
    assert all(got[k] > 0 for k in timing)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()


def test_explicit_seed_zero_overrides_the_presets_seed(tmp_path):
    dump = tmp_path / "a.json"
    assert _run(cli.main, ["sim", "--preset", "adversarial-smoke", "--seed",
                           "0", "--events-dump", str(dump)])[0] == 0
    assert json.loads(dump.read_text())["meta"]["scenario"]["seed"] == 0


@pytest.mark.parametrize("argv,says", [
    (["sim", "--preset", "adversarial-smoke", "--nodes", "8"],
     "cannot resize"),
    (["sim", "--strategy", "flood:node=1", "--blocks", "3"],
     "vectorized engine"),
    (["sim", "--steps", "10", "--churn", "2"], "vectorized engine"),
    (["sim", "--preset", "cpu-single", "--nodes", "8"],
     "legacy mining preset"),
    (["sim", "--nodes", "8", "--strategy", "ddos:node=1"], "ddos"),
    (["sim", "--nodes", "8", "--latency", "3-1"], "latency"),
    (["sim", "--backend", "cpu", "--retarget", "a:b"], "retarget"),
    (["sim", "--backend", "cpu", "--groups", "1"], "n_groups"),
], ids=["nodes_resize_preset", "vec_flag_on_the_bus", "vec_flags_on_the_bus",
        "mining_preset_with_nodes", "bad_strategy", "bad_latency",
        "bad_retarget", "one_group"])
def test_refusals_are_the_references(argv, says):
    rc, got = _run(cli.main, argv)
    ref_rc, want = _run(ref_cli.main, argv)
    assert rc == ref_rc == 2
    assert got == want and got["event"] == "error" and says in got["error"]


@pytest.mark.parametrize("argv", [["sim", "--blocks", "2"],
                                  ["sim", "--preset", "adversarial"],
                                  ["sim", "--kernel", "cuda", "--blocks",
                                   "2"]])
def test_no_card_is_a_config_error_unless_asked_for_the_cpu(monkeypatch,
                                                            argv):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, got = _run(cli.main, argv)
    assert rc == 2 and got["event"] == "error"
    assert "no CUDA device" in got["error"]


NEVER_CONVERGES = ["sim", "--backend", "cpu", "--blocks", "2",
                   "--drop-rate", "100", "--nonce-budget-pow2", "0"]


@pytest.mark.parametrize("armed_by", ["flag", "env"])
def test_non_convergence_exits_1_and_dumps(tmp_path, monkeypatch,
                                           armed_by):
    """Every delivery dropped: the groups never share a chain, the run
    ends at its step cap with rc 1, the flight recorder's dump holds the
    causal logs, and the events dump is the reference's, byte for byte."""
    fr = tmp_path / "fr.json"
    if armed_by == "flag":
        arm = ["--flight-recorder", str(fr)]
    else:
        arm = []
        monkeypatch.setenv("MPIBT_FLIGHT_RECORDER", str(fr))
    rc, got = _run(cli.main, NEVER_CONVERGES + arm + [
        "--events-dump", str(tmp_path / "p.json")])
    ref_rc, want = _run(ref_cli.main, NEVER_CONVERGES + [
        "--events-dump", str(tmp_path / "r.json")])
    assert rc == ref_rc == 1
    assert got == want == {"converged": False, "event": "sim_done",
                           "error": "no convergence in 10000 steps"}
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    meta = json.loads((tmp_path / "p.json").read_text())["meta"]
    assert meta["converged"] is False and meta["steps"] == 10_000
    dump = json.loads(fr.read_text())
    assert dump["artifact"] == "flight_recorder"
    assert dump["reason"].startswith("sim non-convergence")
    assert dump["context"] == {"command": "sim"}
    assert set(dump["causal"]) == {"0", "1", "bus"}
    assert all(dump["causal"][k] for k in ("0", "1", "bus"))
    assert dump["metrics"]


@pytest.mark.parametrize("where", ["kernel", "bus"])
def test_only_non_convergence_is_reported_as_such(tmp_path, monkeypatch,
                                                  where):
    """A KernelError in a group's search exits 2 as a kernel failure (it
    is never retried); any other error out of the run keeps its traceback.
    Neither is a ``sim_done`` line or a non-convergence dump."""
    from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
    from mpi_blockchain_tpu_torch.simulation import Network

    error = (KernelError("sha256d_sweep launch: an illegal address")
             if where == "kernel" else RuntimeError("an infrastructure fault"))

    def broken(*args, **kwargs):
        raise error
    monkeypatch.setattr(CpuBackend if where == "kernel" else Network,
                        "search" if where == "kernel" else "step", broken)
    fr = tmp_path / "fr.json"
    argv = ["sim", "--backend", "cpu", "--blocks", "2", "--flight-recorder",
            str(fr)]
    if where == "kernel":
        rc, got = _run(cli.main, argv)
        assert rc == 2 and got == {"event": "error", "kind": "kernel",
                                   "error": str(error)}
    else:
        with pytest.raises(RuntimeError, match="infrastructure") as e:
            _run(cli.main, argv)
        assert not hasattr(e.value, "network")
    assert not fr.exists()


def test_recorder_hooks_chain_and_uninstall(tmp_path, monkeypatch):
    """The excepthook dumps and chains to the previous hook; a later dump
    overwrites an earlier one and keeps its reason; uninstall restores the
    hook; the artifact has the reference's keys."""
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    path = tmp_path / "fr.json"
    assert flight_recorder.install(path) == path
    assert flight_recorder.installed()
    try:
        raise ValueError("boom")
    except ValueError:
        sys.excepthook(*sys.exc_info())
    assert seen == [ValueError]
    dump = json.loads(path.read_text())
    assert dump["reason"] == "uncaught ValueError: boom"
    assert "Traceback" in dump["traceback"]
    ref_keys = set(ref_recorder.snapshot("r")) | {"prior_reasons"}
    assert set(dump) == ref_keys
    assert flight_recorder.dump_now("declared") == path
    dump = json.loads(path.read_text())
    assert dump["reason"] == "declared"
    assert dump["prior_reasons"] == ["uncaught ValueError: boom"]
    flight_recorder.install(path)      # re-arm: a fresh dump count
    flight_recorder.dump_now("again")
    assert json.loads(path.read_text())["prior_reasons"] == []
    flight_recorder.uninstall()
    assert not flight_recorder.installed()
    sys.excepthook(ValueError, ValueError("x"), None)
    assert seen == [ValueError, ValueError]
    assert flight_recorder.dump_now("after uninstall") is None


def test_bench_init_watchdog_dumps_the_flight_recorder(tmp_path):
    """A device-init phase that outlasts its budget writes the flight
    recorder's artifact while the process is still alive, as the
    reference's does."""
    from mpi_blockchain_tpu_torch.bench_lib import _device_init_phase
    path = tmp_path / "fr.json"
    flight_recorder.install(path)
    with _device_init_phase("probe", timeout_s=0.05):
        deadline = time.monotonic() + 10
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
    dump = json.loads(path.read_text())
    assert dump["reason"].startswith(
        "bench.device_init hang: phase 'probe' still running after")
    hangs = [e for e in dump["events"]
             if e.get("event") == "bench.device_init"
             and e.get("status") == "hang"]
    assert hangs and hangs[-1]["phase"] == "probe"


def test_resilience_smoke_determinism_equals_the_references(tmp_path):
    from mpi_blockchain_tpu.resilience.__main__ import \
        smoke_determinism as ref_determinism
    from mpi_blockchain_tpu_torch.resilience.__main__ import \
        smoke_determinism
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    got = smoke_determinism(tmp_path / "p", device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        ref_determinism(tmp_path / "r")
    want = hashlib.sha256((tmp_path / "r" / "dump0.json").read_bytes())
    assert got["sha256"] == want.hexdigest()
    assert got["faults"] == 3 and got["summary"]["converged"]


def test_resilience_smoke_runs_its_determinism_phase_first(monkeypatch,
                                                           capsys):
    """``resilience smoke`` runs the reference's three phases in its order;
    the two that the resilience tests drive are stubbed here."""
    from mpi_blockchain_tpu_torch.resilience import __main__ as smoke
    monkeypatch.setattr(smoke, "smoke_kill_resume",
                        lambda tmp, device: {"device": device})
    monkeypatch.setattr(smoke, "smoke_degradation", lambda tmp, device: {
        "degraded": {"rung": "cpu", "tip_hash": device}})
    assert smoke.main(["smoke", "--device", "cpu"]) == 0
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("smoke:")]
    assert [ln.split(" ok")[0] for ln in said] == [
        "smoke: determinism", "smoke: kill+resume", "smoke: step-down"]
    assert "3 faults" in said[0] and "byte-identical" in said[0]


def test_resilience_smoke_runs_on_the_card_unless_asked(monkeypatch):
    """``resilience smoke`` with no ``--device`` puts every phase on the
    card, as ``mine`` and ``sim`` do; ``--device cpu`` asks for the CPU."""
    from mpi_blockchain_tpu_torch.resilience import __main__ as smoke
    seen = []

    def phase(tmp, device):
        seen.append(device)
        return {"faults": 3, "dump_bytes": 0, "sha256": "",
                "degraded": {"rung": "cpu", "tip_hash": ""}}

    for name in ("smoke_determinism", "smoke_kill_resume",
                 "smoke_degradation"):
        monkeypatch.setattr(smoke, name, phase)
    with contextlib.redirect_stdout(io.StringIO()):
        assert smoke.main(["smoke"]) == 0
        assert smoke.main(["smoke", "--device", "cpu"]) == 0
    assert seen == ["cuda"] * 3 + ["cpu"] * 3
