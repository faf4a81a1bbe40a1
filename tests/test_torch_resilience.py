"""The port's resilience layer against the reference's, on the CPU: fault
plans, injection, the retry policy, the step-down ladder,
``search_async`` and the CLI's exit codes. Exact: a seed
derives the reference's plan (up to the one renamed site), the backoff
schedule and the step-down record are the reference's, and a degraded
chain equals the reference oracle's byte for byte. ``KernelError``, which
the reference does not have, is never retried and never stepped over, and
a hand-written kernel's rung steps down only for an injected fault.
"""
import dataclasses
import json
import warnings

import pytest
import torch

from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu.resilience import faultplan as ref_faultplan
from mpi_blockchain_tpu.resilience import injection as ref_injection
from mpi_blockchain_tpu.resilience import policy as ref_policy
from mpi_blockchain_tpu_torch import core, telemetry
from mpi_blockchain_tpu_torch.backend import MinerBackend, SearchResult, \
    backend_from_config, get_backend
from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import ConfigError, KernelError, \
    MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.resilience import (FaultInjected,
                                                 FaultPlanError,
                                                 FaultTimeout,
                                                 RetryExhausted, injection)
from mpi_blockchain_tpu_torch.resilience.dispatch import (ResilientBackend,
                                                          ladder_from_config)
from mpi_blockchain_tpu_torch.resilience.faultplan import SITES, FaultPlan
from mpi_blockchain_tpu_torch.resilience.policy import (RetryPolicy,
                                                        call_with_retry,
                                                        policy_for)

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

RENAME = {"backend.tpu.dispatch": "backend.cuda.dispatch"}


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with no plan armed in either package,
    and with a fresh metrics registry."""
    injection.disarm()
    ref_injection.disarm()
    telemetry.reset()
    telemetry.clear_events()
    yield
    injection.disarm()
    ref_injection.disarm()


def _plan(*faults, **kw):
    return FaultPlan.from_dict({"version": 1, "faults": list(faults), **kw})


def _ported(d: dict) -> dict:
    """A reference plan dict with its sites renamed as the port names
    them."""
    return {**d, "faults": [{**f, "site": RENAME.get(f["site"], f["site"])}
                            for f in d["faults"]]}


def _fast_policy():
    return RetryPolicy(max_attempts=2, base_backoff_s=0.0, max_backoff_s=0.0)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---- fault plans ------------------------------------------------------------


def test_sites_are_the_references_with_one_rename():
    assert len(SITES) == len(ref_faultplan.SITES)
    assert SITES == tuple(RENAME.get(s, s) for s in ref_faultplan.SITES)
    assert ref_faultplan.KINDS == ("raise", "hang", "corrupt", "partial")


@pytest.mark.parametrize("seed", range(64))
def test_from_seed_equals_the_reference(seed):
    ref = ref_faultplan.FaultPlan.from_seed(seed).to_dict()
    assert FaultPlan.from_seed(seed).to_dict() == _ported(ref)
    assert FaultPlan.parse_arg(f"seed:{seed}") == FaultPlan.from_seed(seed)


@pytest.mark.parametrize("n_faults,strict", [(1, False), (5, True)])
def test_from_seed_with_options_equals_the_reference(n_faults, strict):
    ref_sites = ("backend.tpu.dispatch", "backend.cpu.search",
                 "checkpoint.write")
    for seed in (-3, 0, 17, 2 ** 31 - 1):
        ref = ref_faultplan.FaultPlan.from_seed(
            seed, n_faults=n_faults, sites=ref_sites, strict=strict)
        got = FaultPlan.from_seed(
            seed, n_faults=n_faults,
            sites=tuple(RENAME.get(s, s) for s in ref_sites), strict=strict)
        assert got.to_dict() == _ported(ref.to_dict())


def test_faultplan_json_roundtrip(tmp_path):
    plan = _plan({"site": "backend.cuda.dispatch", "kind": "corrupt",
                  "call": 2, "times": 3}, seed=9, strict=True)
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(plan.to_dict()))
    assert FaultPlan.load(p) == plan
    assert FaultPlan.from_dict(json.loads(json.dumps(plan.to_dict()))) \
        == plan


@pytest.mark.parametrize("bad", [
    {"faults": [{"site": "nope", "kind": "raise"}]},
    {"faults": [{"site": "backend.tpu.dispatch", "kind": "raise"}]},
    {"faults": [{"site": "sim.deliver", "kind": "explode"}]},
    {"faults": [{"site": "sim.deliver", "kind": "raise", "call": -1}]},
    {"faults": [{"site": "sim.deliver", "kind": "raise", "times": 0}]},
    {"faults": [{"site": "sim.deliver", "kind": "raise", "times": -2}]},
    {"faults": [{"site": "sim.deliver", "kind": "hang",
                 "seconds": float("nan")}]},
    {"faults": [{"site": "sim.deliver", "kind": "raise", "bogus": 1}]},
    {"faults": ["not-an-object"]},
    {"version": 99},
    {"faults": "not-a-list"},
    ["not", "an", "object"],
])
def test_faultplan_invalid_specs_raise(bad):
    with pytest.raises(FaultPlanError):
        FaultPlan.from_dict(bad)
    assert issubclass(FaultPlanError, ConfigError)


def test_faultplan_parse_arg(tmp_path):
    with pytest.raises(FaultPlanError):
        FaultPlan.parse_arg("seed:xyz")
    with pytest.raises(FaultPlanError):
        FaultPlan.parse_arg(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(FaultPlanError):
        FaultPlan.parse_arg(str(bad))


# ---- injection --------------------------------------------------------------


def test_injection_fires_at_call_index_as_the_reference_does():
    spec = {"site": "backend.cpu.search", "kind": "raise", "call": 2,
            "times": 2}
    injection.arm(_plan(spec))
    ref_injection.arm(ref_faultplan.FaultPlan.from_dict(
        {"version": 1, "faults": [spec]}))
    for _ in range(5):
        fired = []
        for check in (injection.check, ref_injection.check):
            try:
                check("backend.cpu.search")
                fired.append(False)
            except RuntimeError:
                fired.append(True)
        assert fired[0] == fired[1]
    assert injection.check("sim.deliver") is None
    assert injection.call_counts() == {"backend.cpu.search": 5,
                                       "sim.deliver": 1}
    assert telemetry.counter("faults_injected_total",
                             site="backend.cpu.search", kind="raise"
                             ).value == 2
    fired = telemetry.recent_events(event="fault_injected")[-2:]
    assert [e["call"] for e in fired] == [2, 3]


def test_injection_strict_unfired_raises():
    injection.arm(_plan({"site": "sim.deliver", "kind": "raise",
                         "call": 100}, strict=True))
    with pytest.raises(FaultPlanError, match="not exhausted"):
        injection.disarm(strict=True)
    assert not injection.active()
    # A non-strict disarm (the CLI's error path) never raises.
    injection.arm(_plan({"site": "sim.deliver", "kind": "raise",
                         "call": 100}, strict=True))
    injection.disarm()


def test_injection_corrupt_and_partial_return_to_the_hook():
    injection.arm(_plan({"site": "checkpoint.write", "kind": "corrupt"},
                        {"site": "checkpoint.read", "kind": "partial"}))
    assert injection.check("checkpoint.write").kind == "corrupt"
    assert injection.check("checkpoint.read").kind == "partial"
    assert injection.check("checkpoint.write") is None


def test_strict_plan_shadowed_spec_still_counts_as_fired():
    injection.arm(_plan(
        {"site": "backend.cpu.search", "kind": "raise", "times": -1},
        {"site": "backend.cpu.search", "kind": "corrupt", "call": 2},
        strict=True))
    for _ in range(3):
        with pytest.raises(FaultInjected):
            injection.check("backend.cpu.search")
    injection.disarm(strict=True)   # must not raise


def test_hang_fault_sleeps_then_raises_fault_timeout():
    import time

    injection.arm(_plan({"site": "backend.cpu.search", "kind": "hang",
                         "seconds": 0.02}))
    t0 = time.perf_counter()
    with pytest.raises(FaultTimeout):
        injection.check("backend.cpu.search")
    assert time.perf_counter() - t0 >= 0.02


def test_native_load_fault_fires():
    from mpi_blockchain_tpu_torch.core import build

    injection.arm(_plan({"site": "native.load", "kind": "raise"}))
    with pytest.raises(FaultInjected):
        build.ensure_built()
    injection.disarm()
    assert build.ensure_built().exists()   # the real library still loads


# ---- retry policy -----------------------------------------------------------

_POLICY_SITES = ("dispatch", "dispatch.cpu", "distributed.init",
                 "checkpoint.write", "checkpoint.read", "mesh.rebuild",
                 "service.submit", "service.rebuild", "other.site")


@pytest.mark.parametrize("cap", [None, "1", "2", "oops"])
def test_policy_for_equals_the_reference(monkeypatch, cap):
    if cap is not None:
        monkeypatch.setenv("MPIBT_MAX_RETRIES", cap)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # "oops" warns
        for site in _POLICY_SITES:
            for seed in (0, 1, 7):
                assert dataclasses.astuple(policy_for(site, seed=seed)) \
                    == dataclasses.astuple(
                        ref_policy.policy_for(site, seed=seed))


def test_backoff_schedule_equals_the_reference():
    for site in ("dispatch.cuda:cuda", "dispatch.tpu:pallas", "dispatch.cpu",
                 "checkpoint.write"):
        for seed in range(4):
            for base, top in ((0.01, 0.25), (0.02, 0.1), (0.001, 0.05)):
                ours = RetryPolicy(5, base, top, seed)
                ref = ref_policy.RetryPolicy(5, base, top, seed)
                assert [ours.backoff_s(site, a) for a in range(6)] == \
                    [ref.backoff_s(site, a) for a in range(6)]
    p = RetryPolicy(max_attempts=5, base_backoff_s=0.01, max_backoff_s=0.05,
                    seed=3)
    assert all(0 < p.backoff_s("dispatch.cpu", a) < 0.05 for a in range(5))


@pytest.mark.parametrize("attempts", [1, 2, 3, 4])
def test_call_with_retry_attempts_equal_the_reference(attempts):
    for failures in range(6):
        outcome = []
        for retry, policy_cls, exhausted in (
                (call_with_retry, RetryPolicy, RetryExhausted),
                (ref_policy.call_with_retry, ref_policy.RetryPolicy,
                 ref_policy.RetryExhausted)):
            calls, sleeps = [0], []

            def flaky():
                calls[0] += 1
                if calls[0] <= failures:
                    raise OSError("transient")
                return "ok"

            try:
                got = retry(flaky, site="dispatch.test",
                            policy=policy_cls(attempts, 0.01, 0.25, 5),
                            sleep=sleeps.append)
            except exhausted as e:
                got = ("exhausted", e.attempts, type(e.last).__name__)
            outcome.append((got, calls[0], sleeps))
        assert outcome[0] == outcome[1]


@pytest.mark.parametrize("error", [ConfigError, KernelError])
def test_call_with_retry_never_retries_config_or_kernel_errors(error):
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise error("no nvcc")

    with pytest.raises(error, match="no nvcc"):
        call_with_retry(broken, site="dispatch.test",
                        policy=RetryPolicy(max_attempts=5),
                        sleep=lambda s: None)
    assert calls["n"] == 1
    assert telemetry.default_registry().total("retries_total") == 0


# ---- the step-down ladder ---------------------------------------------------


def test_ladder_rungs_follow_the_config():
    labels = [label for label, _ in ladder_from_config(
        MinerConfig(backend="cpu"))]
    assert labels == ["cpu"]
    labels = [label for label, _ in ladder_from_config(
        MinerConfig(device="cpu"))]
    assert labels == ["cuda:torch", "cpu"]     # auto on the CPU is torch
    with pytest.raises(ConfigError, match="kernel='cuda'"):
        ladder_from_config(MinerConfig(device="cpu", kernel="cuda"))


def test_ladder_without_a_card_is_a_config_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        ladder_from_config(MinerConfig())


def test_ladder_steps_down_to_cpu_as_the_reference_does():
    """A plan that kills every CUDA dispatch: the port's ladder steps
    down cuda:torch -> cpu, its record equals the reference's tpu:jnp ->
    cpu record up to the rung label and the site, and its chain equals the
    reference's cpu oracle byte for byte."""
    kill = {"kind": "raise", "times": -1}
    injection.arm(_plan({"site": "backend.cuda.dispatch", **kill}))
    cfg = MinerConfig(difficulty_bits=8, n_blocks=2, device="cpu",
                      batch_pow2=11)
    backend = ResilientBackend(ladder_from_config(cfg),
                               policy=_fast_policy())
    miner = Miner(cfg, backend=backend)
    miner.mine_chain()
    assert backend.degraded and backend.rung == "cpu"
    assert backend.name == "cpu"

    from mpi_blockchain_tpu.resilience.dispatch import \
        ResilientBackend as RefResilient
    from mpi_blockchain_tpu.resilience.dispatch import \
        ladder_from_config as ref_ladder
    ref_injection.arm(ref_faultplan.FaultPlan.from_dict(
        {"version": 1, "faults": [{"site": "backend.tpu.dispatch",
                                   **kill}]}))
    ref_cfg = RefConfig(difficulty_bits=8, n_blocks=2, backend="tpu",
                        kernel="jnp", batch_pow2=11)
    ref_backend = RefResilient(ref_ladder(ref_cfg),
                               policy=ref_policy.RetryPolicy(
                                   max_attempts=2, base_backoff_s=0.0,
                                   max_backoff_s=0.0))
    ref_miner = RefMiner(ref_cfg, backend=ref_backend)
    ref_miner.mine_chain()
    ref_injection.disarm()

    def as_reference(record: dict) -> dict:
        text = json.dumps(record, sort_keys=True)
        text = text.replace("cuda:torch", "tpu:jnp").replace(
            "backend.cuda.dispatch", "backend.tpu.dispatch")
        return json.loads(text)

    assert [as_reference(d) for d in backend.degradations] == \
        ref_backend.degradations
    assert len(backend.degradations) == 1
    oracle = RefMiner(RefConfig(difficulty_bits=8, n_blocks=2,
                                backend="cpu"))
    oracle.mine_chain()
    assert miner.node.save() == oracle.node.save()
    assert ref_miner.node.save() == oracle.node.save()
    assert telemetry.counter("backend_degradations_total").value == 1
    assert telemetry.gauge("backend_degraded").value == 1
    assert telemetry.recent_events(event="backend_degraded")[-1]["to"] \
        == "cpu"


class LyingBackend(MinerBackend):
    name = "liar"

    def search(self, header80, difficulty_bits, start_nonce=0,
               max_count=1 << 32):
        return SearchResult(start_nonce, b"\x00" * 32, 1)


def test_ladder_validates_corrupt_results():
    cfg = MinerConfig(difficulty_bits=8, n_blocks=1, backend="cpu")
    ladder = [("liar", LyingBackend),
              ("cpu", lambda: get_backend("cpu", n_ranks=1))]
    backend = ResilientBackend(ladder, policy=_fast_policy())
    miner = Miner(cfg, backend=backend)
    rec = miner.mine_block()
    # The fabricated winner was rejected by host-side re-validation and
    # the ladder stepped down to the honest rung.
    assert backend.degraded and backend.rung == "cpu"
    assert core.leading_zero_bits(bytes.fromhex(rec.hash)) >= 8
    assert telemetry.counter("corrupt_results_total",
                             backend="liar").value == 2


def test_corrupt_fault_is_retried_on_the_same_rung():
    injection.arm(_plan({"site": "backend.cuda.dispatch", "kind": "corrupt",
                         "call": 0}))
    cfg = MinerConfig(difficulty_bits=8, n_blocks=3, device="cpu",
                      batch_pow2=11)
    miner = Miner(cfg)
    miner.mine_chain()
    assert miner.backend.rung == "cuda:torch"
    assert not miner.backend.degraded
    assert telemetry.default_registry().total("retries_total") == 1
    oracle = RefMiner(RefConfig(difficulty_bits=8, n_blocks=3,
                                backend="cpu"))
    oracle.mine_chain()
    assert miner.node.save() == oracle.node.save()


def test_partial_fault_hides_a_winner_and_the_chain_holds():
    """A suppressed winner is a lost result, not a poisoned one: the
    driver moves on to the next extra-nonce space, as a real miss would.
    The reference does the same; both chains match."""
    spec = {"kind": "partial", "call": 1}
    injection.arm(_plan({"site": "backend.cpu.search", **spec}))
    cfg = MinerConfig(difficulty_bits=6, n_blocks=2, backend="cpu")
    miner = Miner(cfg, pipeline=False)
    miner.mine_chain()
    ref_injection.arm(ref_faultplan.FaultPlan.from_dict(
        {"version": 1, "faults": [{"site": "backend.cpu.search", **spec}]}))
    ref = RefMiner(RefConfig(difficulty_bits=6, n_blocks=2, backend="cpu"),
                   pipeline=False)
    ref.mine_chain()
    assert miner.node.save() == ref.node.save()


def test_ladder_exhausted_raises_retry_exhausted():
    cfg = MinerConfig(difficulty_bits=8, n_blocks=1, backend="cpu")
    injection.arm(_plan({"site": "backend.cpu.search", "kind": "raise",
                         "times": -1}))
    backend = ResilientBackend(ladder_from_config(cfg),
                               policy=_fast_policy())
    with pytest.raises(RetryExhausted) as e:
        backend.search(core.Node(8, 0).make_candidate(b"x"), 8)
    assert e.value.site == "dispatch.cpu" and e.value.attempts == 2


class KernelFails(MinerBackend):
    name = "kernel"
    calls = 0

    def search(self, *a, **k):
        KernelFails.calls += 1
        raise KernelError("sha256d_sweep launch failed: CUDA error 700")


def test_kernel_error_propagates_with_no_retry_and_no_step_down():
    KernelFails.calls = 0
    backend = ResilientBackend([("cuda:cuda", KernelFails),
                                ("cpu", CpuBackend)], policy=_fast_policy())
    with pytest.raises(KernelError, match="CUDA error 700"):
        backend.search(core.Node(8, 0).make_candidate(b"x"), 8)
    assert KernelFails.calls == 1
    assert not backend.degraded and backend.degradations == []
    assert backend.rung == "cuda:cuda"
    with pytest.raises(KernelError):
        backend.search_async(core.Node(8, 0).make_candidate(b"x"),
                             8).result(timeout=30)
    assert KernelFails.calls == 2 and not backend.degraded
    reg = telemetry.default_registry()
    assert reg.total("retries_total") == 0
    assert reg.total("backend_degradations_total") == 0


def test_kernel_error_while_building_a_rung_propagates():
    def no_nvcc():
        raise KernelError("nvcc not found")

    with pytest.raises(KernelError, match="nvcc"):
        ResilientBackend([("cuda:cuda", no_nvcc), ("cpu", CpuBackend)])
    # A lower rung that fails to build its kernel is not skipped either.
    injection.arm(_plan({"site": "backend.cpu.search", "kind": "raise",
                         "times": -1}))
    backend = ResilientBackend([("cpu", CpuBackend), ("cuda:cuda", no_nvcc),
                                ("cpu2", CpuBackend)], policy=_fast_policy())
    with pytest.raises(KernelError, match="nvcc"):
        backend.search(core.Node(8, 0).make_candidate(b"x"), 8)
    assert backend.degradations == []


def test_ladder_config_error_propagates_without_degrading():
    class Misconfigured(MinerBackend):
        name = "boom"

        def search(self, *a, **k):
            raise ConfigError("explicit kernel unavailable")

    backend = ResilientBackend(
        [("boom", Misconfigured), ("boom2", Misconfigured)],
        policy=_fast_policy())
    with pytest.raises(ConfigError, match="explicit kernel"):
        backend.search(b"\x00" * 80, 8)
    assert not backend.degraded


ILLEGAL_ADDRESS = ("CUDA error: an illegal memory access was encountered\n"
                   "CUDA kernel errors might be asynchronously reported at "
                   "some other API call")


class _FaultedBuffer:
    """Stands in for a result buffer whose read-back reports a kernel that
    faulted while it ran, as PyTorch raises it."""

    def __init__(self, message: str = ILLEGAL_ADDRESS):
        self.message = message

    def __getitem__(self, index):
        return self

    def tolist(self):
        raise RuntimeError(self.message)


def test_read_back_cuda_error_is_a_kernel_error():
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    with pytest.raises(KernelError, match="read-back failed: CUDA error"):
        sha256_cuda.read_result(_FaultedBuffer())
    # Any other error passes through as it was.
    with pytest.raises(RuntimeError, match="^device busy$") as e:
        sha256_cuda.read_result(_FaultedBuffer("device busy"))
    assert not isinstance(e.value, KernelError)


class KernelRung(CpuBackend):
    """A rung that says it runs a hand-written kernel; ``finish`` is what
    its launch leaves to the read-back."""
    name = "kernel"
    hand_written_kernel = True
    calls = 0

    def finish(self, header80, difficulty_bits, start_nonce, max_count):
        return CpuBackend.search(self, header80, difficulty_bits,
                                 start_nonce, max_count)

    def search(self, header80, difficulty_bits, start_nonce=0,
               max_count=1 << 32):
        KernelRung.calls += 1
        return self.finish(header80, difficulty_bits, start_nonce, max_count)


def test_kernel_fault_at_the_read_back_is_never_retried_or_stepped_over():
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    class Faults(KernelRung):
        def finish(self, *args):
            return SearchResult(*sha256_cuda.read_result(_FaultedBuffer()),
                                0)

    KernelRung.calls = 0
    backend = ResilientBackend([("cuda:cuda", Faults), ("cpu", CpuBackend)],
                               policy=_fast_policy())
    cand = core.Node(8, 0).make_candidate(b"x")
    with pytest.raises(KernelError, match="illegal memory access"):
        backend.search(cand, 8)
    with pytest.raises(KernelError, match="illegal memory access"):
        backend.search_async(cand, 8).result(timeout=30)
    assert KernelRung.calls == 2
    assert backend.rung == "cuda:cuda" and backend.degradations == []
    reg = telemetry.default_registry()
    assert reg.total("retries_total") == 0
    assert reg.total("backend_degradations_total") == 0


@pytest.mark.parametrize("failure", ["lying_winner", "cuda_error"])
def test_kernel_failure_with_no_fault_behind_it_does_not_step_down(failure):
    """A hand-written kernel's rung that keeps failing with no injected
    fault behind it (a winner that fails re-validation, a CUDA error that
    reached the ladder unconverted) retries, then raises KernelError: the
    run never moves to the plain version or the CPU."""
    class Fails(KernelRung):
        def finish(self, header80, difficulty_bits, start_nonce, max_count):
            if failure == "cuda_error":
                raise RuntimeError(ILLEGAL_ADDRESS)
            return SearchResult(start_nonce, b"\x00" * 32, 1)

    KernelRung.calls = 0
    backend = ResilientBackend([("cuda:cuda", Fails), ("cpu", CpuBackend)],
                               policy=_fast_policy())
    with pytest.raises(KernelError, match="cuda:cuda") as e:
        backend.search(core.Node(8, 0).make_candidate(b"x"), 8)
    assert isinstance(e.value.__cause__, RetryExhausted)
    assert KernelRung.calls == 2
    assert backend.rung == "cuda:cuda" and backend.degradations == []
    assert telemetry.default_registry().total(
        "backend_degradations_total") == 0


@pytest.mark.parametrize("kind", ["raise", "corrupt"])
def test_injected_fault_steps_a_kernel_rung_down(kind):
    """What a plan injects on a hand-written kernel's rung steps down as
    in the reference, and the chain is the CPU oracle's."""
    from mpi_blockchain_tpu_torch.backend import _faulted_result

    class Injected(KernelRung):
        def finish(self, header80, difficulty_bits, start_nonce, max_count):
            fault = injection.check("backend.cuda.dispatch")
            res = CpuBackend.search(self, header80, difficulty_bits,
                                    start_nonce, max_count)
            return res if fault is None else \
                _faulted_result(fault, res, start_nonce)

    injection.arm(_plan({"site": "backend.cuda.dispatch", "kind": kind,
                         "times": -1}))
    backend = ResilientBackend([("cuda:cuda", Injected),
                                ("cpu", CpuBackend)], policy=_fast_policy())
    cfg = MinerConfig(difficulty_bits=8, n_blocks=2, backend="cpu")
    miner = Miner(cfg, backend=backend)
    miner.mine_chain()
    assert backend.rung == "cpu" and len(backend.degradations) == 1
    assert backend.degradations[0]["from"] == "cuda:cuda"
    oracle = Miner(cfg, pipeline=False)
    oracle.mine_chain()
    assert miner.node.save() == oracle.node.save()


# ---- search_async ------------------------------------------------------------


def test_search_async_resolves_to_search_in_fifo_order():
    be = backend_from_config(MinerConfig(difficulty_bits=8, device="cpu",
                                         batch_pow2=11))
    cand = core.Node(8, 0).make_candidate(b"x")
    done = []
    futs = [be.search_async(cand, 8, start_nonce=i * 4096, max_count=4096)
            for i in range(6)]
    for i, f in enumerate(futs):
        f.add_done_callback(lambda _, i=i: done.append(i))
    results = [f.result(timeout=60) for f in futs]
    assert done == list(range(6))
    direct = [be.search(cand, 8, start_nonce=i * 4096, max_count=4096)
              for i in range(6)]
    assert results == direct
    assert all(isinstance(r, SearchResult) for r in results)


def test_search_async_launches_now_and_finishes_in_issue_order():
    """A two-phase rung starts each search when search_async is called
    (the sweep is on the device when it returns); the future is finished,
    re-validated and retried when its result is asked for, in issue
    order: asking for the last finishes the earlier ones first."""
    events = []

    class TwoPhase(CpuBackend):
        name = "two-phase"

        def launch(self, *args, **kwargs):
            events.append(("launch", args[2]))
            res = CpuBackend.search(self, *args, **kwargs)

            def finish():
                events.append(("finish", args[2]))
                return res
            return finish

    injection.arm(_plan({"site": "backend.cpu.search", "kind": "corrupt",
                         "call": 1}))
    be = ResilientBackend([("two-phase", TwoPhase)], policy=_fast_policy())
    cand = core.Node(8, 0).make_candidate(b"x")
    futs = [be.search_async(cand, 8, start_nonce=i << 12, max_count=1 << 12)
            for i in range(3)]
    assert events == [("launch", i << 12) for i in range(3)]
    assert not any(f.done() for f in futs)
    last = futs[2].result(timeout=60)
    assert [e for e in events if e[0] == "finish"] == \
        [("finish", i << 12) for i in range(3)]
    assert all(f.done() for f in futs)
    # The corrupt result of the second launch was caught by re-validation
    # and searched again in full (a retry is a plain search).
    assert telemetry.default_registry().total("retries_total") == 1
    got = [f.result() for f in futs[:2]] + [last]
    assert got == [CpuBackend().search(cand, 8, i << 12, 1 << 12)
                   for i in range(3)]
    # A cancelled dispatch is dropped unread.
    spare = be.search_async(cand, 8, start_nonce=0, max_count=1 << 12)
    assert spare.cancel()
    after = be.search_async(cand, 8, start_nonce=1 << 12, max_count=1 << 12)
    assert after.result(timeout=60) == got[1] and spare.cancelled()


def test_async_dispatch_steps_down_single_flight():
    """A speculative dispatch whose rung dies retries and steps down when
    its result is asked for, without poisoning any other dispatch: the
    ladder steps down exactly once and the chain equals the reference
    oracle's."""
    calls = {"dead": 0}

    class DeadBackend(CpuBackend):
        name = "dead"

        def search(self, *a, **kw):
            calls["dead"] += 1
            raise RuntimeError("rung is dead")

    ladder = ResilientBackend([("dead", DeadBackend), ("cpu", CpuBackend)],
                              policy=_fast_policy())
    cfg = MinerConfig(difficulty_bits=10, n_blocks=3, backend="cpu")
    m = Miner(cfg, backend=ladder, pipeline=True)
    m.mine_chain()
    oracle = RefMiner(RefConfig(difficulty_bits=10, n_blocks=3,
                                backend="cpu"), pipeline=False)
    oracle.mine_chain()
    assert m.node.save() == oracle.node.save()
    assert ladder.degraded and ladder.rung == "cpu"
    assert len(ladder.degradations) == 1
    # The dead rung was exhausted exactly once (one dispatch's retry
    # budget), not once per speculative dispatch.
    assert calls["dead"] == 2


@pytest.mark.parametrize("form", ["shipped", "raw", "worker",
                                  "finish_on_worker", "poll_20us",
                                  "poll_yield", "unbounded"])
def test_dispatch_variants_forms_mine_the_oracles_chain(form):
    """Every form of search_async that ``tools/dispatch_variants`` times
    mines the sequential oracle's chain; the worker forms search on the
    worker thread."""
    import concurrent.futures
    import threading

    from mpi_blockchain_tpu_torch.tools import dispatch_variants

    assert form in dispatch_variants.FORMS
    cfg = MinerConfig(difficulty_bits=9, n_blocks=4, backend="cpu")
    threads = set()

    class Recorded(CpuBackend):
        def search(self, *args, **kwargs):
            threads.add(threading.get_ident())
            return CpuBackend.search(self, *args, **kwargs)

    with concurrent.futures.ThreadPoolExecutor(1) as worker:
        backend = dispatch_variants.make_backend(form, cfg, worker)
        rung = getattr(backend, "active_backend", backend)
        rung.__class__ = Recorded
        miner = Miner(cfg, backend=backend, pipeline=True)
        miner.mine_chain()
    oracle = Miner(cfg, pipeline=False)
    oracle.mine_chain()
    assert miner.node.save() == oracle.node.save()
    on_worker = form in ("worker", "finish_on_worker")
    assert threads and (threading.get_ident() not in threads) == on_worker
    with pytest.raises(ValueError, match="unknown form"):
        dispatch_variants.make_backend("nope", cfg, worker)


def test_backend_from_config_wraps_by_default():
    wrapped = backend_from_config(MinerConfig(difficulty_bits=8,
                                              backend="cpu"))
    assert isinstance(wrapped, ResilientBackend)
    assert isinstance(wrapped.active_backend, CpuBackend)
    assert wrapped.name == "cpu" and not wrapped.degraded
    raw = backend_from_config(MinerConfig(difficulty_bits=8, backend="cpu"),
                              resilient=False)
    assert isinstance(raw, CpuBackend)
    assert isinstance(Miner(MinerConfig(backend="cpu")).backend,
                      ResilientBackend)


# ---- the CLI ----------------------------------------------------------------


def _write_plan(tmp_path, *faults, **kw) -> str:
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"version": 1, "faults": list(faults), **kw}))
    return str(p)


def test_cli_fault_plan_invalid_rc3(tmp_path, capsys):
    rc = main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
               "cpu", "--fault-plan", str(tmp_path / "missing.json")])
    out = _last_json(capsys)
    assert rc == 3 and out["kind"] == "fault_plan"


def test_cli_strict_plan_unexhausted_rc3(tmp_path, capsys):
    plan = _write_plan(tmp_path, {"site": "sim.deliver", "kind": "raise",
                                  "call": 10 ** 6}, strict=True)
    rc = main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
               "cpu", "--fault-plan", plan])
    out = _last_json(capsys)
    assert rc == 3 and "not exhausted" in out["error"]


def test_cli_plan_from_the_environment(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MPIBT_FAULT_PLAN", _write_plan(
        tmp_path, {"site": "backend.cpu.search", "kind": "raise"},
        strict=True))
    assert main(["mine", "--difficulty", "8", "--blocks", "2", "--backend",
                 "cpu"]) == 0
    assert _last_json(capsys)["height"] == 2
    assert telemetry.default_registry().total("retries_total") == 1


def test_cli_retries_exhausted_rc2(tmp_path, capsys):
    plan = _write_plan(tmp_path, {"site": "backend.cpu.search",
                                  "kind": "raise", "times": -1})
    rc = main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
               "cpu", "--fault-plan", plan])
    out = _last_json(capsys)
    assert rc == 2 and out["kind"] == "retry_exhausted"
    assert out["site"] == "dispatch.cpu"


def test_cli_max_retries_caps_the_attempts(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MPIBT_MAX_RETRIES", "1")
    plan = _write_plan(tmp_path, {"site": "backend.cpu.search",
                                  "kind": "raise"})
    assert main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
                 "cpu", "--fault-plan", plan]) == 2
    assert "exhausted 1 attempt" in _last_json(capsys)["error"]


def test_cli_degraded_run_converges_rc0(tmp_path, capsys):
    plan = _write_plan(tmp_path, {"site": "backend.cuda.dispatch",
                                  "kind": "raise", "times": -1})
    rc = main(["mine", "--difficulty", "8", "--blocks", "2", "--device",
               "cpu", "--batch-pow2", "11", "--fault-plan", plan])
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert rc == 0
    assert out["degraded"] is True and out["degraded_to"] == "cpu"
    assert out["backend"] == "cpu" and out["rung"] == "cpu"
    assert out["height"] == 2
    assert "warning: backend degraded cpu" in captured.err


def test_cli_clean_run_reports_its_rung(capsys):
    assert main(["mine", "--difficulty", "8", "--blocks", "2", "--device",
                 "cpu", "--batch-pow2", "11"]) == 0
    out = _last_json(capsys)
    assert out["rung"] == "cuda:torch" and out["kernel"] == "torch"
    assert "degraded" not in out


def test_cli_kernel_error_rc2_without_retry_or_step_down(
        tmp_path, monkeypatch, capsys):
    def launch_fails(self, *a, **k):
        raise KernelError("sha256d_sweep launch failed: CUDA error 209")

    monkeypatch.setattr(CpuBackend, "search", launch_fails)
    metrics = tmp_path / "m.txt"
    rc = main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
               "cpu", "--metrics-dump", str(metrics)])
    out = _last_json(capsys)
    assert rc == 2 and out["kind"] == "kernel"
    assert "CUDA error 209" in out["error"]
    text = metrics.read_text()
    assert "retries_total" not in text
    assert "backend_degradations_total" not in text


def test_cli_kernel_failure_with_no_fault_rc2_without_step_down(
        tmp_path, monkeypatch, capsys):
    def faults(self, *a, **k):
        raise RuntimeError(ILLEGAL_ADDRESS)

    monkeypatch.setattr(CpuBackend, "search", faults)
    monkeypatch.setattr(CpuBackend, "hand_written_kernel", True)
    metrics = tmp_path / "m.txt"
    rc = main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
               "cpu", "--metrics-dump", str(metrics)])
    out = _last_json(capsys)
    assert rc == 2 and out["kind"] == "kernel"
    assert "illegal memory access" in out["error"]
    assert "backend_degradations_total" not in metrics.read_text()


def test_cli_checkpoint_every_requires_checkpoint(capsys):
    rc = main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
               "cpu", "--checkpoint-every", "1"])
    out = _last_json(capsys)
    assert rc == 2 and "--checkpoint" in out["error"]


def test_cli_strict_plan_never_masks_a_failing_run(tmp_path, capsys):
    plan = _write_plan(tmp_path, {"site": "sim.deliver", "kind": "raise",
                                  "call": 10 ** 6}, strict=True)
    rc = main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
               "cpu", "--resume", str(tmp_path / "missing.bin"),
               "--fault-plan", plan])
    out = _last_json(capsys)
    assert rc == 1 and "error" in out   # not rc 3
    assert not injection.active()


def test_smoke_kill_resume_and_degradation_on_the_cpu(tmp_path):
    """The resilience smoke's phases through the CLI: a miner subprocess
    SIGKILLed mid-run resumes from its checkpoint to the reference's d10
    chain; a dead CUDA dispatch steps down to the cpu oracle's chain."""
    from mpi_blockchain_tpu_torch.resilience.__main__ import (
        smoke_degradation, smoke_kill_resume)

    got = smoke_kill_resume(tmp_path, device="cpu", difficulty=10,
                            blocks=6)
    ref = RefMiner(RefConfig(difficulty_bits=10, n_blocks=6, backend="cpu"))
    ref.mine_chain()
    assert got["tip_hash"] == ref.node.tip_hash.hex()
    assert got["verified"] and got["resumed_to"] == 6
    assert got["torn_truncated_to"] == got["checkpoint_height"] - 1
    got = smoke_degradation(tmp_path, device="cpu")
    assert got["degraded"]["tip_hash"] == got["oracle"]["tip_hash"]


# ---- the bound on a wedged dispatch -----------------------------------------


class _WedgedSweep(CpuBackend):
    """A rung whose sweeps never complete on the "device": its finish
    carries a ``ready`` probe that never turns true (and reading it back
    would be a bug)."""

    def launch(self, *args, **kwargs):
        def finish():
            raise AssertionError("read back a sweep that is not done")
        finish.ready = lambda: False
        return finish


def _wedged_errors(monkeypatch):
    """The port's and the reference's "dispatch wedged" errors for the
    same one-block run with a 0.05 s budget, and the port's time to
    raise."""
    import concurrent.futures
    import time

    from mpi_blockchain_tpu.backend.cpu import CpuBackend as RefCpuBackend
    from mpi_blockchain_tpu.models import miner as ref_miner_mod
    from mpi_blockchain_tpu_torch.models import miner as miner_mod

    class RefWedged(RefCpuBackend):
        def search_async(self, *a, **kw):
            return concurrent.futures.Future()   # never completes

    monkeypatch.setattr(miner_mod, "DISPATCH_TIMEOUT_S", 0.05)
    monkeypatch.setattr(ref_miner_mod, "DISPATCH_TIMEOUT_S", 0.05)
    port = Miner(MinerConfig(difficulty_bits=8, n_blocks=1, backend="cpu"),
                 backend=ResilientBackend([("stub", _WedgedSweep)]),
                 pipeline=True)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="dispatch wedged") as got:
        port.mine_chain()
    took = time.perf_counter() - t0
    ref = RefMiner(RefConfig(difficulty_bits=8, n_blocks=1, backend="cpu"),
                   backend=RefWedged(), pipeline=True,
                   log_fn=lambda d: None)
    with pytest.raises(RuntimeError, match="dispatch wedged") as want:
        ref.mine_chain()
    return got.value, want.value, took


def test_wedged_dispatch_raises_the_references_error(monkeypatch):
    """A sweep that never completes fails the pipelined Miner with the
    reference's "dispatch wedged" RuntimeError, word for word, within its
    MPIBT_DISPATCH_TIMEOUT budget; it does not return, and it never reads
    back the wedged sweep."""
    got, want, took = _wedged_errors(monkeypatch)
    assert str(got) == str(want)
    assert "MPIBT_DISPATCH_TIMEOUT" in str(got)
    assert 0.05 <= took < 5.0
    assert got.__cause__ is None and got.__suppress_context__


def test_dispatch_timeout_knob_reads_as_the_reference():
    """MPIBT_DISPATCH_TIMEOUT's default and parse are the reference's."""
    import subprocess
    import sys

    code = ("import os, sys\n"
            "os.environ['MPIBT_DISPATCH_TIMEOUT'] = sys.argv[1]\n"
            "from mpi_blockchain_tpu_torch.models import miner\n"
            "print(miner.DISPATCH_TIMEOUT_S)\n")
    for raw, want in (("0.25", "0.25"), ("nope", "900.0"),
                      ("0.0001", "900.0")):
        out = subprocess.run([sys.executable, "-W", "ignore", "-c", code,
                              raw], capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0 and out.stdout.strip() == want, out


def test_slow_but_healthy_dispatch_is_polled_to_its_result(monkeypatch):
    """A sweep that completes after a few polls inside the budget gives
    its result: the bound does not cut healthy work, and the read-back
    comes only once the probe says the sweep is done."""
    from mpi_blockchain_tpu_torch.models import miner as miner_mod

    polls = []

    class Slow(CpuBackend):
        def launch(self, *args, **kwargs):
            finish = super().launch(*args, **kwargs)

            def read():
                assert len(polls) >= 3
                return finish()
            read.ready = lambda: polls.append(1) or len(polls) >= 3
            return read

    monkeypatch.setattr(miner_mod, "DISPATCH_TIMEOUT_S", 30.0)
    cfg = MinerConfig(difficulty_bits=8, n_blocks=2, backend="cpu")
    miner = Miner(cfg, backend=ResilientBackend([("slow", Slow)]),
                  pipeline=True)
    miner.mine_chain()
    ref = RefMiner(RefConfig(difficulty_bits=8, n_blocks=2, backend="cpu"),
                   log_fn=lambda d: None)
    ref.mine_chain()
    assert miner.node.tip_hash == ref.node.tip_hash


def test_a_sweep_that_raises_timeout_keeps_its_own_error(monkeypatch):
    """A backend whose search itself raises TimeoutError surfaces that
    error, not "dispatch wedged" (the classes alias), as in the
    reference."""
    from mpi_blockchain_tpu_torch.models import miner as miner_mod

    class Raises(CpuBackend):
        def search(self, *a, **kw):
            raise TimeoutError("the sweep's own timeout")

    monkeypatch.setattr(miner_mod, "DISPATCH_TIMEOUT_S", 0.05)
    miner = Miner(MinerConfig(difficulty_bits=8, n_blocks=1, backend="cpu"),
                  backend=Raises(), pipeline=True)
    with pytest.raises(TimeoutError, match="the sweep's own timeout"):
        miner.mine_chain()


def test_dispatch_variants_poll_forms_run_under_their_settings(monkeypatch):
    """``poll_20us``, ``poll_yield`` and ``unbounded`` run the shipped
    backend with the poll's sleep and the consume budget changed, and
    leave both as they were."""
    from mpi_blockchain_tpu_torch.models import miner as miner_mod
    from mpi_blockchain_tpu_torch.resilience import dispatch
    from mpi_blockchain_tpu_torch.tools import dispatch_variants

    seen = []
    monkeypatch.setattr(dispatch_variants, "timed_chain", lambda miner: (
        seen.append((dispatch.POLL_S, miner_mod.DISPATCH_TIMEOUT_S))
        or {}))
    before = (dispatch.POLL_S, miner_mod.DISPATCH_TIMEOUT_S)
    cfg = MinerConfig(difficulty_bits=9, n_blocks=1, backend="cpu")
    for form in ("shipped", "poll_20us", "poll_yield", "unbounded"):
        dispatch_variants.run_form(form, cfg)
    assert seen == [before, (20e-6, before[1]), (0.0, before[1]),
                    (before[0], None)]
    assert (dispatch.POLL_S, miner_mod.DISPATCH_TIMEOUT_S) == before
    assert before[0] is None
