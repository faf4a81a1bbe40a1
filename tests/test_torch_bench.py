"""The port's bench library against the reference's, on the CPU.

``bench_chain`` and ``bench_sharded`` at a tiny size against the
reference's ``bench_chain`` / ``bench_sharded_pallas`` with the jnp kernel
(the same tip, the same payload keys); ``repeat_best`` against the
reference's on the same fixed payload lists; ``bench_cpu``'s payload
against the reference's; the sweep bench's call ranges at the 2^32 wrap;
the device-init phases; and ``bench`` through the CLI on ``--device cpu``.
"""
import itertools
import json

import pytest
import torch

from mpi_blockchain_tpu import bench_lib as ref_bench
from mpi_blockchain_tpu_torch import bench_lib, telemetry
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import ConfigError

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    telemetry.clear_events()


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("n_miners", [1, 2])
def test_bench_chain_matches_the_reference(n_miners):
    kw = dict(n_blocks=5, difficulty_bits=9, batch_pow2=10,
              blocks_per_call=2, n_miners=n_miners)
    ours = bench_lib.bench_chain(device="cpu", **kw)
    ref = ref_bench.bench_chain(kernel="jnp", **kw)
    assert ours["tip_hash"] == ref["tip_hash"]
    # The port adds the kernel that swept, so that its history key is its
    # own (perfwatch.history.entry_key); every other key is the
    # reference's.
    assert set(ours) - set(ref) == {"backend"} and set(ref) <= set(ours)
    assert ours["backend"] == "torch"
    assert {k: ours[k] for k in ("n_blocks", "difficulty_bits",
                                 "n_miners")} == \
        {k: ref[k] for k in ("n_blocks", "difficulty_bits", "n_miners")}
    assert ours["blocks_per_sec"] > 0


def test_bench_sharded_matches_the_reference():
    kw = dict(n_blocks=6, difficulty_bits=8, batch_pow2=10,
              blocks_per_call=3)
    ours = bench_lib.bench_sharded(device="cpu", **kw)
    ref = ref_bench.bench_sharded_pallas(kernel="jnp", **kw)
    assert set(ours) - set(ref) == {"backend"} and set(ref) <= set(ours)
    assert ours["kernel"] == ours["backend"] == "torch"
    assert ours["tip_hash"] == ref["tip_hash"] == ref["cpu_oracle_tip"]
    assert ours["cpu_oracle_tip"] == ref["cpu_oracle_tip"]
    assert ours["tip_matches_cpu_oracle"] is True
    assert ours["mesh"] == ref["mesh"]


_PAYLOADS = [
    [{"hashes_per_sec": 3.0}, {"hashes_per_sec": 5.5},
     {"hashes_per_sec": 4.25}],
    [{"wall_s": 2.5, "tip_hash": "aa"}, {"wall_s": 2.25, "tip_hash": "aa"}],
    [{"wall_s": 1.0, "tip_hash": "aa"}],
]


@pytest.mark.parametrize("case", range(len(_PAYLOADS)))
@pytest.mark.parametrize("minimize", [False, True])
def test_repeat_best_matches_the_reference(case, minimize):
    outs = _PAYLOADS[case]
    key = next(iter(outs[0]))

    def run(fn, prior_n):
        it = iter(outs[prior_n:])
        return fn(lambda: dict(next(it)), reps=len(outs), key=key,
                  minimize=minimize, prior=outs[:prior_n])

    for prior_n in range(len(outs) + 1):
        assert run(bench_lib.repeat_best, prior_n) == \
            run(ref_bench.repeat_best, prior_n)


def test_repeat_best_refuses_mismatched_tips_as_the_reference():
    outs = [{"wall_s": 1.0, "tip_hash": "aa"},
            {"wall_s": 2.0, "tip_hash": "bb"}]
    msgs = []
    for fn in (bench_lib.repeat_best, ref_bench.repeat_best):
        it = iter(outs)
        with pytest.raises(RuntimeError, match="non-deterministic") as e:
            fn(lambda: next(it), reps=2, key="wall_s", minimize=True)
        msgs.append(str(e.value).split(":")[0])
    assert msgs[0] == msgs[1]


def test_bench_cpu_payload_matches_the_references():
    for n in (1, 2):
        ours = bench_lib.bench_cpu(seconds=0.05, n_miners=n, chunk=1 << 10)
        ref = ref_bench.bench_cpu(seconds=0.05, n_miners=n, chunk=1 << 10)
        assert set(ours) == set(ref)
        assert [set(r) for r in ours["per_rank"]] == \
            [set(r) for r in ref["per_rank"]]
        assert ours["hashes"] == sum(r["hashes"] for r in ours["per_rank"])
        assert ours["hashes"] % (1 << 10) == 0
    reg = telemetry.default_registry()
    assert reg.total("bench_hashes_total") == \
        reg.total("bench_rank_hashes_total")


@pytest.mark.parametrize("n_miners, pow2", [(1, 28), (8, 28), (3, 28),
                                            (8, 29)])
def test_sweep_calls_wrap_and_clip_at_2_32(n_miners, pow2):
    """Calls start at ``tried & 0xFFFFFFFF`` and stop at 2^32; only what
    was swept counts. At 8 x 2^29 one call is the whole space."""
    size = n_miners << pow2
    calls = list(itertools.islice(bench_lib.call_ranges(size), 40))
    tried = 0
    for base, count in calls:
        assert base == tried & 0xFFFFFFFF
        assert 0 < count <= size and base + count <= 1 << 32
        tried += count
    if (1 << 32) % size == 0:
        assert all(c == min(size, 1 << 32) for _, c in calls)
    else:
        assert any(c < size for _, c in calls)
    shares = bench_lib._miner_shares(0, size, 1 << pow2, n_miners)
    assert shares == [1 << pow2] * n_miners
    clipped = bench_lib._miner_shares(0, 5 << pow2 >> 1, 1 << pow2, 3)
    assert clipped == [1 << pow2, 1 << pow2, 1 << pow2 >> 1]


def test_bench_sweep_on_the_cpu(capsys):
    assert main(["bench", "--mode", "sweep", "--device", "cpu",
                 "--batch-pow2", "8", "--seconds", "0.2", "--miners",
                 "2"]) == 0
    out = _last_json(capsys)
    assert out["backend"] == "cuda" and out["platform"] == "cpu"
    assert out["kernel"] == "torch" and out["n_miners"] == 2
    assert out["hashes"] == out["calls"] * (2 << 8)
    assert out["hashes_per_sec"] > 0
    # No CUDA-event time and no bound from a CPU run.
    assert "kernel_ms" not in out and "bound_ms" not in out
    assert [r["hashes"] for r in out["per_rank"]] == \
        [out["hashes"] // 2] * 2
    phases = [e["phase"] for e in telemetry.recent_events(
        event="bench.device_init")]
    assert phases == ["torch_import", "device_resolve", "kernel_build",
                      "warm"]


def test_bench_chain_and_cpu_backend_through_the_cli(capsys, tmp_path):
    metrics = tmp_path / "m.prom"
    assert main(["bench", "--mode", "chain", "--device", "cpu", "--blocks",
                 "3", "--difficulty", "8", "--batch-pow2", "10",
                 "--blocks-per-call", "2", "--metrics-dump",
                 str(metrics)]) == 0
    out = _last_json(capsys)
    assert out["n_blocks"] == 3 and len(out["tip_hash"]) == 64
    assert "bench_blocks_per_sec" in metrics.read_text()
    assert main(["bench", "--backend", "cpu", "--seconds", "0.05"]) == 0
    assert _last_json(capsys)["backend"] == "cpu"


def test_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("sweep", "chain"):
        assert main(["bench", "--mode", mode, "--seconds", "0.05"]) == 2
        assert "no CUDA device" in _last_json(capsys)["error"]
    with pytest.raises(ConfigError, match="no CUDA device"):
        bench_lib.bench_cuda(seconds=0.01)


def test_device_init_phase_reports_hang_and_error():
    with pytest.raises(ValueError):
        with bench_lib._device_init_phase("kernel_build", timeout_s=30):
            raise ValueError("nvcc exploded")
    with bench_lib._device_init_phase("warm", timeout_s=0.01):
        import time
        time.sleep(0.2)
    events = telemetry.recent_events(event="bench.device_init")
    assert [(e["phase"], e["status"]) for e in events] == [
        ("kernel_build", "error: ValueError"), ("warm", "hang"),
        ("warm", "done")]
    assert len(telemetry.default_registry().spans("bench.device_init")) == 2
