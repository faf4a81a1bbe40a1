"""Throughput and chain-wall measurements of the port, shared by the CLI's
``bench`` and ``chip_smoke.py``.

The port's copy of the reference's ``bench_lib.py``, with its payload keys,
so a later benchmark can read both packages' records:

* ``bench_cuda`` (the reference's ``bench_tpu``): the raw sweep rate at
  difficulty 64 (no winner, no early exit) of the hand-written kernel on
  the card, with a window of calls in flight, beside the median CUDA-event
  time of one call and its bound from the function's work;
* ``bench_cpu``: the C++ sweep over ``n_miners`` threads, the "mpirun -np
  N" denominator;
* ``bench_chain``: the wall of a whole chain through ``FusedMiner``, the
  chain validated by the C++ loader;
* ``bench_sharded`` (the reference's ``bench_sharded_pallas``) and
  ``bench_cuda_single`` (``bench_tpu_single``): the pinned d16/n30 and
  d20/n10 cells with the C++ oracle's tip beside them;
* ``bench_sim_adversarial``: the steps per second of the vectorized
  adversarial scenario engine, which runs on the host in both packages
  (a seeded lottery stands in for mining), with the summary that doubles
  as its correctness canary;
* ``repeat_best``: best of N with the spread on the record.

The chain, sharded and single-preset payloads carry ``backend``, which
the reference's do not: the kernel that swept (``"cuda"`` on the card,
``"torch"`` for the plain version on the CPU), so that the history key of
a card measurement never equals the key of the reference's TPU record of
the same cell (``perfwatch.history.entry_key``).

Everything runs on the card unless the caller asks for the CPU
(``device="cpu"``: the plain PyTorch versions), and a number taken on the
CPU is never given a device metric's name (``kernel_ms`` and ``bound_ms``
are the card's only). The reference's ``alu_ops_per_nonce`` is a census
of its TPU program and has no counterpart here.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import subprocess
import threading
import time

from . import core
from .parallel.mesh import NONCE_SPACE
from .telemetry import counter, emit_event, gauge, heartbeat, \
    rank_counter
from .telemetry.events import env_number
from .telemetry.spans import span

_IMPOSSIBLE_DIFFICULTY = 64  # no 64-leading-zero-bit hash will be found
_HEADER = bytes(range(80))   # arbitrary fixed header; content is irrelevant
_M32 = 0xFFFFFFFF
#: The largest batch of one call the plain sweep runs on the CPU: the big
#: default exists to amortize launches on the card; on the CPU a 2^28 call
#: of the plain version would take most of an hour.
CPU_BATCH_POW2 = 16

# Per-phase device-init watchdog budget: a phase that exceeds it emits a
# ``hang`` event while the process is still alive, so a parent's timeout is
# attributable to a phase.
DEVICE_INIT_PHASE_TIMEOUT_S = env_number(
    "MPIBT_DEVICE_INIT_TIMEOUT", 300.0, cast=float, minimum=1e-6)


@contextlib.contextmanager
def _device_init_phase(name: str, timeout_s: float | None = None):
    """One attributable device-init phase: a ``bench.device_init`` span,
    a completion event carrying (phase, elapsed_s), and a hang watchdog
    that emits a ``hang`` event and dumps the flight recorder (if armed)
    when the phase outlasts its budget. The watchdog fires while the
    process is still alive, so the dump exists even when a parent then
    kills the wedged process."""
    from .telemetry import flight_recorder
    timeout_s = (DEVICE_INIT_PHASE_TIMEOUT_S if timeout_s is None
                 else timeout_s)
    # One heartbeat stamp at phase entry: a phase that wedges leaves the
    # gauge stale.
    heartbeat("bench_heartbeat").inc()
    t0 = time.perf_counter()

    def _hang() -> None:
        elapsed = round(time.perf_counter() - t0, 1)
        emit_event({"event": "bench.device_init", "phase": name,
                    "status": "hang", "elapsed_s": elapsed,
                    "timeout_s": timeout_s})
        flight_recorder.dump_now(
            f"bench.device_init hang: phase {name!r} still running "
            f"after {elapsed}s (budget {timeout_s}s)")

    watchdog = threading.Timer(timeout_s, _hang)
    watchdog.daemon = True
    watchdog.start()
    status = "done"
    try:
        with span("bench.device_init", phase=name):
            yield
    except BaseException as e:
        # The phase that raised must not read as done.
        status = f"error: {type(e).__name__}"
        raise
    finally:
        watchdog.cancel()
        emit_event({"event": "bench.device_init", "phase": name,
                    "status": status,
                    "elapsed_s": round(time.perf_counter() - t0, 3)})


def bench_cpu(seconds: float = 3.0, n_miners: int = 1,
              chunk: int = 1 << 18) -> dict:
    """C++ scalar sweep throughput over n_miners threads (the C++ sweep
    releases the interpreter lock)."""
    hashes_c = counter("bench_hashes_total",
                       help="nonces hashed by the bench sweep",
                       backend="cpu")

    def one_rank(rank: int) -> int:
        tried = 0
        deadline = time.perf_counter() + seconds
        base = rank * (1 << 28)
        hb = heartbeat("bench_heartbeat")
        # Per-rank attribution rides the rank-aware helper, as the
        # reference's does: one `rank` label convention for the mesh view.
        rank_c = rank_counter("bench_rank_hashes_total",
                              help="nonces hashed per bench rank",
                              rank=rank, backend="cpu")
        while time.perf_counter() < deadline:
            _, t = core.cpu_search(_HEADER, base, chunk,
                                   _IMPOSSIBLE_DIFFICULTY)
            tried += t
            hashes_c.inc(t)
            rank_c.inc(t)
            hb.inc()
            base += chunk
        return tried

    t0 = time.perf_counter()
    if n_miners == 1:
        per_rank = [one_rank(0)]
    else:
        with concurrent.futures.ThreadPoolExecutor(n_miners) as pool:
            per_rank = list(pool.map(one_rank, range(n_miners)))
    total = sum(per_rank)
    wall = time.perf_counter() - t0
    gauge("bench_hashes_per_sec",
          help="last measured sweep throughput",
          backend="cpu").set(total / wall)
    return {"backend": "cpu", "n_miners": n_miners,
            "hashes": total, "wall_s": round(wall, 3),
            "hashes_per_sec": total / wall,
            "hashes_per_sec_per_rank": total / wall / n_miners,
            "per_rank": [{"rank": i, "hashes": t,
                          "hashes_per_sec": round(t / wall, 1)}
                         for i, t in enumerate(per_rank)]}


def max_sm_clock_mhz(device) -> float:
    """The card's maximum SM clock (MHz), as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def sweep_bound_ms(nonces: int, difficulty_bits: int, device) -> float:
    """The least time the card could take to sweep ``nonces`` at
    ``difficulty_bits``: the bound from the function's work
    (``sha256_cuda.bound_sm_clocks_per_nonce`` of the compiled loop's
    census and the source's adds) over the card's SMs at its maximum SM
    clock, as ``chip_smoke.py`` phase 4 computes it. Raises when the
    disassembler or ``nvidia-smi`` cannot run."""
    import torch

    from .ops import sha256_cuda

    census = sha256_cuda.loop_census(sha256_cuda.disassemble(),
                                     difficulty_bits)
    per_nonce = sha256_cuda.bound_sm_clocks_per_nonce(
        census, sha256_cuda.source_adds(difficulty_bits))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return nonces * per_nonce / (sms * max_sm_clock_mhz(device) * 1e6) * 1e3


def call_ranges(round_size: int):
    """The ranges of the sweep bench's calls, in order, without end: each
    starts where the nonces swept so far end, wrapped at 2^32 (``tried &
    0xFFFFFFFF``, as the reference), and is clipped at 2^32. Yields
    (base, count)."""
    tried = 0
    while True:
        base = tried & _M32
        count = min(round_size, NONCE_SPACE - base)
        yield base, count
        tried += count


def _miner_shares(base: int, count: int, batch: int,
                  n_miners: int) -> list[int]:
    """Nonces each logical miner swept of a call over [base, base +
    count): miner i owns [base + i * batch, + batch)."""
    return [max(0, min(count, (i + 1) * batch) - i * batch)
            for i in range(n_miners)]


def bench_cuda(seconds: float = 5.0, batch_pow2: int = 28,
               n_miners: int = 1, kernel: str = "auto",
               depth: int | None = None, device="cuda") -> dict:
    """Sweep throughput of one card; the counterpart of the reference's
    ``bench_tpu``.

    Each call sweeps one round of n_miners x 2^batch_pow2 nonces from
    ``_HEADER`` at difficulty 64 (nothing qualifies), in one launch: the
    logical miners of one process share the launch, as in ``mine``. The
    start nonce wraps at 2^32 (``tried & 0xFFFFFFFF``, as the reference),
    and a call is clipped at 2^32; only what was swept counts.
    ``hashes_per_sec`` is tried / wall, with a window of ``depth`` calls
    in flight, each finished by reading its value back. On the card the
    payload adds ``kernel_ms``, the median CUDA-event time of one call,
    and ``bound_ms``, the least time a full call could take
    (``sweep_bound_ms``); a key whose tool cannot run is left out.
    """
    with _device_init_phase("torch_import"):
        import numpy as np
        import torch

    from .ops import extend_midstate, select_kernel

    with _device_init_phase("device_resolve"):
        from .backend.cuda import resolve_device
        device = resolve_device(device)
    on_card = device.type == "cuda"
    if not on_card:
        batch_pow2 = min(batch_pow2, CPU_BATCH_POW2)
    batch = 1 << batch_pow2
    round_size = batch * n_miners
    ext = extend_midstate(*core.header_midstate(_HEADER))
    with _device_init_phase("kernel_build"):
        fn, kernel = select_kernel(kernel, device, _IMPOSSIBLE_DIFFICULTY)
        if kernel == "cuda":
            from .ops import sha256_cuda
            sha256_cuda.library()   # nvcc at first use

    def start(base: int, count: int):
        """Starts one call; returns the function that reads it back."""
        if kernel == "cuda":
            return sha256_cuda.sweep_launch(
                ext, base, count, _IMPOSSIBLE_DIFFICULTY,
                device=device).result
        res = fn(ext, base, count)
        return lambda: res

    with _device_init_phase("warm"):
        start(0, min(round_size, NONCE_SPACE))()
    if depth is None:   # keep the in-flight queue under about 1 s of work
        depth = 16 if batch_pow2 < 26 else 4
    pending: list = []
    events: list = []
    calls = 0
    shares = [0] * n_miners
    hb = heartbeat("bench_heartbeat")
    ranges = call_ranges(round_size)
    t0 = time.perf_counter()
    tried = 0
    while time.perf_counter() - t0 < seconds:
        base, count = next(ranges)
        if kernel == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            pending.append(start(base, count))
            ev[1].record()
            events.append(ev)
        else:
            pending.append(start(base, count))
        tried += count
        calls += 1
        for i, n in enumerate(_miner_shares(base, count, batch, n_miners)):
            shares[i] += n
        if len(pending) >= depth:
            pending.pop(0)()
            hb.inc()
    for read in pending:
        read()
    wall = time.perf_counter() - t0
    counter("bench_hashes_total", help="nonces hashed by the bench sweep",
            backend="cuda").inc(tried)
    gauge("bench_hashes_per_sec", help="last measured sweep throughput",
          backend="cuda").set(tried / wall)
    result = {"backend": "cuda", "n_miners": n_miners, "kernel": kernel,
              "batch_pow2": batch_pow2, "platform": device.type,
              "device_name": (torch.cuda.get_device_name(device)
                              if on_card else "cpu"),
              "hashes": tried, "wall_s": round(wall, 3),
              "hashes_per_sec": tried / wall,
              # One card holds every logical miner.
              "hashes_per_sec_per_chip": tried / wall,
              "calls": calls}
    if on_card:
        times = sorted(a.elapsed_time(b) for a, b in events)
        result["kernel_ms"] = float(np.median(times))
        full = min(round_size, NONCE_SPACE)
        try:
            result["bound_ms"] = sweep_bound_ms(full, _IMPOSSIBLE_DIFFICULTY,
                                                device)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            emit_event({"event": "bench.bound_unavailable",
                        "error": f"{type(e).__name__}: {e}"})
    if n_miners > 1:
        result["per_rank"] = [
            {"rank": i, "device": str(device), "hashes": n,
             "hashes_per_sec": round(n / wall, 1)}
            for i, n in enumerate(shares)]
    return result


def bench_chain(n_blocks: int = 1000, difficulty_bits: int = 24,
                batch_pow2: int | str = 24, blocks_per_call: int = 100,
                n_miners: int = 1, kernel: str = "auto",
                device="cuda") -> dict:
    """Wall-clock to mine a whole chain through the fused k-block miner
    (``FusedMiner``), warmed up before the timer; the chain is validated
    by the C++ loader before the payload is returned. ``n_miners`` splits
    each round in this process."""
    import torch

    from .config import MinerConfig
    from .models.fused import FusedMiner

    cfg = MinerConfig(difficulty_bits=difficulty_bits, n_blocks=n_blocks,
                      batch_pow2=batch_pow2, backend="cuda",
                      n_miners=n_miners, kernel=kernel,
                      device=torch.device(device).type)
    miner = FusedMiner(cfg, blocks_per_call=blocks_per_call)
    miner.warmup()
    if n_blocks % blocks_per_call:    # the remainder call
        miner.warmup(n_blocks % blocks_per_call)
    t0 = time.perf_counter()
    miner.mine_chain()
    wall = time.perf_counter() - t0
    node = miner.node
    if node.height != n_blocks:
        raise RuntimeError(f"mined {node.height}/{n_blocks} blocks")
    # Full proof-of-work and linkage re-validation by the C++ loader.
    if not core.Node(difficulty_bits, 0).load(node.save()):
        raise RuntimeError("mined chain failed validation")
    gauge("bench_blocks_per_sec", help="last measured full-chain mining "
          "rate", backend="cuda-fused").set(n_blocks / wall)
    return {"n_blocks": n_blocks, "difficulty_bits": difficulty_bits,
            "n_miners": n_miners, "backend": miner.effective_kernel,
            "wall_s": round(wall, 3),
            "blocks_per_sec": n_blocks / wall,
            "tip_hash": node.tip_hash.hex()}


def _oracle_tip(difficulty_bits: int, n_blocks: int) -> str:
    """The tip the C++ sweep mines for the same chain."""
    from .config import MinerConfig
    from .models.miner import Miner

    oracle = Miner(MinerConfig(difficulty_bits=difficulty_bits,
                               n_blocks=n_blocks, backend="cpu"))
    oracle.mine_chain()
    return oracle.node.tip_hash.hex()


def bench_sharded(n_blocks: int = 30, difficulty_bits: int = 16,
                  batch_pow2: int = 20, blocks_per_call: int = 10,
                  kernel: str = "auto", device="cuda") -> dict:
    """The reference's ``bench_sharded_pallas`` cell (d16/n30, 10 blocks a
    call) through ``bench_chain`` with one miner, its tip held against the
    C++ oracle's."""
    result = bench_chain(n_blocks=n_blocks, difficulty_bits=difficulty_bits,
                         batch_pow2=batch_pow2,
                         blocks_per_call=blocks_per_call, n_miners=1,
                         kernel=kernel, device=device)
    oracle = _oracle_tip(difficulty_bits, n_blocks)
    return {**result, "mesh": "1-device ('miners',)",
            "kernel": result["backend"],
            "cpu_oracle_tip": oracle,
            "tip_matches_cpu_oracle": result["tip_hash"] == oracle}


def bench_cuda_single(device="cuda", kernel: str | None = None) -> dict:
    """The ``tpu-single`` preset (d20, 10 blocks, batch 2^20, the CUDA
    kernel) through the per-block pipelined ``Miner``, warmed up with one
    search before the timer, its tip held against the C++ oracle's; the
    reference's ``bench_tpu_single``. ``kernel`` overrides the preset's
    (the plain version on the CPU)."""
    import dataclasses

    import torch

    from .config import PRESETS
    from .models.miner import Miner

    cfg = dataclasses.replace(PRESETS["tpu-single"],
                              device=torch.device(device).type)
    if kernel is not None:
        cfg = dataclasses.replace(cfg, kernel=kernel)
    miner = Miner(cfg)
    miner.backend.search(bytes(80), cfg.difficulty_bits,
                         max_count=cfg.batch_size)
    t0 = time.perf_counter()
    miner.mine_chain()
    wall = time.perf_counter() - t0
    oracle = _oracle_tip(cfg.difficulty_bits, cfg.n_blocks)
    active = getattr(miner.backend, "active_backend", miner.backend)
    swept = getattr(active, "effective_kernel", None) or active.name
    return {"preset": "tpu-single", "backend": swept,
            "n_blocks": cfg.n_blocks,
            "difficulty_bits": cfg.difficulty_bits,
            "batch_pow2": cfg.batch_pow2, "wall_s": round(wall, 3),
            "hashes_per_sec": round(miner.hashes_per_sec()),
            "mhs": round(miner.hashes_per_sec() / 1e6, 2),
            "tip_hash": miner.node.tip_hash.hex(),
            "tip_matches_cpu_oracle": miner.node.tip_hash.hex() == oracle}


def bench_sim_adversarial(preset: str = "adversarial-bench") -> dict:
    """One timed run of the vectorized adversarial scenario engine, the
    ``sim_adversarial`` bench section, with the reference's keys. The
    scenario is a fixed preset (churn, retargeting and the selfish,
    eclipse and flood adversaries all live), so ``steps_per_sec`` prices
    the engine, and the summary doubles as a correctness canary. The
    engine is host numpy in both packages: the number is host time, on
    whatever machine runs it."""
    from .sim import SCENARIO_PRESETS, run_scenario

    scenario = SCENARIO_PRESETS[preset]
    t0 = time.perf_counter()
    net, summary = run_scenario(scenario)
    wall = time.perf_counter() - t0
    return {
        "preset": preset,
        "n_nodes": scenario.n_nodes,
        "steps": scenario.steps,
        "wall_s": round(wall, 3),
        "steps_per_sec": round(scenario.steps / wall, 1),
        "converged": summary["converged"],
        "blocks_total": summary["blocks_total"],
        "final_bits": summary["final_bits"],
        "sync_rejections": summary["sync_rejections"],
        "reorgs": summary["reorgs"],
    }


def repeat_best(measure, reps: int = 2, key: str = "hashes_per_sec",
                minimize: bool = False, prior: list | None = None) -> dict:
    """Runs measure() reps times and returns the best run's payload (min
    of ``key`` if minimize else max), annotated with the spread:
    {"reps", "spread_pct", "all_<key>"}. If payloads carry a tip_hash,
    all reps must agree (the determinism contract). ``prior`` seeds
    payloads already measured, counted toward reps."""
    outs = list(prior or [])
    outs += [measure() for _ in range(reps - len(outs))]
    vals = [o[key] for o in outs]
    best = min(vals) if minimize else max(vals)
    tips = {o["tip_hash"] for o in outs if "tip_hash" in o}
    if len(tips) > 1:
        raise RuntimeError(f"non-deterministic tips across reps: {tips}")
    payload = dict(outs[vals.index(best)])
    payload["reps"] = reps
    payload["spread_pct"] = round(
        100.0 * (max(vals) - min(vals)) / max(abs(best), 1e-12), 1)
    payload["all_" + key] = [round(v, 3) if isinstance(v, float) else v
                             for v in vals]
    return payload


def run_bench(backend: str = "cuda", seconds: float = 5.0,
              batch_pow2: int = 28, n_miners: int = 1,
              kernel: str = "auto", device="cuda") -> dict:
    if backend == "cpu":
        return bench_cpu(seconds=seconds, n_miners=n_miners)
    return bench_cuda(seconds=seconds, batch_pow2=batch_pow2,
                      n_miners=n_miners, kernel=kernel, device=device)
