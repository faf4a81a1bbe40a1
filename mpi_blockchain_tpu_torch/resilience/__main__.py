"""CLI: ``python -m mpi_blockchain_tpu_torch.resilience
{smoke,elastic-smoke,plan}``.

``smoke`` drives the port's resilience through its real CLI, in the
reference's three phases:

1. **Determinism.** One fixed-seed fault plan (a ``corrupt`` and a
   ``partial`` window on ``sim.deliver``, a ``partial`` window on the
   search rung's site) drives two identical faulted simulations; their
   causal event dumps must be byte-identical.
2. **Kill + resume.** A miner subprocess that checkpoints every block is
   SIGKILLed mid-run; the resume must load the last atomic checkpoint,
   mine on to the target and verify, and, after a deliberate tear of the
   checkpoint's tail, truncate to the last valid block and mine on again.
   The subprocess's dispatch site hangs at its sixth call (a real sleep of
   ``KILL_HANG_S``), so the kill always lands within the first few blocks,
   whatever the device's speed.
3. **Step-down.** A fault plan kills every ``backend.cuda.dispatch``; the
   ladder must walk down to ``cpu`` and still converge with rc 0 on the
   chain the C++ sweep mines (``--backend cpu``).

``--device cuda`` (the default, as on ``mine`` and ``sim``) runs them on
the card, where the plan's search fault lands on ``backend.cuda.dispatch``,
the rung that runs; ``--device cpu`` runs them on the CPU (the C++ sweep,
whose fault site ``backend.cpu.search`` the reference's plan names).

``elastic-smoke`` drives the elastic mesh through the CLI in the
reference's two phases, each a world of four ``mine --elastic`` rank
processes sharing a ``--mesh-obs`` directory:

1. **SIGKILL.** Rank 2 is SIGKILLed once its shard proves a miner
   heartbeat; the survivors must evict it through the shard oracle
   (``dead-shard``), re-stripe over ``[0, 1, 3]``, exit 0 and mine chains
   the C++ node accepts. Their chains are sized so that they still mine
   when the eviction lands (``survivor_chain``).
2. **Determinism.** A seeded ``mesh.rank_death`` plan hard-exits one
   rank (rc 137, no final shard) at block 3 while every survivor evicts it
   there; two same-seed worlds must write byte-identical causal dumps.

Its ranks mine on the card unless ``--device cpu`` asks for the C++ sweep,
and each is held to its device's rung with no retry or step-down
(``meshwatch.world.rung_fault``).

``plan --seed N`` prints the plan ``--fault-plan seed:N`` would arm.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading

from ..config import ConfigError

#: How long the killed miner's dispatch hangs, so the kill lands before it
#: mines on (it is killed long before the sleep ends).
KILL_HANG_S = 60.0
#: The longest the killed miner may take to log its first three blocks.
KILL_TIMEOUT_S = 300.0


def _run_cli(argv: list[str]) -> tuple[int, dict]:
    """Runs the port's CLI in-process; returns (rc, last JSON line)."""
    from ..cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else {})


def _device_args(device: str) -> tuple[list[str], str]:
    """The mine flags that put the search on ``device`` ("cpu": the C++
    sweep, "cuda": the card), and that backend's dispatch fault site."""
    if device == "cpu":
        return ["--backend", "cpu"], "backend.cpu.search"
    return ["--device", device], "backend.cuda.dispatch"


def smoke_determinism(tmp: pathlib.Path, device: str = "cuda") -> dict:
    """Runs the same faulted ``sim`` twice on ``device`` and holds the two
    causal dumps byte for byte. The plan is the reference's, with its
    search fault on the site of the rung that runs on ``device``. Returns
    the dump's size and sha256 and the run's summary."""
    dev_args, site = _device_args(device)
    plan = {"version": 1, "seed": 5, "faults": [
        {"site": "sim.deliver", "kind": "corrupt", "call": 2, "times": 2},
        {"site": "sim.deliver", "kind": "partial", "call": 7, "times": 3},
        {"site": site, "kind": "partial", "call": 5, "times": 2},
    ]}
    plan_path = tmp / f"determinism_{device}.json"
    plan_path.write_text(json.dumps(plan))
    dumps = []
    for i in range(2):
        dump = tmp / f"dump_{device}_{i}.json"
        rc, out = _run_cli(["sim", "--blocks", "4", "--partition-steps",
                            "10", "--drop-rate", "10", "--seed", "3",
                            *dev_args, "--fault-plan", str(plan_path),
                            "--events-dump", str(dump)])
        assert rc == 0, f"faulted sim run {i} rc={rc}: {out}"
        assert out.get("converged") is True, out
        dumps.append(dump.read_bytes())
    assert dumps[0] == dumps[1], (
        f"a fixed-seed fault plan gave diverging causal dumps "
        f"({len(dumps[0])} vs {len(dumps[1])} bytes)")
    return {"faults": len(plan["faults"]), "dump_bytes": len(dumps[0]),
            "sha256": hashlib.sha256(dumps[0]).hexdigest(), "summary": out}


def smoke_kill_resume(tmp: pathlib.Path, device: str = "cuda",
                      difficulty: int = 10, blocks: int = 10) -> dict:
    """SIGKILLs a checkpointing miner on ``device`` after its third block,
    resumes from the checkpoint to ``blocks``, verifies, then tears the
    checkpoint's tail and resumes again. Returns the numbers, the resumed
    tip among them."""
    ck = tmp / "ck.bin"
    plan = tmp / "kill_plan.json"
    dev_args, site = _device_args(device)
    plan.write_text(json.dumps({"version": 1, "faults": [
        {"site": site, "kind": "hang", "call": 5, "seconds": KILL_HANG_S}]}))
    repo_root = pathlib.Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(repo_root), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
         "--difficulty", str(difficulty), "--blocks", str(blocks),
         *dev_args, "--checkpoint", str(ck), "--checkpoint-every", "1",
         "--fault-plan", str(plan), "--verbose"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp))
    mined = 0
    tail: collections.deque[str] = collections.deque(maxlen=40)
    # A miner that never logs three blocks is killed all the same.
    watchdog = threading.Timer(KILL_TIMEOUT_S, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            tail.append(line.rstrip())
            if '"block_mined"' in line:
                mined += 1
                if mined >= 3:
                    break
    finally:
        watchdog.cancel()
        proc.kill()
        tail.extend(proc.stdout.read().splitlines())
        proc.stdout.close()
        proc.wait(timeout=60)
    said = "\n".join(tail)
    assert mined >= 3, f"miner died before mining 3 blocks:\n{said}"
    # The height a resume starts from is the chain file's: the checkpoint
    # publishes the chain file first and its sidecar second, so a kill
    # between the two leaves a sidecar one save behind, which the resume
    # treats as damage and repairs (a truncation that drops nothing).
    height = _checkpoint_height(ck)
    # The kill can land between a block's log line and its save:
    # --checkpoint-every 1 loses at most one block.
    assert mined - 1 <= height < blocks, (mined, height, said)
    # (a) Straight resume: the atomic writer left the checkpoint whole.
    out_path = tmp / "resumed.bin"
    rc, out = _run_cli(["mine", "--difficulty", str(difficulty),
                        "--blocks", str(blocks), *dev_args,
                        "--resume", str(ck), "--out", str(out_path)])
    assert rc == 0 and out["height"] == blocks, (rc, out, said)
    rc, verdict = _run_cli(["verify", "--chain", str(out_path),
                            "--difficulty", str(difficulty)])
    assert rc == 0 and verdict["valid"] is True, (rc, verdict, said)
    # (b) Torn tail: rip the trailer and most of the last header off, as
    # a non-atomic writer's crash would; the resume truncates to the last
    # valid block and mines on.
    blob = ck.read_bytes()
    ck.write_bytes(blob[:-120])
    rc, torn = _run_cli(["mine", "--difficulty", str(difficulty),
                         "--blocks", str(height + 1), *dev_args,
                         "--resume", str(ck)])
    assert rc == 0 and torn["height"] == height + 1, (rc, torn, said)
    from ..telemetry.events import recent_events
    # This checkpoint's truncations only: other runs in this process may
    # have rung events of their own.
    truncs = [e for e in recent_events(event="checkpoint_truncated")
              if e.get("path") == str(ck)]
    assert truncs and truncs[-1]["height"] == height - 1, (truncs, said)
    return {"mined_before_kill": mined, "checkpoint_height": height,
            "resumed_to": out["height"], "tip_hash": out["tip_hash"],
            "verified": verdict["valid"],
            "torn_truncated_to": truncs[-1]["height"],
            "torn_resumed_to": torn["height"]}


def _checkpoint_height(ck: pathlib.Path) -> int:
    """The height of the chain a checkpoint file holds, its trailer (if
    whole) stripped."""
    from .. import core
    from ..utils.checkpoint import split_trailer

    payload, _ = split_trailer(ck.read_bytes())
    return len(payload) // core.HEADER_SIZE - 1


def smoke_degradation(tmp: pathlib.Path, device: str = "cuda") -> dict:
    """Kills every ``backend.cuda.dispatch`` on ``device`` (d8, 2 blocks,
    batch 2^11): the run must step down to ``cpu``, exit 0, and mine the
    chain of the ``--backend cpu`` oracle. Returns both summaries."""
    plan_path = tmp / "kill_cuda.json"
    plan_path.write_text(json.dumps({"version": 1, "faults": [
        {"site": "backend.cuda.dispatch", "kind": "raise", "call": 0,
         "times": -1}]}))
    rc, out = _run_cli(["mine", "--difficulty", "8", "--blocks", "2",
                        "--device", device, "--batch-pow2", "11",
                        "--fault-plan", str(plan_path)])
    assert rc == 0, f"degraded mine must still converge rc 0, got {rc}"
    assert out.get("degraded") is True and out["degraded_to"] == "cpu", out
    assert out["backend"] == "cpu" and out["rung"] == "cpu", out
    rc, oracle = _run_cli(["mine", "--difficulty", "8", "--blocks", "2",
                           "--backend", "cpu"])
    assert rc == 0, oracle
    assert out["tip_hash"] == oracle["tip_hash"], (
        "degraded chain diverged from the cpu oracle chain")
    return {"degraded": out, "oracle": oracle}


def cmd_smoke(args) -> int:
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        got = smoke_determinism(tmp, device=args.device)
        print(f"smoke: determinism ok ({got['faults']} faults, "
              f"{got['dump_bytes']}-byte causal dump byte-identical across "
              f"2 runs, sha256 {got['sha256']})", flush=True)
        got = smoke_kill_resume(tmp, device=args.device)
        print(f"smoke: kill+resume ok {json.dumps(got, sort_keys=True)}",
              flush=True)
        got = smoke_degradation(tmp, device=args.device)
        print(f"smoke: step-down ok (rung {got['degraded']['rung']}, tip "
              f"{got['degraded']['tip_hash']} == the cpu oracle's)",
              flush=True)
    return 0


# ---- the elastic smoke ------------------------------------------------------

#: The elastic smoke's world and the rank its SIGKILL phase kills.
ELASTIC_WORLD, ELASTIC_VICTIM = 4, 2
#: The determinism phase's plan (the reference's): the third
#: ``mesh.rank_death`` step, at height 3, kills a seeded-chosen rank.
RANK_DEATH_PLAN = {"version": 1, "seed": 9, "faults": [
    {"site": "mesh.rank_death", "kind": "partial", "call": 2}]}
RANK_DEATH_HEIGHT = 3
#: The determinism phase's chain by device: the reference's on the C++
#: sweep, a harder one on the card (a d12 block there takes microseconds).
DEATH_CHAIN = {"cpu": ["--difficulty", "12", "--blocks", "8",
                       "--batch-pow2", "12"],
               "cuda": ["--difficulty", "20", "--blocks", "8"]}
#: The SIGKILL phase's shard cadence and stall budget (the reference's): a
#: live survivor's flusher starved by a busy host is never taken for the
#: corpse; the missing-rank grace is parked beyond the run.
SIGKILL_ENV = {"MPIBT_MESH_OBS_INTERVAL": "0.2", "MPIBT_MESH_STALL": "2.0",
               "MPIBT_ELASTIC_GRACE": "600"}
#: The SIGKILL phase's victim, by device: a chain it is still sweeping
#: when the signal lands.
SIGKILL_VICTIM_CHAIN = {"cpu": ["--difficulty", "24", "--blocks", "1000"],
                        "cuda": ["--difficulty", "32", "--blocks", "1000",
                                 "--batch-pow2", "22"]}
#: Seconds of mining each SIGKILL survivor is sized to: the eviction lands
#: a few seconds in (the kill, then the 2 s stall budget).
SURVIVOR_SECONDS = {"cpu": 12.0, "cuda": 6.0}


def survivor_chain(device: str) -> list[str]:
    """The SIGKILL survivors' chain, sized to ``SURVIVOR_SECONDS`` of
    mining at this host's (or card's) sweep rate, as the reference sizes
    it: d18 on the C++ sweep, where each rank has a core of its own; d28
    at 2^24 a window on the card (where a block's hashing, not its host
    work, sets its length), which the four ranks share, each mining a
    chain of its own on its stripes."""
    import time

    from .. import core

    if device == "cpu":
        t0 = time.perf_counter()
        _, probed = core.cpu_search(bytes(range(80)), 0, 1 << 20, 40)
        rate = probed / max(time.perf_counter() - t0, 1e-9)
        blocks = max(12, min(600, int(SURVIVOR_SECONDS["cpu"] * rate
                                      / (1 << 18))))
        return ["--difficulty", "18", "--blocks", str(blocks)]
    from ..backend.cuda import CudaBackend

    backend = CudaBackend(batch_pow2=24, device=device)
    probe = 1 << 28
    backend.search(bytes(range(80)), 64, 0, probe)   # loads the library
    t0 = time.perf_counter()
    backend.search(bytes(range(80)), 64, 0, probe)
    rate = probe / max(time.perf_counter() - t0, 1e-9)
    blocks = max(12, min(1000, int(SURVIVOR_SECONDS["cuda"] * rate
                                   / (ELASTIC_WORLD << 28))))
    return ["--difficulty", "28", "--blocks", str(blocks),
            "--batch-pow2", "24"]


def _elastic_ranks(tmp: pathlib.Path, name: str, device: str, argv_of,
                   extra_env: dict | None = None, entry=None) -> dict:
    """Starts the four ranks of one ``mine --elastic`` world (rank r with
    the flags ``argv_of(r)``), sharing ``tmp/name/mesh``."""
    from ..meshwatch.world import spawn_rank

    obs = tmp / name / "mesh"
    obs.mkdir(parents=True, exist_ok=True)
    return {r: spawn_rank(r, ELASTIC_WORLD, obs, ["--elastic", *argv_of(r)],
                          device, extra_env, entry=entry)
            for r in range(ELASTIC_WORLD)}


def _last_json(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return json.loads(lines[-1]) if lines else {}


def _check_chain(path: pathlib.Path, difficulty: int, what: str) -> None:
    """The rank's chain file passes the C++ node's full validation."""
    from .. import core

    assert core.Node(difficulty).load(path.read_bytes()), \
        f"{what}: chain failed the C++ node's validation"


def _check_rungs(obs: pathlib.Path, device: str, outs: dict,
                 what: str) -> dict:
    """Every shard's rank mined on ``device``'s rung with no retry and no
    step-down (a killed rank's shard speaks for it); returns the shards
    by rank."""
    from ..meshwatch.aggregate import read_shards
    from ..meshwatch.world import rung_fault

    shards = {s["rank"]: s for s in read_shards(obs)}
    for rank, shard in shards.items():
        fault = rung_fault(rank, device, shard, outs.get(rank))
        assert fault is None, f"{what}: {fault}"
    return shards


def elastic_rank_death_world(tmp: pathlib.Path, name: str,
                             device: str = "cuda", chain=None,
                             entry=None) -> dict:
    """One four-rank world under ``RANK_DEATH_PLAN``, each rank writing
    its chain and its causal dump: exactly one rank, never rank 0, exits
    137 with no final shard and no dump; every survivor exits 0, evicts
    it for ``rank_death`` at ``RANK_DEATH_HEIGHT``, mines a valid chain
    and stays on its rung. Returns the victim, the survivors' dumps,
    summaries and final shards, each rank's stderr and the world's
    wall."""
    import time

    chain = DEATH_CHAIN[device] if chain is None else chain
    difficulty = int(chain[chain.index("--difficulty") + 1])
    plan = tmp / "rank_death.json"
    plan.write_text(json.dumps(RANK_DEATH_PLAN))
    base = tmp / name
    t0 = time.perf_counter()
    procs = _elastic_ranks(tmp, name, device, lambda r: [
        *chain, "--fault-plan", str(plan),
        "--events-dump", str(base / f"dump_{r}.json"),
        "--out", str(base / f"chain_{r}.bin")], entry=entry)
    from ..meshwatch.world import reap
    try:
        got = {r: p.communicate(timeout=600) for r, p in procs.items()}
    finally:
        reap(procs.values())
    wall = time.perf_counter() - t0
    rcs = {r: p.returncode for r, p in procs.items()}
    victims = [r for r, rc in rcs.items() if rc == 137]
    what = f"elastic {name}"
    assert len(victims) == 1, f"{what}: exit codes {rcs}: " + \
        "; ".join(err[-600:] for _, err in got.values())
    victim = victims[0]
    assert victim != 0, f"{what}: the anchor rank must never be the victim"
    assert all(rc == 0 for r, rc in rcs.items() if r != victim), \
        (what, rcs, {r: got[r][1][-600:] for r in rcs if rcs[r]})
    outs = {r: (None if r == victim else got[r][0]) for r in rcs}
    shards = _check_rungs(base / "mesh", device, outs, what)
    assert not shards[victim]["final"], \
        f"{what}: the hard-exited rank {victim} wrote a final shard"
    assert not (base / f"dump_{victim}.json").exists(), \
        f"{what}: the hard-exited rank {victim} wrote a dump"
    summaries, dumps = {}, {}
    for r in rcs:
        if r == victim:
            continue
        summaries[r] = _last_json(got[r][0])
        mesh = summaries[r].get("mesh") or {}
        ev = [(e["rank"], e["reason"], e["height"])
              for e in mesh.get("evicted", [])]
        assert ev == [(victim, "rank_death", RANK_DEATH_HEIGHT)], \
            (what, r, mesh)
        assert victim not in mesh.get("live", []), (what, r, mesh)
        assert shards[r]["final"] and shards[r]["exit_status"] == 0, \
            (what, r)
        _check_chain(base / f"chain_{r}.bin", difficulty, f"{what} rank {r}")
        dumps[r] = (base / f"dump_{r}.json").read_bytes()
    return {"victim": victim, "dumps": dumps, "summaries": summaries,
            "shards": {r: shards[r] for r in summaries},
            "stderr": {r: err for r, (_, err) in got.items()},
            "wall_s": wall}


def smoke_elastic_determinism(tmp: pathlib.Path,
                              device: str = "cuda") -> dict:
    """Two same-seed ``mesh.rank_death`` worlds: the same victim dies at
    the same height, and every survivor's causal dump is byte-identical
    across the two."""
    runs = [elastic_rank_death_world(tmp, f"death{i}", device)
            for i in range(2)]
    assert runs[0]["victim"] == runs[1]["victim"], \
        [r["victim"] for r in runs]
    for r, dump in runs[0]["dumps"].items():
        assert dump == runs[1]["dumps"][r], \
            f"rank {r}: same-seed mesh.rank_death dumps diverge"
    return {"victim": runs[0]["victim"], "height": RANK_DEATH_HEIGHT,
            "dump_bytes": {r: len(d) for r, d in runs[0]["dumps"].items()},
            "wall_s": [r["wall_s"] for r in runs]}


def smoke_elastic_sigkill(tmp: pathlib.Path, device: str = "cuda",
                          entry=None) -> dict:
    """A four-rank world whose rank ``ELASTIC_VICTIM`` is SIGKILLed once
    its shard proves a miner heartbeat: every survivor evicts it for
    ``dead-shard`` (the shard oracle's ``evict``), re-stripes over the
    other three, exits 0 with a valid chain and stays on its rung.
    Returns the eviction heights, the survivors' summaries and final
    shards, each survivor's stderr and the world's wall."""
    import signal
    import time

    from ..meshwatch.aggregate import read_shards
    from ..meshwatch.shard import shard_path
    from ..meshwatch.world import reap

    chain = survivor_chain(device)
    difficulty = int(chain[chain.index("--difficulty") + 1])
    victim, name = ELASTIC_VICTIM, "sigkill"
    base = tmp / name
    t0 = time.perf_counter()
    procs = _elastic_ranks(
        tmp, name, device,
        lambda r: (SIGKILL_VICTIM_CHAIN[device] if r == victim else
                   [*chain, "--out", str(base / f"chain_{r}.bin")]),
        SIGKILL_ENV, entry=entry)
    obs = base / "mesh"
    try:
        deadline = time.monotonic() + 120
        vpath = shard_path(obs, victim)
        while time.monotonic() < deadline:
            beats = {s["rank"]: s for s in read_shards(obs)}.get(
                victim, {}).get("heartbeats", {})
            if vpath.exists() and any("miner_heartbeat" in k
                                      for k in beats):
                break
            assert procs[victim].poll() is None, \
                procs[victim].communicate()[1][-800:]
            time.sleep(0.1)
        else:
            raise AssertionError("elastic sigkill: victim never heartbeat")
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)
        got = {r: p.communicate(timeout=600) for r, p in procs.items()
               if r != victim}
    finally:
        reap(procs.values())
    wall = time.perf_counter() - t0
    for r, p in procs.items():
        if r != victim:
            assert p.returncode == 0, \
                f"survivor rank {r} rc={p.returncode}: {got[r][1][-800:]}"
    outs = {r: out for r, (out, _) in got.items()}
    outs[victim] = None
    shards = _check_rungs(obs, device, outs, "elastic sigkill")
    summaries, heights = {}, {}
    for r in got:
        summaries[r] = _last_json(outs[r])
        mesh = summaries[r].get("mesh") or {}
        assert mesh.get("live") == [0, 1, 3], (r, mesh)
        ev = {e["rank"]: e for e in mesh.get("evicted", [])}
        assert list(ev) == [victim] and \
            ev[victim]["reason"] == "dead-shard", (r, mesh)
        assert ev[victim]["height"] < summaries[r]["height"], \
            f"rank {r} evicted at its last block: no re-striped mining"
        heights[r] = ev[victim]["height"]
        _check_chain(base / f"chain_{r}.bin", difficulty, f"rank {r}")
    return {"victim": victim, "eviction_heights": heights,
            "blocks": int(chain[chain.index("--blocks") + 1]),
            "difficulty": difficulty, "summaries": summaries,
            "shards": {r: shards[r] for r in got},
            "stderr": {r: err for r, (_, err) in got.items()},
            "wall_s": wall}


def cmd_elastic_smoke(args) -> int:
    from ..meshwatch.world import check_device

    check_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        got = smoke_elastic_sigkill(tmp, device=args.device)
        print(f"elastic-smoke: sigkill ok (victim {got['victim']} evicted "
              f"for dead-shard by every survivor at heights "
              f"{got['eviction_heights']} of {got['blocks']} d"
              f"{got['difficulty']} blocks; chains valid)", flush=True)
        got = smoke_elastic_determinism(tmp, device=args.device)
        print(f"elastic-smoke: determinism ok (seeded victim "
              f"{got['victim']} died at height {got['height']} in both "
              f"runs; survivor causal dumps byte-identical, "
              f"{got['dump_bytes']} bytes)", flush=True)
    return 0


def cmd_plan(args) -> int:
    from .faultplan import FaultPlan
    print(json.dumps(FaultPlan.from_seed(args.seed,
                                         n_faults=args.faults).to_dict(),
                     indent=2, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.resilience",
        description="resilience gate: faulted-sim determinism, "
                    "kill+resume recovery and the step-down ladder, "
                    "through the port's CLI")
    sub = parser.add_subparsers(dest="command", required=True)
    p_smoke = sub.add_parser("smoke", help="run the resilience smoke")
    p_smoke.add_argument("--device", choices=("cuda", "cpu"),
                         default="cuda",
                         help="where the phases run (default cuda: the "
                              "card; cpu: the C++ sweep)")
    p_smoke.set_defaults(fn=cmd_smoke)
    p_elastic = sub.add_parser(
        "elastic-smoke",
        help="run the elastic-mesh smoke: a 4-rank striped world, one rank "
             "SIGKILLed -> staleness eviction, re-stripe and rc 0, plus "
             "byte-identical same-seed mesh.rank_death worlds")
    p_elastic.add_argument("--device", choices=("cuda", "cpu"),
                           default="cuda",
                           help="where the ranks mine (default cuda: the "
                                "card; cpu: the C++ sweep)")
    p_elastic.set_defaults(fn=cmd_elastic_smoke)
    p_plan = sub.add_parser("plan", help="print the plan --fault-plan "
                                         "seed:N would arm")
    p_plan.add_argument("--seed", type=int, default=0)
    p_plan.add_argument("--faults", type=int, default=3)
    p_plan.set_defaults(fn=cmd_plan)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ConfigError as e:
        # No card for a smoke asked to run on it: a clean error, rc 2.
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2


if __name__ == "__main__":
    sys.exit(main())
