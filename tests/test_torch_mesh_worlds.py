"""Worlds of the port's ``mine --mesh-obs`` processes on the CPU.

The reference's acceptance shape (``tests/test_meshwatch.py``): four rank
processes mine with ``--mesh-obs`` (one armed through ``MPIBT_MESH_OBS``),
rank 2 is SIGKILLed mid-run and must be the one stale rank of the merged
health, the survivors ``finished``, the counters summed, every rank's
heartbeat visible; ``meshwatch merge``, ``report --trace`` and ``watch
--once`` read its directory. The eight-rank form is the reference's slow
test. A two-process gloo world (``mine --coordinator --mesh-obs``) leaves
both shards under their ranks, its ``mesh.sweep`` rounds joined across
both by the skew analyzer. The ranks mine on the C++ sweep (the gloo world
on the plain sweep), as ``--device cpu`` asks.
"""
import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from mpi_blockchain_tpu.meshwatch import aggregate as ref_aggregate
from mpi_blockchain_tpu_torch.meshprof.analyzer import analyze_skew
from mpi_blockchain_tpu_torch.meshwatch import __main__ as mesh_cli
from mpi_blockchain_tpu_torch.meshwatch.aggregate import (
    merge_shards, mesh_compiles, mesh_health, read_shards)
from mpi_blockchain_tpu_torch.meshwatch.pipeline import (pipeline_report,
                                                         to_chrome_trace)
from mpi_blockchain_tpu_torch.meshwatch.world import (REPO_ROOT, reap,
                                                      spawn_rank)

torch.set_num_threads(1)


def _wait_for_victim_heartbeat(obs, victim, proc, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        shards = {s["rank"]: s for s in read_shards(obs)}
        beats = shards.get(victim, {}).get("heartbeats", {})
        if any("miner_heartbeat" in k for k in beats):
            return
        assert proc.poll() is None, proc.communicate()[1][-800:]
        time.sleep(0.05)
    raise AssertionError("victim rank never heartbeat")


def _run_world_with_kill(tmp_path, world, victim):
    obs = tmp_path / "mesh"
    survivors = [spawn_rank(r, world, obs, ["--difficulty", "10",
                                            "--blocks", "15"], "cpu")
                 for r in range(world) if r != victim]
    # The victim mines a long chain, armed through the environment.
    victim_proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
         "--backend", "cpu", "--difficulty", "20", "--blocks", "4000"],
        env={**os.environ,
             "PYTHONPATH": str(REPO_ROOT), "MPIBT_MESH_OBS": str(obs),
             "MPIBT_MESH_RANK": str(victim),
             "MPIBT_MESH_WORLD": str(world),
             "MPIBT_MESH_OBS_INTERVAL": "0.1"},
        cwd=str(REPO_ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        _wait_for_victim_heartbeat(obs, victim, victim_proc)
        victim_proc.send_signal(signal.SIGKILL)
        victim_proc.wait(timeout=30)
        for p in survivors:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"survivor failed: {err[-800:]}"
    finally:
        reap(survivors + [victim_proc])
    time.sleep(0.6)    # age the victim's last shard past the budget
    shards = read_shards(obs)
    view = merge_shards(shards)
    code, health = mesh_health(obs, stall_s=0.5, shards=shards)
    hashed = [v for v in view["counters"].values()
              if v["name"] == "hashes_tried_total"]
    assert hashed
    for c in hashed:
        assert c["total"] == sum(c["by_rank"].values())
    survivor_ranks = {str(r) for r in range(world)} - {str(victim)}
    assert survivor_ranks <= {r for c in hashed for r in c["by_rank"]}
    assert survivor_ranks | {str(victim)} <= {
        r for r, b in view["heartbeats"].items()
        if any("miner_heartbeat" in k for k in b)}
    assert code == 503
    assert health["stale_ranks"] == [victim]
    assert health["ranks"][str(victim)]["stale_reason"] == "dead-shard"
    for r in survivor_ranks:
        assert health["ranks"][r]["status"] == "finished"
    # The reference's aggregator reads the port's directory the same way.
    assert ref_aggregate.mesh_health(obs, stall_s=0.5, shards=shards)[1][
        "stale_ranks"] == [victim]
    return obs, health


def _cli(argv) -> tuple[int, list[str]]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mesh_cli.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_four_ranks_one_killed_and_the_cli_on_its_directory(tmp_path):
    obs, health = _run_world_with_kill(tmp_path, world=4, victim=2)
    assert health["live_ranks"] == 0    # survivors finished, victim dead
    records = [r for s in read_shards(obs) for r in s.get("pipeline", [])]
    rep = pipeline_report(records)
    assert rep["dispatch_count"] > 0 and rep["bubble_fraction"] is not None
    assert len(to_chrome_trace(records)["traceEvents"]) > 0

    rc, lines = _cli(["merge", "--dir", str(obs), "--check",
                       "--stall-s", "0.5"])
    merged = json.loads(lines[-1])
    assert rc == 1 and merged["health"]["stale_ranks"] == [2]
    assert merged["view"]["world_size"] == 4
    rc, lines = _cli(["merge", "--dir", str(obs), "--prometheus",
                       "--stall-s", "0.5"])
    assert rc == 0 and 'mesh_rank_up{rank="2"} 0' in lines
    trace = tmp_path / "trace.json"
    rc, lines = _cli(["report", "--dir", str(obs), "--trace", str(trace)])
    out = json.loads(lines[-1])
    assert rc == 0 and out["pipeline"]["dispatch_count"] == \
        rep["dispatch_count"]
    assert out["trace"]["events"] == \
        len(json.loads(trace.read_text())["traceEvents"]) > 0
    rc, lines = _cli(["watch", "--dir", str(obs), "--once", "--stall-s",
                       "0.5"])
    assert rc == 1 and json.loads(lines[-1])["stale_ranks"] == [2]


@pytest.mark.slow
def test_eight_ranks_one_killed(tmp_path):
    obs, health = _run_world_with_kill(tmp_path, world=8, victim=5)
    assert health["world_size"] == 8


def test_a_gloo_world_writes_both_shards_and_joins_its_rounds(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    obs = tmp_path / "mesh"
    base = [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
            "--device", "cpu", "--difficulty", "11", "--blocks", "3",
            "--batch-pow2", "9", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--mesh-obs", str(obs)]
    env = {**os.environ,
           "PYTHONPATH": str(REPO_ROOT)}
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
    summary = json.loads(outs[1][0].strip().splitlines()[-1])
    shards = read_shards(obs)
    assert [s["rank"] for s in shards] == [0, 1]
    assert all(s["world_size"] == 2 and s["final"] for s in shards)
    code, health = mesh_health(obs, stall_s=1e9, shards=shards)
    assert code == 200
    assert sorted(int(r) for r, v in health["ranks"].items()
                  if v["status"] == "finished") == [0, 1]
    report = analyze_skew(shards)
    site = report["sites"]["mesh.sweep"]
    assert site["ranks"] == [0, 1]
    # One winner-select round a search, the same rounds on both ranks.
    rounds = [len([s for s in sh["skew_spans"] if s["site"] == "mesh.sweep"])
              for sh in shards]
    assert rounds[0] == rounds[1] == site["rounds"] >= 3
    assert health["skew"]["sites"]["mesh.sweep"]["rounds"] == site["rounds"]
    assert mesh_compiles(shards) == {}      # no card: no nvcc, no program
    hashed = [v for v in merge_shards(shards)["counters"].values()
              if v["name"] == "hashes_tried_total"]
    assert hashed and all(c["total"] == sum(c["by_rank"].values())
                          for c in hashed)
    assert summary["height"] == 3
