"""Worlds of mesh-observed ``mine`` processes, for the multi-rank smokes.

The reference's ``meshwatch``, ``chainwatch``, ``blocktrace``, skew and
elastic smokes each spawn their ranks the same way: one ``mine --mesh-obs
DIR`` process a rank, labeled through ``MPIBT_MESH_RANK``/
``MPIBT_MESH_WORLD``, with the shard flusher at 0.2 s. The port's smokes
share this one copy, and each takes the ranks' device:

* ``cuda``: every rank mines on the card (the CUDA sweep behind
  ``ResilientBackend``); with no card the smoke fails at once with the
  port's ``ConfigError``, before it spawns anything;
* ``cpu``: every rank mines on the C++ sweep (``--backend cpu``), the
  reference's form.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

DEVICES = ("cuda", "cpu")
#: The ladder rung a rank on each device mines on (its summary's ``rung``).
RUNG = {"cuda": "cuda:cuda", "cpu": "cpu"}
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
#: The ranks' shard flush interval (the reference's smokes use 0.2 s).
RANK_FLUSH_S = "0.2"


def check_device(device: str) -> None:
    """Raises ``ConfigError`` when the ranks are to mine on the card and
    there is none: a smoke asked for the card never goes on elsewhere."""
    if device == "cuda":
        from ..backend.cuda import resolve_device
        resolve_device("cuda")


def device_args(device: str) -> list[str]:
    """``mine`` flags that put a rank on ``device``."""
    return ["--backend", "cpu"] if device == "cpu" else []


def spawn_rank(rank: int, world: int, obs_dir, argv, device: str,
               extra_env: dict | None = None,
               entry: list[str] | None = None) -> subprocess.Popen:
    """Starts one rank: ``mine --mesh-obs obs_dir`` on ``device`` with the
    extra ``argv``, stdout and stderr piped. ``entry`` replaces the
    interpreter arguments that run the CLI (``-m
    mpi_blockchain_tpu_torch``): a caller may wrap ``cli.main``."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(REPO_ROOT), os.environ.get("PYTHONPATH"))
               if p),
           "MPIBT_MESH_RANK": str(rank),
           "MPIBT_MESH_WORLD": str(world),
           "MPIBT_MESH_OBS_INTERVAL": RANK_FLUSH_S,
           **(extra_env or {})}
    cmd = [sys.executable,
           *(entry or ["-m", "mpi_blockchain_tpu_torch"]), "mine",
           *device_args(device), "--mesh-obs", str(obs_dir), *argv]
    return subprocess.Popen(cmd, env=env, cwd=str(REPO_ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def reap(procs) -> None:
    """Kills and waits for every rank still running: no exit path of a
    smoke leaves a rank mining into a directory being removed."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def rung_fault(rank: int, device: str, shard: dict, out: str | None = None,
               retries: int = 0) -> str | None:
    """Why a rank did not mine on ``device``'s rung throughout, or None.
    ``out`` is the rank's stdout, whose last line is its ``mine`` summary
    (None for a rank that was killed): it must name ``RUNG[device]`` and
    no step-down. Its shard must count no step-down
    (``backend_degradations_total``) and exactly ``retries`` retries, the
    ones its fault plan causes."""
    if out is not None:
        lines = out.strip().splitlines()
        summary = json.loads(lines[-1]) if lines else {}
        if summary.get("rung") != RUNG[device] or summary.get("degraded"):
            return (f"rank {rank} mined on {summary.get('rung')} (degraded "
                    f"to {summary.get('degraded_to')}), not {RUNG[device]}")
    registry = shard.get("registry", {})
    steps = sum(m["value"] for m in
                registry.get("backend_degradations_total", []))
    tried = sum(m["value"] for m in registry.get("retries_total", []))
    if steps or tried != retries:
        return (f"rank {rank}: {steps:g} step-downs and {tried:g} retries, "
                f"not 0 and {retries}")
    return None
