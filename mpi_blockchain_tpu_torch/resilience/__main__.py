"""CLI: ``python -m mpi_blockchain_tpu_torch.resilience {smoke,plan}``.

``smoke`` drives the port's resilience through its real CLI, in two
phases (the reference's ``smoke_kill_resume`` and ``smoke_degradation``):

1. **Kill + resume.** A miner subprocess that checkpoints every block is
   SIGKILLed mid-run; the resume must load the last atomic checkpoint,
   mine on to the target and verify, and, after a deliberate tear of the
   checkpoint's tail, truncate to the last valid block and mine on again.
   The subprocess's dispatch site hangs at its sixth call (a real sleep of
   ``KILL_HANG_S``), so the kill always lands within the first few blocks,
   whatever the device's speed.
2. **Step-down.** A fault plan kills every ``backend.cuda.dispatch``; the
   ladder must walk down to ``cpu`` and still converge with rc 0 on the
   chain the C++ sweep mines (``--backend cpu``).

``--device cpu`` (the default here) runs both on the CPU; ``--device cuda``
on the card. The reference's third phase, ``smoke_determinism``, drives the
simulation, which is not ported yet.

``plan --seed N`` prints the plan ``--fault-plan seed:N`` would arm.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading

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


def smoke_kill_resume(tmp: pathlib.Path, device: str = "cpu",
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
    # A miner that never logs three blocks is killed all the same.
    watchdog = threading.Timer(KILL_TIMEOUT_S, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            if '"block_mined"' in line:
                mined += 1
                if mined >= 3:
                    break
    finally:
        watchdog.cancel()
        proc.kill()
        proc.stdout.close()
        proc.wait(timeout=60)
    assert mined >= 3, "miner died before mining 3 blocks"
    height = json.loads(ck.with_suffix(".bin.json").read_text())["height"]
    # The kill can land between a block's log line and its save:
    # --checkpoint-every 1 loses at most one block.
    assert mined - 1 <= height < blocks, (mined, height)
    # (a) Straight resume: the atomic writer left the checkpoint whole.
    out_path = tmp / "resumed.bin"
    rc, out = _run_cli(["mine", "--difficulty", str(difficulty),
                        "--blocks", str(blocks), *dev_args,
                        "--resume", str(ck), "--out", str(out_path)])
    assert rc == 0 and out["height"] == blocks, (rc, out)
    rc, verdict = _run_cli(["verify", "--chain", str(out_path),
                            "--difficulty", str(difficulty)])
    assert rc == 0 and verdict["valid"] is True, (rc, verdict)
    # (b) Torn tail: rip the trailer and most of the last header off, as
    # a non-atomic writer's crash would; the resume truncates to the last
    # valid block and mines on.
    blob = ck.read_bytes()
    ck.write_bytes(blob[:-120])
    rc, torn = _run_cli(["mine", "--difficulty", str(difficulty),
                         "--blocks", str(height + 1), *dev_args,
                         "--resume", str(ck)])
    assert rc == 0 and torn["height"] == height + 1, (rc, torn)
    from ..telemetry.events import recent_events
    truncs = recent_events(event="checkpoint_truncated")
    assert truncs and truncs[-1]["height"] == height - 1, truncs
    return {"mined_before_kill": mined, "checkpoint_height": height,
            "resumed_to": out["height"], "tip_hash": out["tip_hash"],
            "verified": verdict["valid"],
            "torn_truncated_to": truncs[-1]["height"],
            "torn_resumed_to": torn["height"]}


def smoke_degradation(tmp: pathlib.Path, device: str = "cpu") -> dict:
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
        got = smoke_kill_resume(tmp, device=args.device)
        print(f"smoke: kill+resume ok {json.dumps(got, sort_keys=True)}",
              flush=True)
        got = smoke_degradation(tmp, device=args.device)
        print(f"smoke: step-down ok (rung {got['degraded']['rung']}, tip "
              f"{got['degraded']['tip_hash']} == the cpu oracle's)",
              flush=True)
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
        description="resilience gate: kill+resume recovery and the "
                    "step-down ladder, through the port's CLI")
    sub = parser.add_subparsers(dest="command", required=True)
    p_smoke = sub.add_parser("smoke", help="run the resilience smoke")
    p_smoke.add_argument("--device", choices=("cpu", "cuda"),
                         default="cpu")
    p_smoke.set_defaults(fn=cmd_smoke)
    p_plan = sub.add_parser("plan", help="print the plan --fault-plan "
                                         "seed:N would arm")
    p_plan.add_argument("--seed", type=int, default=0)
    p_plan.add_argument("--faults", type=int, default=3)
    p_plan.set_defaults(fn=cmd_plan)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
