"""CLI: python -m mpi_blockchain_tpu_torch.chainwatch {smoke}

The port's copy of the reference's chainwatch smoke, pinning both sides
of the watchdog contract end to end in real processes:

* **Detection** — a 4-rank ``--mesh-obs`` world where one rank runs
  under a deterministic fault plan (two consecutive injected raises at
  its search site) must produce EXACTLY the expected incident: the
  injected faults and their retries are a 4-event burst, so with the
  storm threshold lowered to 3 the faulted rank fires ``event_storm`` —
  once (debounce + hysteresis), non-fatally (the retry ladder absorbs the
  faults; every rank still exits 0), with a complete evidence bundle
  (``BUNDLE_KEYS``) on disk and the open incident carried by the rank's
  final shard into the merged mesh view.

* **False-positive pin** — the same world, same difficulty, no fault
  plan, must produce ZERO incidents: no bundle, no ``incident`` event, no
  ``incidents_total`` series in any shard.

In both legs every rank mines on the device's rung with no step-down and
no retry but the two the plan causes.

The ranks mine on the card unless ``--device cpu`` asks for the C++
sweep. The faulted site is the rung that runs: ``backend.cuda.dispatch``
on the card, ``backend.cpu.search`` on the C++ sweep (the reference's).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..config import ConfigError
from ..meshwatch.world import DEVICES

#: The smoke's ranks, the faulted one, and every rank's chain.
WORLD, VICTIM = 4, 2
CHAIN = ("--difficulty", "8", "--blocks", "6")
#: The faulted rank's search site, by device, and the retries its two
#: injected raises cost.
FAULT_SITE = {"cuda": "backend.cuda.dispatch", "cpu": "backend.cpu.search"}
FAULTED_RETRIES = 2


def _run_world(obs: str, device: str, faulted_rank: int | None,
               fault_extra: tuple = (),
               fault_env: dict | None = None) -> str | None:
    """Run the world to completion; every rank must exit 0 (the
    watchdog is non-fatal by contract) on the device's rung, with no
    step-down and no retry but the faulted rank's two. Returns an error
    string."""
    from ..meshwatch.aggregate import read_shards
    from ..meshwatch.world import reap, rung_fault, spawn_rank

    procs, outs = {}, {}
    try:
        for r in range(WORLD):
            faulted = r == faulted_rank
            procs[r] = spawn_rank(
                r, WORLD, obs, [*CHAIN, *(fault_extra if faulted else ())],
                device, extra_env=fault_env if faulted else None)
        for r, p in procs.items():
            outs[r], err = p.communicate(timeout=180)
            if p.returncode != 0:
                return (f"rank {r} exited rc={p.returncode} "
                        f"(the watchdog must be non-fatal): {err[-800:]}")
    finally:
        reap(procs.values())
    for shard in read_shards(obs):
        r = shard["rank"]
        fault = rung_fault(r, device, shard, outs.get(r),
                           retries=FAULTED_RETRIES if r == faulted_rank
                           else 0)
        if fault:
            return fault
    return None


def cmd_smoke(args) -> int:
    """Exact detection + the zero-false-positive pin."""
    import tempfile

    from ..meshwatch.aggregate import mesh_incidents, read_shards
    from ..meshwatch.world import check_device
    from .incident import BUNDLE_KEYS

    check_device(args.device)
    victim = VICTIM
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        # ---- leg 1: the faulted world must yield EXACTLY one incident.
        obs = str(tmp / "mesh_faulted")
        inc_dir = tmp / "incidents"
        plan = tmp / "plan.json"
        # Calls 2 and 3 of the victim's search site raise: 2 injected
        # faults + 2 retries = a 4-event burst the lowered storm
        # threshold (3 within a wide window) must catch; attempt 3 of
        # the retry ladder succeeds, so the run converges and exits 0.
        plan.write_text(json.dumps({
            "version": 1, "strict": True,
            "faults": [{"site": FAULT_SITE[args.device], "kind": "raise",
                        "call": 2, "times": 2}]}))
        err = _run_world(
            obs, args.device, faulted_rank=victim,
            fault_extra=("--fault-plan", str(plan),
                         "--incident-dir", str(inc_dir)),
            fault_env={"MPIBT_CHAINWATCH_STORM_N": "3",
                       "MPIBT_CHAINWATCH_STORM_WINDOW": "60"})
        if err:
            print(f"incident-smoke: {err}", file=sys.stderr)
            return 1
        shards = read_shards(obs)
        incidents = mesh_incidents(shards)
        if [(i["rank"], i["rule"]) for i in incidents] != \
                [(victim, "event_storm")]:
            print(f"incident-smoke: expected exactly one event_storm "
                  f"incident on rank {victim}, got "
                  f"{[(i.get('rank'), i.get('rule')) for i in incidents]}",
                  file=sys.stderr)
            return 1
        inc = incidents[0]
        if inc["severity"] != "warn" or inc["incident_seq"] != 1:
            print(f"incident-smoke: wrong incident identity: {inc}",
                  file=sys.stderr)
            return 1
        bundles = sorted(inc_dir.glob("incident_*.json"))
        if [b.name for b in bundles] != ["incident_0001_event_storm.json"]:
            print(f"incident-smoke: expected exactly one bundle, got "
                  f"{[b.name for b in bundles]}", file=sys.stderr)
            return 1
        bundle = json.loads(bundles[0].read_text())
        missing = set(BUNDLE_KEYS) - set(bundle)
        if missing:
            print(f"incident-smoke: bundle incomplete, missing "
                  f"{sorted(missing)}", file=sys.stderr)
            return 1
        if (bundle["artifact"] != "incident"
                or bundle["rule"] != "event_storm"
                or bundle["reason"] != "incident:event_storm"
                or bundle["detail"].get("events", 0) < 3
                or not any(e.get("event") == "fault_injected"
                           for e in bundle["events"])):
            print(f"incident-smoke: bundle evidence wrong: "
                  f"rule={bundle['rule']!r} reason={bundle['reason']!r} "
                  f"detail={bundle['detail']}", file=sys.stderr)
            return 1
        # The signal must also have reached the metric + event surfaces
        # of the faulted rank's shard.
        vshard = next(s for s in shards if s["rank"] == victim)
        totals = vshard["registry"].get("incidents_total", [])
        if sum(m["value"] for m in totals) != 1 or not any(
                m["labels"] == {"rule": "event_storm", "severity": "warn"}
                for m in totals):
            print(f"incident-smoke: incidents_total wrong: {totals}",
                  file=sys.stderr)
            return 1
        if not any(e.get("event") == "incident"
                   and e.get("rule") == "event_storm"
                   for e in vshard["events_tail"]):
            print("incident-smoke: incident event missing from the "
                  "faulted rank's event tail", file=sys.stderr)
            return 1

        # ---- leg 2: the clean fixed-seed world must yield ZERO.
        obs_clean = str(tmp / "mesh_clean")
        err = _run_world(obs_clean, args.device, faulted_rank=None)
        if err:
            print(f"incident-smoke: clean leg: {err}", file=sys.stderr)
            return 1
        clean_shards = read_shards(obs_clean)
        if len(clean_shards) != WORLD:
            print(f"incident-smoke: clean leg wrote "
                  f"{len(clean_shards)}/{WORLD} shards", file=sys.stderr)
            return 1
        false_pos = mesh_incidents(clean_shards)
        if false_pos:
            print(f"incident-smoke: FALSE POSITIVE on a clean run: "
                  f"{false_pos}", file=sys.stderr)
            return 1
        for s in clean_shards:
            if s["registry"].get("incidents_total") or any(
                    e.get("event") == "incident"
                    for e in s["events_tail"]):
                print(f"incident-smoke: clean rank {s['rank']} carries "
                      f"incident residue", file=sys.stderr)
                return 1

    print(json.dumps({"event": "incident_smoke", "ok": True,
                      "incident_rule": inc["rule"],
                      "incident_rank": inc["rank"],
                      "bundle_keys": len(bundle),
                      "clean_incidents": 0}, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.chainwatch",
        description="live watchdog: the multi-rank smoke")
    sub = parser.add_subparsers(dest="command", required=True)
    p_smk = sub.add_parser(
        "smoke",
        help="a fault-injected 4-rank world must yield exactly the "
             "expected incident (complete bundle), a clean run zero")
    p_smk.add_argument("--device", choices=DEVICES, default="cuda",
                       help="where the ranks mine: the CUDA sweep on the "
                            "card, or the C++ sweep; the CPU only when "
                            "asked for")
    p_smk.set_defaults(fn=cmd_smoke)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ConfigError as e:
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2


if __name__ == "__main__":
    sys.exit(main())
