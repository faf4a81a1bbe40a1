"""CLI: python -m mpi_blockchain_tpu_torch.dispatchwatch {census,smoke}

The port's copy of the reference's dispatchwatch CLI, held to the port's
census (``dispatchwatch/__init__.py``: ``nvcc`` builds and library
``load``s at site ``ops.sha256_cuda``, first uses of k-block programs at
site ``fused``).

``census`` prints this process's compile census as JSON; ``--probe`` adds
the card's cost probe (``cost_probe``), which stands where the reference
cross-checks XLA's HLO flops against its committed op census: the built
library's loop instructions a nonce beside the source's adds and the
sweep's bound in SM clocks a nonce, with their ratio. Where the
disassembler cannot run, the probe reports ``{"error": ...}``.

``smoke`` is the compile gate, on the card (with no card it exits 2; it
does not carry on on the CPU):

1. a fixed-seed mine through the device seam (``CudaBackend`` behind
   ``ResilientBackend``), a sequential leg and then a pipelined leg, each
   with a fresh census, keeps the exactly-once contract (``_census_clean``)
   and has no recompile after warmup, judged through the perfwatch
   detector's ``compile_cache`` bound (<= 0) against the repo's history,
   which it reads and never writes;
2. chainwatch rides both legs armed: the clean mine fires no
   ``recompile_storm`` incident;
3. both legs mine byte-identical chains;
4. the cost probe is complete.
"""
from __future__ import annotations

import argparse
import json
import logging
import pathlib
import subprocess
import sys

#: The fixed smoke config, the reference's: every block's winner sits
#: within a few 2^12 rounds, and winners are a pure function of (prefix,
#: difficulty), so the census cannot drift per machine.
SMOKE_DIFFICULTY = 12
SMOKE_BLOCKS = 4
SMOKE_BATCH_POW2 = 12
SMOKE_PREFIX = "dispatch"
#: The probe's difficulty when none is asked for: the main path's.
PROBE_DIFFICULTY = 24


def cost_probe(difficulty_bits: int = PROBE_DIFFICULTY) -> dict:
    """The card's cost probe: the built library's main loop of the kernel
    serving ``difficulty_bits`` (``sha256_cuda.loop_census`` of its
    ``cuobjdump -sass``), as instructions a nonce, beside the adds the
    source needs a nonce (``source_adds``), the bound that both give
    (``bound_sm_clocks_per_nonce``) and the build's own busiest-pipe
    figure (``sm_clocks_per_nonce``). ``instructions_over_adds`` is the
    loop's instructions over the source's adds. Raises what the build or
    the disassembler raises."""
    from ..ops import sha256_cuda

    census = sha256_cuda.loop_census(sha256_cuda.disassemble(),
                                     difficulty_bits)
    per_trip = sha256_cuda.NONCES_PER_TRIP
    instructions = sum(census.values()) / per_trip
    adds = sha256_cuda.source_adds(difficulty_bits)
    return {
        "kernel": "cuda",
        "difficulty_bits": difficulty_bits,
        "loop_instructions_per_nonce": instructions,
        "alu_only_per_nonce": sha256_cuda.alu_only_count(census) / per_trip,
        "source_adds": adds,
        "bound_sm_clocks_per_nonce": round(
            sha256_cuda.bound_sm_clocks_per_nonce(census, adds), 4),
        "build_sm_clocks_per_nonce": round(
            sha256_cuda.sm_clocks_per_nonce(census), 4),
        "instructions_over_adds": round(instructions / adds, 4),
    }


def probe_or_error(difficulty_bits: int = PROBE_DIFFICULTY) -> dict:
    """``cost_probe``, or {"error": ...} when it cannot run (no ``nvcc``
    or ``cuobjdump``, a failed build or disassembly)."""
    try:
        return cost_probe(difficulty_bits)
    except (RuntimeError, ValueError, OSError,
            subprocess.SubprocessError) as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _backend(device: str) -> dict:
    """The ``MinerConfig`` fields of a leg on ``device``: the device seam
    (``CudaBackend``) on the card, the C++ sweep for "cpu", as the port's
    other smokes read ``--device cpu``."""
    if device == "cpu":
        return {"backend": "cpu"}
    return {"backend": "cuda", "device": device}


def _mine_leg(pipeline: bool, device: str = "cuda") -> dict:
    """One fixed-seed mine on ``device`` (``_backend``) with a fresh
    census and an armed chainwatch; returns the leg's census, incident
    verdicts and whether the library was loaded before the leg began."""
    from .. import chainwatch
    from ..config import MinerConfig
    from ..models.miner import Miner
    from ..ops.sha256_cuda import library_loaded
    from . import clear_compiles, compile_census, recompiles

    loaded = library_loaded()
    clear_compiles()
    chainwatch.install()
    try:
        cfg = MinerConfig(difficulty_bits=SMOKE_DIFFICULTY,
                          n_blocks=SMOKE_BLOCKS, batch_pow2=SMOKE_BATCH_POW2,
                          data_prefix=SMOKE_PREFIX, **_backend(device))
        miner = Miner(cfg, pipeline=pipeline)
        miner.mine_chain()
        chainwatch.evaluate(source="compile-smoke", force=True)
        storms = [i for i in chainwatch.open_incidents()
                  if i.get("rule") == "recompile_storm"]
        census = compile_census()
        return {
            "census": census,
            "recompiles": recompiles(census),
            "storm_incidents": len(storms),
            "chain": miner.chain_hashes(),
            "loaded_before": loaded,
            "rung": getattr(miner.backend, "rung", miner.backend.name),
        }
    finally:
        chainwatch.uninstall()


def measure_compile_census(device: str = "cuda") -> dict:
    """The ``compile_cache`` bench payload: both legs' censuses, the
    section headline ``recompiles_after_warmup`` (pipelined leg, bounded
    at 0 by ``detector.SECTION_BOUNDS``), the determinism contract and
    the cost probe (at the smoke's difficulty)."""
    seq = _mine_leg(False, device)
    pip = _mine_leg(True, device)
    return {
        "backend": _backend(device)["backend"],
        "difficulty_bits": SMOKE_DIFFICULTY,
        "n_blocks": SMOKE_BLOCKS,
        "batch_pow2": SMOKE_BATCH_POW2,
        # The section headline, bounded by SECTION_BOUNDS (<= 0).
        "recompiles_after_warmup": pip["recompiles"],
        "recompiles_sequential": seq["recompiles"],
        "sites": pip["census"],
        "sites_sequential": seq["census"],
        "loaded_before": [seq["loaded_before"], pip["loaded_before"]],
        "rungs": [seq["rung"], pip["rung"]],
        "storm_incidents": seq["storm_incidents"] + pip["storm_incidents"],
        "chain_identical": seq["chain"] == pip["chain"],
        "cost": probe_or_error(SMOKE_DIFFICULTY),
    }


def _census_clean(census: dict, loaded_before: bool) -> bool:
    """The exactly-once contract for one leg of the port's census.

    The kernel library is built (``nvcc``, only when the library is
    missing or older than its source) and loaded once per process, so
    what a leg sees at site ``ops.sha256_cuda`` depends on whether the
    library was loaded before the leg began:

    * not loaded: the device seam compiled in this leg, which is exactly
      one ``load`` and at most one ``nvcc`` build;
    * loaded: nothing at all, no ``load`` and no ``nvcc``.

    A second build or a second load fails either way. Every site that
    reported a cache (the fused miner's k-block programs) holds compiles
    == cache_entries."""
    from ..ops.sha256_cuda import COMPILE_SITE

    stages = census.get(COMPILE_SITE, {}).get("stages", {})
    loads, builds = stages.get("load", 0), stages.get("nvcc", 0)
    if loaded_before:
        if loads or builds:
            return False
    elif loads != 1 or builds > 1:
        return False
    return all(st["compiles"] == st["cache_entries"]
               for st in census.values() if st.get("cache_entries"))


def cmd_smoke(args) -> int:
    """See the module docstring: the compile gate."""
    from ..backend.cuda import resolve_device
    from ..perfwatch.detector import check_candidate
    from ..perfwatch.history import DEFAULT_HISTORY_NAME, HistoryStore
    from ..utils.logging import get_logger

    resolve_device("cuda")          # no card: a clean ConfigError
    get_logger().setLevel(logging.WARNING)
    repo_root = pathlib.Path(__file__).resolve().parent.parent.parent
    store = HistoryStore(repo_root / DEFAULT_HISTORY_NAME)
    payload = measure_compile_census("cuda")
    finding = check_candidate(store, "compile_cache", payload)
    # None of this is weather: a recompile, a storm incident, a chain
    # divergence or a missing probe is a real defect, failed on one read.
    if finding.verdict == "regression":
        print(f"compile-smoke: recompiles over budget: "
              f"{finding.render()}", file=sys.stderr)
        return 1
    for leg, census, loaded in (
            ("sequential", payload["sites_sequential"],
             payload["loaded_before"][0]),
            ("pipelined", payload["sites"], payload["loaded_before"][1])):
        if not _census_clean(census, loaded):
            print(f"compile-smoke: {leg} census not exactly-once "
                  f"(library loaded before the leg: {loaded}): "
                  f"{json.dumps(census, sort_keys=True)}", file=sys.stderr)
            return 1
    if payload["rungs"] != ["cuda:cuda", "cuda:cuda"]:
        print(f"compile-smoke: a leg left the card's kernel: "
              f"{payload['rungs']}", file=sys.stderr)
        return 1
    if payload["storm_incidents"]:
        print(f"compile-smoke: clean mine fired "
              f"{payload['storm_incidents']} recompile_storm "
              f"incident(s)", file=sys.stderr)
        return 1
    if not payload["chain_identical"]:
        print("compile-smoke: pipelined chain diverged from the "
              "sequential leg", file=sys.stderr)
        return 1
    cost = payload["cost"]
    if cost.get("loop_instructions_per_nonce", 0) <= 0 or \
            "instructions_over_adds" not in cost:
        print(f"compile-smoke: cost probe incomplete: "
              f"{json.dumps(cost, sort_keys=True)}", file=sys.stderr)
        return 1
    print(json.dumps({
        "event": "compile_smoke", "ok": True,
        "recompiles_after_warmup": payload["recompiles_after_warmup"],
        "compiles": {site: st["compiles"]
                     for site, st in payload["sites"].items()},
        "stages": {site: st["stages"]
                   for site, st in payload["sites_sequential"].items()},
        "loaded_before": payload["loaded_before"],
        "rungs": payload["rungs"],
        "storm_incidents": payload["storm_incidents"],
        "chain_identical": payload["chain_identical"],
        "cost": cost,
        "verdict": finding.verdict,
    }, sort_keys=True))
    return 0


def cmd_census(args) -> int:
    from . import compile_snapshot

    out = {"event": "dispatchwatch_census",
           "compiles": compile_snapshot()}
    if args.probe:
        out["cost"] = probe_or_error()
    print(json.dumps(out, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    from ..config import ConfigError

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.dispatchwatch",
        description="compile census of the port: nvcc builds, library "
                    "loads and k-block programs")
    sub = parser.add_subparsers(dest="command", required=True)

    p_cen = sub.add_parser("census", help="this process's compile "
                                          "census as JSON")
    p_cen.add_argument("--probe", action="store_true",
                       help="also run the card's cost probe (builds the "
                            "kernel library and disassembles its loop)")
    p_cen.set_defaults(fn=cmd_census)

    p_smk = sub.add_parser("smoke", help="the compile gate on the card: "
                                         "fixed-seed mine -> exactly-once "
                                         "census")
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
