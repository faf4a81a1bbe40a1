"""Mines one chain with the pipelined ``Miner`` through each form of the
``search_async`` seam, in turns, on one NVIDIA GPU.

    python -m mpi_blockchain_tpu_torch.tools.dispatch_variants

The forms (``FORMS``, built by ``make_backend``):

* ``shipped``: ``ResilientBackend`` as it is: the sweep is launched when
  the driver issues it, and the thread that consumes the dispatch reads it
  back, re-validates it and retries;
* ``raw``: the raw CUDA backend (``resilient=False``), whose
  ``search_async`` is synchronous;
* ``worker``: the reference's form, the whole search (launch included)
  submitted to one dispatch worker thread;
* ``finish_on_worker``: the launch on the issuing thread, the read-back,
  re-validation and retries on one worker thread;
* ``poll_20us`` and ``poll_yield``: ``shipped`` with the wait for the
  sweep on the card polled in sleeps of 20 us, or in ``time.sleep(0)``,
  between two queries (``resilience.dispatch.POLL_S``), where the shipped
  poll queries again at once;
* ``unbounded``: ``shipped`` with no ``MPIBT_DISPATCH_TIMEOUT``: the
  consume blocks in the read-back, unpolled (the form before the bound).

``--forms`` picks a subset.

Each round runs every form once, in reverse order every other round. For
each run it prints the wall, the sweeps' CUDA-event time, the kernel share
and the host time a block (wall minus sweeps, over the blocks). Every run
must end at the same tip. The last line is one JSON object with every
number, the card's name and power limit beside them.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import statistics
import subprocess
import sys
import time

import torch

from ..backend import MinerBackend, backend_from_config
from ..config import MinerConfig
from ..models import miner as miner_mod
from ..models.miner import Miner
from ..ops import sha256_cuda
from ..resilience import dispatch

FORMS = ("shipped", "raw", "worker", "finish_on_worker", "poll_20us",
         "poll_yield", "unbounded")
#: The module settings each form runs under (``shipped``'s otherwise).
SETTINGS = {"poll_20us": {"POLL_S": 20e-6}, "poll_yield": {"POLL_S": 0.0},
            "unbounded": {"DISPATCH_TIMEOUT_S": None}}


def make_backend(form: str, config: MinerConfig,
                 worker: concurrent.futures.Executor) -> MinerBackend:
    """The backend of one form; ``worker`` (one thread) runs what the form
    hands to a worker."""
    if form == "raw":
        return backend_from_config(config, resilient=False)
    backend = backend_from_config(config)
    if form == "worker":
        backend.search_async = functools.partial(worker.submit,
                                                 backend.search)
    elif form == "finish_on_worker":
        def search_async(header80, difficulty_bits, start_nonce=0,
                         max_count=1 << 32):
            args = (header80, difficulty_bits, start_nonce, max_count)
            with backend._lock:
                launched = backend._launch(args)
            return worker.submit(backend._resolve, launched, args)
        backend.search_async = search_async
    elif form not in FORMS:
        raise ValueError(f"unknown form {form!r}; known: {FORMS}")
    return backend


def run_form(form: str, config: MinerConfig) -> dict:
    """One chain through ``form``, under its settings (``SETTINGS``)."""
    settings = SETTINGS.get(form, {})
    saved = {"POLL_S": dispatch.POLL_S,
             "DISPATCH_TIMEOUT_S": miner_mod.DISPATCH_TIMEOUT_S}
    dispatch.POLL_S = settings.get("POLL_S", saved["POLL_S"])
    miner_mod.DISPATCH_TIMEOUT_S = settings.get(
        "DISPATCH_TIMEOUT_S", saved["DISPATCH_TIMEOUT_S"])
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as worker:
            backend = make_backend(form, config, worker)
            return timed_chain(Miner(config, backend=backend,
                                     pipeline=True))
    finally:
        dispatch.POLL_S = saved["POLL_S"]
        miner_mod.DISPATCH_TIMEOUT_S = saved["DISPATCH_TIMEOUT_S"]


def timed_chain(miner: Miner) -> dict:
    """Mines ``miner``'s chain with CUDA events around every sweep launch;
    returns the wall, the sweeps' time, the launches and the tip."""
    events, launch = [], sha256_cuda.launch

    def timed_launch(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        launch(*args, **kwargs)
        ev[1].record()
        events.append(ev)

    sha256_cuda.launch = timed_launch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miner.mine_chain()
        wall = time.perf_counter() - t0
    finally:
        sha256_cuda.launch = launch
    torch.cuda.synchronize()
    return {"wall_s": wall,
            "sweeps_s": sum(a.elapsed_time(b) for a, b in events) / 1e3,
            "launches": len(events), "tip_hash": miner.node.tip_hash.hex()}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--difficulty", type=int, default=24)
    parser.add_argument("--blocks", type=int, default=1000)
    parser.add_argument("--batch-pow2", type=int, default=24)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--forms", nargs="+", choices=FORMS, default=FORMS)
    args = parser.parse_args(argv)
    forms = tuple(args.forms)
    if not torch.cuda.is_available():
        print("dispatch_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    config = MinerConfig(difficulty_bits=args.difficulty,
                         n_blocks=args.blocks, batch_pow2=args.batch_pow2,
                         backend="cuda", kernel="cuda", device="cuda")
    sha256_cuda.library()
    runs: dict[str, list[dict]] = {form: [] for form in forms}
    for r in range(args.rounds):
        for form in (forms if r % 2 == 0 else forms[::-1]):
            run = run_form(form, config)
            run["kernel_share"] = run["sweeps_s"] / run["wall_s"]
            run["host_ms_per_block"] = \
                (run["wall_s"] - run["sweeps_s"]) / args.blocks * 1e3
            runs[form].append(run)
            print(f"round {r} {form}: wall {run['wall_s']:.6f} s, sweeps "
                  f"{run['sweeps_s']:.6f} s, kernel share "
                  f"{run['kernel_share']:.4f}, host time a block "
                  f"{run['host_ms_per_block']:.4f} ms, {run['launches']} "
                  f"launches", flush=True)
    tips = {run["tip_hash"] for rs in runs.values() for run in rs}
    if len(tips) != 1:
        print(f"dispatch_variants: FAIL: the forms mined {len(tips)} "
              f"different tips", file=sys.stderr)
        return 1
    summary = {form: {"median_wall_s": statistics.median(
        run["wall_s"] for run in rs), **{key: [run[key] for run in rs]
                                          for key in rs[0]
                                          if key != "tip_hash"}}
               for form, rs in runs.items()}
    print(json.dumps({"card": card, "difficulty": args.difficulty,
                      "blocks": args.blocks, "batch_pow2": args.batch_pow2,
                      "tip_hash": tips.pop(), "forms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
