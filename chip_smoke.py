#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from the sources in this checkout (the C++
chain core with g++, the CUDA kernels with nvcc, both started at once),
then:

1. holds the hand-written sweep kernel against its plain PyTorch version
   on the same card, bit for bit, at every difficulty class boundary, at
   the edges of the nonce space and at the edges of the kernel's slices
   (two winners in different slices, a count that is not a multiple of
   the slice, a winner in the first slice and one in the last, ragged
   slice ending at 2^32);
2. holds the CUDA backend against the CPU backend and the C++
   ``cpu_search`` on random headers, starts and ranges;
3. mines the chains the reference pinned in PERF_HISTORY.jsonl through the
   port's entry points (``mine`` d20/n10/b20 through the CLI, d16/n30, and
   the full-size d24/n1000 at batch 2^24 through the pipelined ``Miner``)
   and checks their tips, with the kernel's launches counted over the
   d24 run;
4. times the kernel at the main path's launch shape (one early-exit
   launch over the whole nonce space at dbits 24), beside a full sweep of
   exactly the nonces that launch needs, and at a full 2^24 sweep, against
   the plain version and the bound from the function's work (the compiled
   loop's ALU-only instructions and the source's adds), and counts the
   nonces the early exit hashes past the winner over OVERSHOOT_LAUNCHES
   launches against one slice per resident warp (the median must stay
   within it; the tail is printed); and, in the same turns as the 2^24
   sweep, the sweep that reads the extended midstate from the library's
   ``__constant__`` symbol, with the registers and blocks per SM of both;
5. drives the fused k-block miner (``mine --fused``): its step kernel
   against the plain step on the card, bit for bit, over seeded
   prev/data/height and the sentinel nonce and over the edge cases
   (``step_edge_cases``: prev words all-zero and all-ones, heights 0 and
   0xFFFFFFFF, bits 0, 24 and 64, nonces 0 and 0xFFFFFFFF); whole k-block
   calls (``mine_k``) at k 1, 2 and 6 and caps 2^12 and 2^32 against
   ``mine_k_plain``; the constant-ext sweep against the by-value sweep at
   the slice edges; the step kernel's time three ways (launches enqueued
   back to back in one call, the body's SM clocks from the measuring
   build's clock stamps, and a Python loop apart), with its compiled
   instructions and ptxas's registers, stack and spills; then the pinned
   d16/n30 (16 blocks a call) and d24/n1000 (100 a call) through
   ``FusedMiner``, their tips against the pins, with the sweep and step
   launches, the host waits per call and PyTorch's count of hidden syncs,
   the wall beside the pipelined ``Miner``'s of phase 3, and, in a second
   run with CUDA events around each sweep and after each step, the sweeps'
   share of the wall, the per-block device gaps within a call
   (``block_gaps``: median, 90th percentile, max), split into the step and
   the symbol copy, and the rest of the wall;
6. drives the resilience layer on the card: (a) the pipelined ``Miner`` at
   d24/n1000 behind ``ResilientBackend`` (its ``search_async`` launches at
   once and reads back when the driver consumes the sweep) and on the raw
   backend (a synchronous ``search_async``), in turns, with the wall, the
   sweeps' CUDA-event time, the kernel share and the host time per block
   of each; (b) a plan that
   kills every ``backend.cuda.dispatch`` (d8/n2/b11) steps down to ``cpu``
   with rc 0 and the ``--backend cpu`` oracle's tip; (c) a ``corrupt``
   winner at the first dispatch is retried once and the run stays on
   ``cuda:cuda`` with the pinned d20/n10 tip; (d) a ``mine`` subprocess with
   no ``nvcc`` exits 2 with a JSON error naming it, with no retry and no
   step-down in its metrics; (e) a d20 ``mine --checkpoint-every 1`` on the
   card is SIGKILLed, resumed to 10 blocks and verified, at the pinned tip;
   (a) also prints each run's host time a block by span (``miner.block``,
   ``miner.sweep``, ``miner.append``, ``backend.cuda.dispatch``,
   ``backend.cuda.host_tail``, from ``span_seconds``) and the host time
   of the ``Miner``'s per-block telemetry with the kill switch off and on
   (``telemetry_us_per_block``); (f) an early-exit
   sweep of [0, 2^32) at dbits 64 (it runs its whole length, about half a
   second) consumed by the pipelined ``Miner`` with a 0.05 s
   ``MPIBT_DISPATCH_TIMEOUT`` raises "dispatch wedged" within a few times
   the budget, and a search launched after it returns the C++ sweep's
   winner;
7. the bench (``bench_lib``): the sweep rate at 2^28 a call for
   BENCH_SECONDS with 1 and 8 logical miners (``hashes_per_sec``,
   ``kernel_ms``, ``bound_ms``), the chain mode at d24/n1000/b24, 100
   blocks a call, best of 2 with its spread (``repeat_best``), the d16/n30
   ``bench_sharded`` cell and the d20/n10 ``bench_cuda_single`` cell, each
   tip against its pin and the C++ oracle's;
8. winner-select: ``mine --preset tpu-mesh8`` (d24/n1000/b20, 8 logical
   miners) through the pipelined ``Miner`` and through ``--fused
   --blocks-per-call 100``, tips against the d24/n1000 pin, the summed
   ``hashes_tried`` against the reference's accounting at rounds of 2^23
   over the chain's nonces, launches counted; and two processes sharing
   the card over gloo (``mine --coordinator``, d20/n10/b20): both ranks
   reach the pinned tip, rank 0 alone writes the chain, the wall beside
   the single process's of phase 3.
9. the adversarial simulation, BASELINE config 5, through ``sim``: (a)
   ``sim --preset adversarial`` (d16, 20 blocks, 2 groups, 2^8 nonces a
   search) against the reference's pinned tips, steps, heights, stats and
   causal dump, not degraded, one sweep launch per search (so every group
   searched on ``cuda:cuda``), with its wall, host ms a search, the
   dispatch and host-tail spans, the same run on ``--backend cpu``, and
   the search shape's time a launch on the card (``sim_search_shape``;
   null where the host could not keep the card's queue ahead); (b) the full-width
   run ``SIM_D24_ARGS`` (every search a 2^24 sweep; the groups fork and
   reorg) against its pin, with the sweeps' share of the wall; (c) the
   vectorized engine (``--preset adversarial-bench`` and
   ``bench_sim_adversarial``, best of 2) against the reference's pin, its
   steps per second host time; (d) the resilience smoke's
   ``smoke_determinism`` on the card and on the C++ sweep, both dumps
   byte-identical to the reference's; (e) a run that cannot converge
   (every delivery dropped): rc 1, the pinned ``sim_done`` line and dump,
   a flight-recorder dump with the causal logs; (f) the kernel at the
   budgets a group's search takes (``bounded_search_cases``) against the
   plain version and ``cpu_search``.
10. the blockserve front door (``serve``, ``mine --serve-metrics``): (a)
   the serve smoke (``python -m mpi_blockchain_tpu_torch.service smoke``)
   on the card at the reference's shape (d12, 6 blocks, seed 1337, pool
   cap 8, 4 transactions a template, batches of 10 and 16 requests, a 5 s
   deadline): a strict plan hangs ``service.submit``, raises at
   ``service.rebuild`` and raises at ``backend.cuda.dispatch`` for the
   second block's sweep and both its retries, so ``cuda:cuda`` steps down
   to ``cuda:torch`` and the door stamps ``degraded``; every request
   answers with a typed shed or a receipt, no accepted transaction is
   lost, admission is conserved, the chain equals a sequential replay of
   the door's templates on the C++ sweep, the kernel equals the plain
   sweep and ``cpu_search`` on the served headers, and the payload is
   inside the ``serve`` bound; (b) ``serve`` at full width (``SERVE_ARGS``: d24, 2^24,
   1000 blocks, the default door: pool cap 512, 16 transactions a
   template, 5 s deadline) while ``run_load`` streams ``SERVE_LOAD`` (seed
   1337, 2000 requests, 4 workers), in turns with the same run without
   load (``SERVE_TURNS``), and the same load against an idle door: every
   request answers, no accepted transaction is lost, the loaded chain
   equals a replay of its recorded per-height payloads through the
   sequential ``Miner`` on the card, the winners at two heights chosen
   from the seed are the lowest (``cpu_search`` over [0, winner]) and the
   kernel equals the plain sweep and ``cpu_search`` around them
   (``served_cases``), the quiet chains are the d24/n1000 pin; it prints requests/s, p99 and max
   latency, shed fraction, mempool high-water, transactions included, the
   walls with and without load, ``miner.sweep`` and
   ``backend.cuda.dispatch`` ms a block, and the speculative discards by
   reason; (c) ``mine --serve-metrics 0`` at the d20/n10/b20 pin: from
   inside the run (the ``_block_mined`` seam) ``/healthz`` answers 200
   with a fresh ``miner_heartbeat`` at block 5, and ``/metrics`` shows
   ``blocks_mined_total`` 10 and ``hashes_tried_total`` equal to the
   summary's ``hashes_tried`` at block 10.
11. per-block tracing on the main path (``blocktrace``,
   ``meshwatch.pipeline``, ``chainwatch``): (a) the d24/n1000/2^24
   pipelined ``Miner`` at the pin, traced and with the telemetry off
   (``MPIBT_TELEMETRY_OFF``'s kill switch) in turns (``TRACE_TURNS``):
   walls and host ms a block, and tracing's cost a block pair by pair
   (``tracing_cost``); for each traced run the ``pipeline`` object,
   ``critical_path_report`` over its records, complete for every height
   1..1000 with the gap under 5%, the union of its ``device`` segments
   (taken from the card's timing events) against the sweeps' CUDA-event
   sum (events recorded right around the library's call that launches
   each sweep, ``timed_library_calls``; it may not exceed it), and
   ``bubble_fraction`` against 1 - sweeps / wall (within 0.05); and the
   host cost of the sweep's timing events a
   launch (only a traced pipelined ``Miner`` asks for them) against the
   plain event every other launch records (``event_cost_us``); (b)
   ``mine --fused`` d24/n1000 at 100 blocks a call, traced: the pin, the
   ``pipeline`` object, one host wait a call and no hidden sync, the
   compile census with the k-block program built once, no ``nvcc`` build
   on the warm cache (and the startup build's count: 1 from a cold
   checkout); (c) ``mine --incident-dir`` at the d20/n10 pin with every
   block evaluated: no incident, bundle or ``incidents_total`` without a
   fault plan; with two consecutive injected ``backend.cuda.dispatch``
   raises and ``MPIBT_CHAINWATCH_STORM_N=3`` exactly one ``event_storm``,
   rc 0, the pin, one bundle holding every ``BUNDLE_KEYS`` key and a
   ``memory`` section from ``torch.cuda.memory_stats`` with bytes in use
   (the one-process form of the reference's ``chainwatch smoke``); (d)
   ``measure_trace_overhead`` on the card (the round a 2^24 sweep) within
   the reference's 3% bound, up to four reads as the reference's trace
   smoke takes them (``OVERHEAD_ATTEMPTS``), after a null read with both
   halves off (the estimator's zero), and ``measure_block_observe``
   within its 300 us bound.
12. mesh observability (``meshwatch``, ``meshprof.analyzer``): (a) ``mine``
   d24/n1000/2^24 through the pipelined ``Miner`` without and with
   ``--mesh-obs`` in turns (``MESH_OBS_TURNS``), with events around the
   library's call that launches each sweep: the pin, 1000 launches, walls
   and host ms a block, and the shard's cost (medians); each final shard
   ``finished``, its ``hashes_tried_total`` the summary's, ``cuda:0``
   memory watermarks, a pipeline tail that renders a report; the same for
   ``mine --fused --mesh-obs`` at 100 blocks a call (1000 sweeps, 1010
   steps); (e) two ``mine --mesh-obs`` processes over gloo at the d20/n10
   pin (phase 8's world): both shards under their ranks, every
   ``mesh.sweep`` round joined across both by ``analyze_skew`` with its
   ``max_skew_ms`` under ``SECTION_BOUNDS["collective_skew"]``, the
   compile census not divergent, and a ``MeshServer`` on the directory
   answering ``/healthz`` 200, ``/ranks`` both finished and a
   rank-labeled ``/metrics``; (b) to (d) ``python -m
   mpi_blockchain_tpu_torch.meshwatch smoke`` (four ranks on the card, the
   victim at d28 killed mid-run: exactly it reads stale),
   ``...chainwatch smoke`` (exactly one ``event_storm`` on the faulted
   rank with a complete bundle, none in the clean world) and
   ``...blocktrace smoke`` (two ranks, every height complete, both
   overhead bounds), each in a session of its own (``run_module``).
13. the elastic mesh and forensics (``resilience.elastic``,
   ``forensics``): (a) four ``mine --elastic --mesh-obs --events-dump``
   ranks at d20/n6/b20 under the seeded ``mesh.rank_death`` plan
   (``elastic_rank_death_world``), twice on the card and once on the C++
   sweep: the victim exits 137 with no final shard and no dump, every
   survivor evicts it at height 3, exits 0 on its rung with a chain the
   C++ node accepts, and its dump is byte-identical across the three
   worlds; the same world with no plan beside it, walls and each rank's
   sweep launches (``COUNTING_ENTRY``) and restripe discards printed; (b)
   the elastic smoke's SIGKILL world on the card: the survivors evict the
   killed rank for ``dead-shard`` (the oracle's ``evict``) while still
   mining, and each fires one ``stale_rank`` incident; (c) ``mine
   --elastic --miners 4`` at the d20/n10 pin with a
   ``parallel.collective`` fault: the logical miners shrink 4 -> 3, the
   tip is the pin, beside the same run without the fault; (d) ``python -m
   mpi_blockchain_tpu_torch.forensics --json --trace`` on 13 a's dump, on
   ``sim --preset adversarial`` run on the card and on the adversarial
   scenario preset: rc 0, every section, the attack audit exactly where
   the dump holds attacks, a trace row for every node; (e) ``python -m
   mpi_blockchain_tpu_torch.meshwatch skew-smoke`` with its ranks on the
   card, in a session of its own.
14. the perf sentinel's CLIs (``python -m mpi_blockchain_tpu_torch.perfwatch``,
   ``...dispatchwatch``, ``...telemetry``): (a) ``record
   --seed-bench-rounds`` into a temporary history (the reference's TPU
   records), then phase 7's card payloads (``sweep`` m8 and m1, ``chain``,
   ``sharded_pallas``, ``tpu_single``): no history key holds both a
   seeded entry and a card entry; ``check --json`` exits 0; the m1 sweep
   payload at 0.8 of its rate, judged with ``check --candidate``, exits 1
   and is not recorded, and once recorded ``check`` flags exactly one
   regression, on the card's key; (b) ``report``'s ``roofline`` (the
   newest card sweep against its bound) has ``bound_utilization_pct`` in
   (0, 100]; (c) ``perfwatch smoke`` on the card: rc 0, ``/healthz``
   healthy, the ``/metrics`` needles, sweep launches and every backend on
   ``cuda:cuda``, its span buckets logged; (d) the mesh views over 12 e's
   shards (two gloo ranks at the d20/n10 pin): ``critical-path --json``
   with every height complete and ``--trace``, ``mesh-skew --json`` under
   ``SECTION_BOUNDS["collective_skew"]``, ``incidents --json`` with none
   open, ``compiles --mesh-dir`` with per-rank totals, not divergent, and
   the card's cost probe, each CLI's JSON equal to the port's in-process
   function on the same shards; (e) ``dispatchwatch smoke`` (rc 0, the
   probe complete) and ``python -m mpi_blockchain_tpu_torch.telemetry
   --steps 3`` (rc 0, the ``metrics-smoke`` needles), each in a process of
   its own with its sweep launches counted.
15. the last of the reference's paths: (a) ``mine --fused
   --blocks-per-call 100`` as two gloo processes sharing the card at the
   d24/n1000/b24 pin (``gloo_world`` at ``FUSED_WORLD_CHAIN``): both ranks
   reach the pin, rank 0 alone writes the chain and the summary, each rank
   launches one sweep a round (the rounds the chain's winners need,
   ``world_rounds``) and a step a block and a call, and prints one
   ``block_mined`` a block; the wall beside phase 8's per-block world and
   phase 5's single-process fused run; (b) ``mine --profile DIR`` and
   ``mine --fused --profile DIR`` at the d20/n10 pin, each without and
   with the capture: the pin every time, the trace holds one
   ``sha256d_sweep_kernel`` event a sweep launch and one
   ``block_step_kernel`` event a step launch, each launched inside its
   form's host span (``trace_kernels``), and the ring one ``block_mined``
   a block; the walls with and without the capture; (c)
   ``graft_entry.dryrun_multichip(8)`` and ``entry()`` on the card print
   and give what they do on the CPU. (d) The ``block_mined`` records of
   (a) and (b) are the repair of the event stream; phases 6 a and 11 read
   its price.
16. static analysis and sanitizers on the card: (a) the port's chainlint,
   ``python -m mpi_blockchain_tpu_torch.analysis --audit-suppressions
   --json``, over this machine's tree (which has no jax, so it also
   proves the package imports none): rc 0, no finding, no stale
   suppression, every family timed; its notes (the sanitizer pass says
   whether compute-sanitizer could check here) are printed; (b) the
   sanitizer driver (``ops/csrc/sanitize_main.cu``, built with the
   kernels at the start) through ``python -m
   mpi_blockchain_tpu_torch.analysis.sanitizers``: its known answers hold
   on the card with no tool (both sweeps at dbits 16 and 24, by value and
   from the ext symbol, the step, the fused call and the queries), and
   under each of memcheck, racecheck, synccheck and initcheck that can
   check here: 0 errors, and the poisoned runs (a result buffer one word
   short under memcheck, one never reset under initcheck) reported. A
   tool that cannot check on this machine (its own "Device not
   supported") is said so on a line of its own, and each kernel's entry
   in the kernels line carries the verdicts.
17. the card-side censuses of the port's budgets, each mover's
   ``--check`` in a process of its own: (a) ``python -m
   mpi_blockchain_tpu_torch.analysis.transfer_budget --check``: the
   memcpy operations the profiler records for one search of the per-block
   path and for a k-block call of ``FusedMiner`` reproduce the committed
   ``traced`` section of ``analysis/TRANSFERBUDGET.json``; (b) ``...opbudget
   --check``: the SASS census of the sweep's main loop reproduces for
   every difficulty class (the nvcc release the committed one), logged
   with its ALU-only count beside the source's adds and the bound; (c)
   ``...shard_budget --check`` as a world of two gloo ranks sharing the
   card at the d20/n10 pin's round (phase 8's world): each rank's round
   of both world flavors issues the committed collectives.
18. the port's one-command gate on the card, ``python -m
   mpi_blockchain_tpu_torch.gate --device cuda --resolve``: every step of
   the plan (``gate.STEPS``; the counterpart of the reference's ``make
   check``) resolves, each command's arguments parsed by its module's own
   parser and nothing run; the plan is printed with the card's name and
   power limit. The whole gate (``make check-torch``) re-runs smokes that
   phases 6, 10, 12, 13, 14 and 17 run already, so it is not run here.

Every ``mine`` of phases 3, 6 and 8 and every ``sim`` of phase 9 goes
through the wrapper; the smoke fails on any retry or step-down that its
plan did not cause.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line; with no CUDA device it fails at once. It takes about
ten minutes on one NVIDIA H100, the builds included.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings

PINNED_TIPS = {   # PERF_HISTORY.jsonl, mined by the reference package
    (20, 10, 20):
        "000008584f3d49230531993ab565d6fd422b9199d8d3d0279a6b03e9c4b7f445",
    (16, 30, 20):
        "0000920e5985e6c7571d5094847875c2fa96ee43cff93294339fc12283597371",
    (24, 1000, 24):
        "000000cb3a6e7b2e520d7843bbea907d84a0ae2ecca7e882e689fad96d1cd3a5",
}
KERNEL_SOURCE = "mpi_blockchain_tpu_torch/ops/csrc/sha256d_sweep.cu"
REPLACES = "mpi_blockchain_tpu/ops/sha256_pallas.py:295"
# The fused miner's step kernel replaces the reference's jnp header build
# and winner digest (no Pallas kernel).
STEP_REPLACES = "mpi_blockchain_tpu/models/fused.py:89"
# Pinned chains mined by the fused miner, and the blocks of each call.
FUSED_RUNS = {(16, 30, 20): 16, (24, 1000, 24): 100}
STEP_CASES = 64
STEP_TIMED_LAUNCHES = 1000
M32 = 0xFFFFFFFF
# Edge cases of the step kernel (``step_edge_cases``) and the k-block calls
# held against the plain sequence.
STEP_EDGE_PREVS = (0, M32)          # every word of prev
STEP_EDGE_HEIGHTS = (0, M32)
STEP_EDGE_BITS = (0, 24, 64)
STEP_EDGE_NONCES = (0, M32)
STEP_CALL_KS = (1, 2, 6)
STEP_CALL_CAPS = (1 << 12, 1 << 32)
# The fused events run's per-block gap figures, in the step's kernel row.
GAP_KEYS = ("gap_ms", "gap_step_ms", "gap_copy_ms", "gaps_s", "rest_s")
NONCE_SPACE = 1 << 32
TIMED_NONCES = 1 << 24
TIMED_DBITS = 24
# Measuring launches at the main-path shape. The overshoot past the winner
# varies from launch to launch: warps of different blocks on one SM do not
# progress evenly (PERF.md), and a winner in a slow warp's slice is
# reported late.
OVERSHOOT_LAUNCHES = 101
# Phase 6 (a): the d24/n1000 Miner runs, in this order. The other forms of
# search_async are measured by ``tools/dispatch_variants.py``.
MINER_TURNS = ("wrapped", "raw", "raw", "wrapped")
# The spans whose seconds phase 6 (a) splits a block's host time into.
SPAN_NAMES = ("miner.block", "miner.sweep", "miner.append",
              "backend.cuda.dispatch", "backend.cuda.host_tail")
# Phase 6 (a): the calls that price the Miner's per-block telemetry.
TELEMETRY_CALLS = 20000
# Phase 6 (f): the consume budget of the wedged sweep.
WEDGE_BUDGET_S = 0.05
# Phase 7: the sweep bench's length and logical miners.
BENCH_SECONDS = 5.0
BENCH_MINERS = (1, 8)
# Phase 8: the tpu-mesh8 preset's round (8 miners x 2^20 nonces), and the
# chain the two-process world mines (the d20/n10/b20 pin).
MESH8_ROUND = 8 << 20
WORLD_ARGS = ("--difficulty", "20", "--blocks", "10", "--batch-pow2", "20")
REPO_ROOT = str(pathlib.Path(__file__).resolve().parent)
# Phase 9: the adversarial simulation (BASELINE config 5) through ``sim``.
# The pins come from one run each of the reference package with its C++ CPU
# backend; ``dump_sha256`` is the sha256 of the file ``--events-dump`` wrote:
#   (a) python -m mpi_blockchain_tpu sim --preset adversarial --events-dump
#       PATH, with PRESETS["adversarial"] set to backend="cpu" (the preset
#       names the TPU backend; 1.3 s on one CPU rank);
#   (b) python -m mpi_blockchain_tpu sim --backend cpu --events-dump PATH
#       followed by SIM_D24_ARGS (292 s on one CPU rank);
#   (e) python -m mpi_blockchain_tpu sim --events-dump PATH followed by
#       SIM_NEVER_ARGS (every delivery dropped: rc 1 at the 10000-step cap);
#   (d) the reference's ``resilience smoke_determinism`` dump.
SIM_PRESET_PIN = {
    "converged": True, "degraded": False, "steps": 2173,
    "heights": [20, 20],
    "tips": [
        "00001a052a7eab54b5dfb7055e5d219a090c3bc7cf87913da36c1d5282a548df"],
    "stats": [{"blocks_accepted_from_peers": 9, "blocks_adopted": 0,
               "blocks_mined": 11, "headers_fetched": 0,
               "reorged_away_blocks": 0, "reorgs": 0},
              {"blocks_accepted_from_peers": 11, "blocks_adopted": 0,
               "blocks_mined": 9, "headers_fetched": 0,
               "reorged_away_blocks": 0, "reorgs": 0}],
    "stats_conserved": True,
    "dump_sha256":
        "331ce2e0c797fa598f7890206dd55b0b070e41b0ac60eac88117cdfb7e9fa43b"}
SIM_D24_ARGS = ("--difficulty", "24", "--blocks", "12",
                "--nonce-budget-pow2", "24", "--batch-pow2", "24",
                "--partition-steps", "8", "--groups", "2",
                "--delay-steps", "1")
SIM_D24_PIN = {
    "converged": True, "degraded": False, "steps": 16, "heights": [13, 13],
    "tips": [
        "000000e5d970d7c842b06b4946414ee8832839462d2b8123ae09d64eefb7769a"],
    "stats": [{"blocks_accepted_from_peers": 1, "blocks_adopted": 0,
               "blocks_mined": 12, "headers_fetched": 0,
               "reorged_away_blocks": 0, "reorgs": 0},
              {"blocks_accepted_from_peers": 0, "blocks_adopted": 12,
               "blocks_mined": 9, "headers_fetched": 12,
               "reorged_away_blocks": 8, "reorgs": 3}],
    "stats_conserved": True,
    "dump_sha256":
        "16ab7ba00d067fa31d53aee43b7531be440407fbc3359a530455c2b45b41968f"}
SIM_NEVER_ARGS = ("--blocks", "2", "--drop-rate", "100",
                  "--nonce-budget-pow2", "0")
SIM_NEVER_PIN = {
    "summary": {"converged": False, "event": "sim_done",
                "error": "no convergence in 10000 steps"},
    "dump_sha256":
        "66c5ffe6420701f132fc9e35ba08c225f42330d9587ffa3e5b0a1631703749e2"}
SIM_DETERMINISM_SHA256 = \
    "0ae09b39dd33c5645e7fe477206140f000e7d4bc400a6dc3b0afbf6280f29384"
# (c): the reference's adversarial-bench record in PERF_HISTORY.jsonl.
SIM_BENCH_PIN = {"converged": True, "blocks_total": 419, "reorgs": 5506,
                 "sync_rejections": 37, "final_bits": 16}
# (a): the preset's search shape, timed apart from the bus: launches of
# 2^8 nonces at dbits 16 enqueued back to back, each into its own buffer,
# behind a sweep of 2^30 nonces at dbits 64 that keeps the card busy while
# the host enqueues them.
SIM_SHAPE_LAUNCHES = 1000
SIM_SHAPE_BLOCKER = 1 << 30
SIM_SHAPE_BLOCKER_DBITS = 64        # no hash has 64 leading zero bits
SIM_SHAPE_NONCES = 1 << 8
SIM_SHAPE_DBITS = 16
# (f): the budgets a group's bounded search takes, and where it starts.
SIM_BOUNDED_COUNTS = (1, 8, 31, 32, 33, 256)
SIM_BOUNDED_DBITS = (8, 16)
# Phase 10: the front door. (b) the full-width served chain and its seeded
# load (the reference's default door knobs), the order of the runs with
# and without load, and how many heights' winners are held against the
# C++ sweep; (c) the --serve-metrics run and the heights at which the
# probe scrapes /healthz and /metrics from inside it.
SERVE_ARGS = ("--difficulty", "24", "--batch-pow2", "24", "--blocks", "1000")
SERVE_LOAD = {"seed": 1337, "n": 2000, "workers": 4}
SERVE_TURNS = ("load", "quiet", "quiet", "load")
SERVE_CHECKED_HEIGHTS = 2
SERVE_METRICS_ARGS = ("--difficulty", "20", "--blocks", "10",
                      "--batch-pow2", "20")
SERVE_PROBE_HEIGHTS = {"healthz": 5, "metrics": 10}
# (a), (b): the kernel against the plain version and the C++ sweep on the
# served chains' own headers, over this many nonces each side of a winner.
SERVE_WINDOW_HALF = 1 << 15
# Phase 11: per-block tracing. (a) the d24/n1000 pipelined Miner traced
# and with the telemetry off, in these turns (three rounds, so that the
# tracing's cost a block stands out of the runs' spread); bubble_fraction
# against 1 - sweeps / wall within this.
TRACE_TURNS = ("traced", "off", "off", "traced") * 3
BUBBLE_TOLERANCE = 0.05
# (a) the host cost of the timing events a launch: timed launches and
# their read-backs against launches with one plain event, this many a
# turn.
EVENT_COST_LAUNCHES = 2000
# (c) the chainwatch run: the d20/n10 pin, every block evaluated, and the
# fault plan of the reference's chainwatch smoke (two consecutive
# injected dispatch raises, after the watchdog's first sample anchors).
INCIDENT_ENV = {"MPIBT_CHAINWATCH_INTERVAL": "0",
                "MPIBT_CHAINWATCH_STORM_N": "3",
                "MPIBT_CHAINWATCH_STORM_WINDOW": "60"}
INCIDENT_FAULT = {"site": "backend.cuda.dispatch", "kind": "raise",
                  "call": 2, "times": 2}
# (d) the overhead audits that may be taken until one is inside the bound,
# with a pause after a miss: the reference's trace smoke (a real
# regression cannot read under the bound; host weather can read over it).
OVERHEAD_ATTEMPTS = ({}, {"seconds": 1.5, "reps": 5},
                     {"seconds": 1.5, "reps": 5}, {"seconds": 2.0, "reps": 5})
OVERHEAD_PAUSE_S = 5.0
# Phase 12: mesh observability. (a) the d24/n1000 pipelined Miner through
# ``mine``, with the shard (``--mesh-obs``) and without, in these turns;
# (b) to (d) the multi-rank smokes, each with its ranks on the card.
MESH_OBS_ARGS = ("--difficulty", "24", "--blocks", "1000", "--batch-pow2",
                 "24")
MESH_OBS_TURNS = ("off", "obs", "obs", "off")
# (a) the shard writes timed after the runs, to price one flush.
MESH_OBS_FLUSHES = 9
SMOKES = (("meshwatch", "mpi_blockchain_tpu_torch.meshwatch", "b"),
          ("chainwatch", "mpi_blockchain_tpu_torch.chainwatch", "c"),
          ("blocktrace", "mpi_blockchain_tpu_torch.blocktrace", "d"))
SMOKE_TIMEOUT_S = 240
# Phase 13: the elastic mesh and forensics. (a) the elastic smoke's
# mesh.rank_death world (four ``mine --elastic`` ranks with ``--mesh-obs``
# and ``--events-dump``) at this chain, on the card twice and on the C++
# sweep once, and the same world with no plan; (c) ``mine --elastic
# --miners 4`` at the d20/n10/b20 pin, with this ``parallel.collective``
# fault (call 0 is the build; one search a block) and without; (d) the
# adversarial scenario preset's dump, beside 13 a's and a card sim's.
ELASTIC_CHAIN = ("--difficulty", "20", "--blocks", "6")
ELASTIC_MESH_ARGS = ("mine", "--elastic", "--miners", "4", "--difficulty",
                     "20", "--blocks", "10", "--batch-pow2", "20")
ELASTIC_COLLECTIVE_FAULT = {"site": "parallel.collective", "kind": "raise",
                            "call": 4, "times": 1}
FORENSICS_SIM_ARGS = ("sim", "--preset", "adversarial")
FORENSICS_ATTACK_ARGS = ("sim", "--preset", "adversarial-smoke")
FORENSICS_TIMEOUT_S = 120
# A rank process whose sweep launches can be read back: the port's CLI,
# then the library's launch counter as the last line of stderr (a rank
# that dies, killed or hard-exited, prints nothing).
COUNTING_ENTRY = ["-c", "import json, sys\n"
                  "from mpi_blockchain_tpu_torch.cli import main\n"
                  "from mpi_blockchain_tpu_torch.ops import sha256_cuda\n"
                  "rc = main(sys.argv[1:])\n"
                  "print(json.dumps({'sweep_launches': sha256_cuda.launches"
                  "}), file=sys.stderr)\n"
                  "sys.exit(rc)\n"]


# A rank of a gloo world whose sweep and step launches can be read back:
# the port's CLI, then both counters as the last line of stderr, then the
# CLI's own exit for a process that joined a world.
WORLD_COUNTING_ENTRY = [
    "-c", "import json, sys\n"
    "from mpi_blockchain_tpu_torch.cli import main\n"
    "from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda\n"
    "from mpi_blockchain_tpu_torch.parallel.distributed import "
    "exit_process\n"
    "rc = main(sys.argv[1:])\n"
    "print(json.dumps({'sweep_launches': sha256_cuda.launches, "
    "'step_launches': sha256_block.step_launches}), file=sys.stderr)\n"
    "exit_process(rc)\n"]
# A module's CLI in a process of its own whose sweep launches can be read
# back, as COUNTING_ENTRY does for the port's CLI.
MODULE_COUNTING_ENTRY = ("import importlib, json, sys\n"
                         "from mpi_blockchain_tpu_torch.ops import "
                         "sha256_cuda\n"
                         "rc = importlib.import_module({module!r}).main("
                         "sys.argv[1:])\n"
                         "print(json.dumps({{'sweep_launches': "
                         "sha256_cuda.launches}}), file=sys.stderr)\n"
                         "sys.exit(rc)\n")
# Phase 14 (a): phase 7's card payloads as they are recorded, in order (the
# m1 sweep last, so the report's roofline is its).
PERFWATCH_RECORDS = (("sweep", ("sweep", 8)), ("chain", ("chain",)),
                     ("sharded_pallas", ("sharded",)),
                     ("tpu_single", ("single",)), ("sweep", ("sweep", 1)))
PERFWATCH_DROP = 0.8
PERFWATCH_TIMEOUT_S = 240
# Phase 16: the port's chainlint CLI and the sanitizer matrix, each in a
# process of its own; the driver's known-answer cases (sanitize_main.cu).
ANALYSIS_TIMEOUT_S = 600
SANITIZER_TIMEOUT_S = 900
SANITIZER_CASES = 24
# Phase 17: the budget movers' checks, and the shape of 17 c's round (the
# d20/n10/b20 pin's, as phase 8's world).
BUDGET_TIMEOUT_S = 300
BUDGET_WORLD_ROUND = ("--batch-pow2", "20", "--difficulty", "20")
# Phase 18: the gate's parse-only run over its whole plan on the card.
GATE_TIMEOUT_S = 300
# What ``make metrics-smoke`` greps the telemetry CLI's snapshot for.
METRICS_NEEDLES = (r"^mining_rounds_total", r"^hashes_tried_total", r"_count")
# Phase 15: the last of the reference's paths. (a) ``mine --fused`` as a
# two-rank gloo world at the full-size pin, FUSED_WORLD_K blocks a call; (b)
# ``mine --profile`` at the d20/n10 pin (WORLD_ARGS), per block and fused,
# each without and with the capture; (c) the graft twin's dry run with
# GRAFT_MINERS miners.
FUSED_WORLD_CHAIN = ("--difficulty", "24", "--blocks", "1000", "--batch-pow2",
                     "24")
FUSED_WORLD_K = 100
PROFILE_FORMS = {"miner": [], "fused": ["--fused"]}
GRAFT_MINERS = 8
# What the capture calls the library's kernels (a part of each name), and
# the host span inside which each form launches them.
TRACE_KERNELS = {"sweep": "sha256d_sweep_kernel", "step": "block_step_kernel"}
LAUNCH_SPANS = {"miner": "backend.cuda.dispatch", "fused": "fused.dispatch"}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class ClockSampler:
    """Samples the SM clock (MHz) and power draw (W) with nvidia-smi on a
    thread while a run lasts."""

    def __init__(self, period_s: float = 0.25):
        self.samples: list[tuple[float, float]] = []
        self._period = period_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            line = nvidia_smi("clocks.sm,power.draw", units=False)
            self.samples.append(tuple(float(v) for v in line.split(",")))
            self._stop.wait(self._period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def summary(self) -> dict:
        clocks = sorted(c for c, _ in self.samples)
        power = [p for _, p in self.samples]
        if not clocks:
            return {}
        return {"samples": len(clocks), "sm_clock_mhz_min": clocks[0],
                "sm_clock_mhz_median": clocks[len(clocks) // 2],
                "sm_clock_mhz_max": clocks[-1],
                "power_w_max": max(power)}


def fault_plan(site: str, kind: str, call: int = 0, times: int = 1,
               seconds: float = 0.05) -> dict:
    """A fault plan of one fault, as ``mine --fault-plan`` reads it."""
    return {"version": 1, "faults": [{"site": site, "kind": kind,
                                      "call": call, "times": times,
                                      "seconds": seconds}]}


def without_nvcc(environ: dict, missing: str) -> dict:
    """``environ`` with ``CUDA_HOME`` at the directory ``missing`` (which
    does not exist) and every ``PATH`` entry that holds an ``nvcc`` taken
    out, so that ``sha256_cuda.find_nvcc`` finds none."""
    path = [p for p in environ.get("PATH", "").split(os.pathsep)
            if p and not (pathlib.Path(p) / "nvcc").exists()]
    return {**environ, "CUDA_HOME": missing, "CUDA_PATH": missing,
            "PATH": os.pathsep.join(path)}


def metric_total(prometheus: str, name: str) -> float:
    """The sum of every sample of metric ``name`` in Prometheus text."""
    total = 0.0
    for line in prometheus.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        key, _, value = line.rpartition(" ")
        if key.split("{")[0] == name:
            total += float(value)
    return total


def check_no_step_down(summary: dict, rung: str, what: str) -> None:
    """Fails unless a mine summary reports the rung ``rung`` and no
    step-down."""
    check(summary.get("rung") == rung and "degraded" not in summary,
          f"{what}: rung {summary.get('rung')}, degraded "
          f"{summary.get('degraded_to')}, not {rung} without a step-down")


def run_cli(argv: list[str]) -> tuple[int, dict]:
    """The port's CLI in this process: (rc, the last JSON line)."""
    from mpi_blockchain_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else {})


def random_header(rng) -> bytes:
    return rng.integers(0, 256, size=80, dtype="uint8").tobytes()


def find_header(rng, accept, tries: int = 4000) -> bytes:
    """The first seeded random header that ``accept`` takes."""
    for _ in range(tries):
        hdr = random_header(rng)
        if accept(hdr):
            return hdr
    raise SmokeFailure(f"no header in {tries} draws fits the case")


def slice_edge_cases(rng, g: int):
    """(header, dbits, base, count) cases at the edges of the kernel's
    slices of ``g`` nonces, each found by trying seeded headers against the
    C++ ``cpu_search``."""
    from mpi_blockchain_tpu_torch import core

    lg = g.bit_length() - 1             # dbits with about one winner per g
    base = int(rng.integers(0, 1 << 31))

    def search(hdr, d, start, count):
        return core.cpu_search(hdr, start, count, d)[0]

    def two_slices(hdr):                # the two lowest in other slices
        lo = search(hdr, lg + 2, base, 64 * g)
        if lo is None:
            return False
        hi = search(hdr, lg + 2, lo + 1, base + 64 * g - lo - 1)
        return hi is not None and (hi - base) // g != (lo - base) // g

    def first_slice(hdr):
        return search(hdr, lg + 1, base, g) is not None

    ragged = g // 2 + 3                 # the last slice's length
    top = NONCE_SPACE - 2 * g - ragged

    def last_slice(hdr):
        return search(hdr, lg, top, 2 * g) is None and \
            search(hdr, lg, NONCE_SPACE - ragged, ragged) is not None

    return [(find_header(rng, two_slices), lg + 2, base, 64 * g),
            (random_header(rng), 8, base, 100 * g + 13),
            (find_header(rng, first_slice), lg + 1, base, 64 * g),
            (find_header(rng, last_slice), lg, top, 2 * g + ragged)]


def phase_kernel_vs_plain(rng, device):
    """The kernel against the plain version on the card. Returns
    (mismatches, max_abs_err)."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda, sha256_torch
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    cases = [(d, 0, 1 << 20) for d in (0, 1, 8, 31, 32, 33, 63, 64)]
    cases += [(d, int(rng.integers(0, 1 << 31)), 1 << 18)
              for d in (1, 8, 16)]
    cases += [(8, 0xFFFFE000, 1 << 13),      # ends exactly at 2^32
              (0, 0xFFFFFFFF, 1),            # the last nonce is findable
              (TIMED_DBITS, 0, 1 << 24)]     # a full-size round
    cases = [(None, *case) for case in cases]
    # The slice cases draw from their own generator, so the draws of the
    # other phases (and phase 4's header) stay as they were.
    cases += slice_edge_cases(np.random.default_rng(20261017),
                              sha256_cuda.SLICE_NONCES)
    mismatches, max_err = 0, 0
    for hdr, d, base, count in cases:
        ext = extend_midstate(*core.header_midstate(
            random_header(rng) if hdr is None else hdr))
        ext_t = torch.as_tensor(ext.astype(np.int64), device=device)
        for early_exit in (False, True):
            k = sha256_cuda.sweep(ext, base, count, d, device=device,
                                  early_exit=early_exit)
            p = sha256_torch.sweep_core_ext(ext_t, base, count, d,
                                            early_exit=early_exit)
            if early_exit:
                same = k[1] == p[1] and (k[0] > 0) == (p[0] > 0)
                err = abs(k[1] - p[1])
            else:
                same = k == p
                err = max(abs(k[0] - p[0]), abs(k[1] - p[1]))
            max_err = max(max_err, err)
            if not same:
                mismatches += 1
                log(f"MISMATCH dbits={d} base={base:#x} count={count} "
                    f"early_exit={early_exit}: kernel {k} plain {p}")
    torch.cuda.synchronize()
    last = sha256_cuda.sweep(
        extend_midstate(*core.header_midstate(random_header(rng))),
        0xFFFFFFFF, 1, 0, device=device)
    check(last == (1, 0xFFFFFFFF),
          f"[0xFFFFFFFF, 2^32) at dbits 0 gave {last}, not (1, 0xFFFFFFFF)")
    log(f"phase 1 kernel vs plain: {2 * len(cases)} comparisons, "
        f"mismatches {mismatches}, max_abs_err {max_err}")
    check(mismatches == 0, f"{mismatches} kernel/plain mismatches")
    return mismatches, max_err


def phase_backend(rng, device):
    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
    from mpi_blockchain_tpu_torch.backend.cuda import CudaBackend

    cuda_be = CudaBackend(batch_pow2=20, kernel="cuda", device=device)
    cpu_be = CpuBackend()
    n = 0
    for i in range(24):
        hdr = random_header(rng)
        d = int(rng.integers(4, 17))
        if i % 4 == 0:
            start = 0xFFFFE000 + int(rng.integers(0, 1 << 12))
        else:
            start = int(rng.integers(0, 1 << 32))
        max_count = int(rng.integers(1, 1 << 20))
        a = cuda_be.search(hdr, d, start, max_count)
        b = cpu_be.search(hdr, d, start, max_count)
        oracle, _ = core.cpu_search(hdr, start, max_count, d)
        check((a.nonce, a.hash) == (b.nonce, b.hash) and a.nonce == oracle,
              f"backend mismatch at dbits={d} start={start:#x} "
              f"max_count={max_count}: cuda {a} cpu {b} oracle {oracle}")
        n += 1
    log(f"phase 2 backend: {n} searches, CudaBackend == CpuBackend == "
        f"cpu_search")


# The library's entries that launch the sweep with ext in host memory,
# the only ones the per-block Miner calls.
SWEEP_ENTRIES = ("sha256d_sweep_launch", "sha256d_sweep_launch_timed")


@contextlib.contextmanager
def timed_library_calls(lib, events: list, new_event):
    """Records a pair of events (``new_event()``) right before and right
    after each call of ``lib``'s ``SWEEP_ENTRIES``, appending each pair
    to ``events``. On a card that is idle when the host gets to a launch,
    a pair around ``sha256_cuda.launch`` also times the wrapper's host
    work before the kernel as busy (50 to 60 us a launch beside an NVIDIA
    H100 80GB HBM3 at 700 W, more on a loaded host); around the library's
    call it times the kernel and a few us of the call's own."""
    saved = {name: getattr(lib, name) for name in SWEEP_ENTRIES}

    def bracketed(fn):
        def call(*args):
            ev = (new_event(), new_event())
            ev[0].record()
            err = fn(*args)
            ev[1].record()
            events.append(ev)
            return err
        return call

    for name, fn in saved.items():
        setattr(lib, name, bracketed(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)


def mine_timed(miner, bracket: str = "call",
               sample_clocks: bool = True) -> dict:
    """Mines ``miner``'s chain with CUDA events around every sweep launch
    and its CUDA backend's searches counted (each starts with the
    backend's ``launch``, whether ``search`` or the resilient wrapper
    calls it); returns wall, sweep time, launches, searches and the card's
    clocks during the run (``sample_clocks``; else none). ``bracket``
    "call" puts the events around ``sha256_cuda.launch``, "library"
    around the library's call inside it (``timed_library_calls``). The
    clock sampler's thread starts ``nvidia-smi`` four times a second;
    where it holds the interpreter lock inside a bracket, the host's wait
    for it is timed as the sweep's."""
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    if bracket not in ("call", "library"):
        raise ValueError(f"bracket {bracket!r}")
    backend = getattr(miner.backend, "active_backend", miner.backend)
    searches, events = 0, []
    start, launch = backend.launch, sha256_cuda.launch

    def counted_start(*args, **kwargs):
        nonlocal searches
        searches += 1
        return start(*args, **kwargs)

    def timed_launch(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        launch(*args, **kwargs)
        ev[1].record()
        events.append(ev)

    backend.launch = counted_start
    timing = contextlib.nullcontext()
    if bracket == "call":
        sha256_cuda.launch = timed_launch
    else:
        timing = timed_library_calls(
            sha256_cuda.library(), events,
            lambda: torch.cuda.Event(enable_timing=True))
    sha256_cuda.launches = 0
    try:
        torch.cuda.synchronize()
        with timing, (ClockSampler() if sample_clocks
                      else contextlib.nullcontext(None)) as clocks:
            t0 = time.perf_counter()
            miner.mine_chain()
            wall = time.perf_counter() - t0
    finally:
        sha256_cuda.launch = launch
        del backend.launch
    launches = sha256_cuda.launches
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    return {"wall_s": wall, "kernel_s": kernel_s, "launches": launches,
            "searches": searches,
            "clocks": clocks.summary() if clocks is not None else {},
            "tip_hash": miner.node.tip_hash.hex()}


def phase_tips(device):
    """Mines the pinned chains through the resilient backend; returns the
    d24/n1000 run's numbers."""
    from mpi_blockchain_tpu_torch import core, telemetry
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "d20.bin")
        telemetry.reset()
        sha256_cuda.launches = 0
        rc, summary = run_cli(["mine", "--difficulty", "20", "--blocks",
                               "10", "--batch-pow2", "20", "--out", out])
        launches = sha256_cuda.launches
        check(rc == 0, f"mine d20/n10/b20 exited {rc}: {summary}")
        node = core.Node(20)
        with open(out, "rb") as f:
            check(node.load(f.read()), "the d20 chain file does not verify")
    tip = node.tip_hash.hex()
    check(tip == PINNED_TIPS[(20, 10, 20)], f"d20/n10/b20 tip {tip}")
    check(launches == 10, f"d20/n10 made {launches} launches, not 10")
    check_no_step_down(summary, "cuda:cuda", "mine d20/n10")
    reg = telemetry.default_registry()
    check(reg.total("retries_total") == 0, "mine d20/n10 retried")
    log(f"phase 3 d20/n10/b20 via the CLI: tip {tip} matches, "
        f"{launches} launches, rung {summary['rung']}, no retry or "
        f"step-down")

    results = {}
    for (d, blocks, pow2), pinned in PINNED_TIPS.items():
        if d == 20:
            continue
        cfg = MinerConfig(difficulty_bits=d, n_blocks=blocks,
                          batch_pow2=pow2, backend="cuda", kernel="cuda",
                          device="cuda")
        telemetry.reset()
        miner = Miner(cfg, pipeline=True)
        run = mine_timed(miner)
        wall, kernel_s = run["wall_s"], run["kernel_s"]
        launches, searches = run["launches"], run["searches"]
        tip = miner.node.tip_hash.hex()
        check(tip == pinned, f"d{d}/n{blocks} tip {tip} != pinned {pinned}")
        check(launches > 0 and launches == searches,
              f"d{d}/n{blocks}: {launches} launches for {searches} "
              f"searches")
        check(miner.backend.rung == "cuda:cuda"
              and miner.backend.degradations == []
              and telemetry.default_registry().total("retries_total") == 0,
              f"d{d}/n{blocks}: rung {miner.backend.rung}, degradations "
              f"{miner.backend.degradations}")
        # Each block's window starts at nonce 0, so the kernel hashed at
        # least winner + 1 nonces for it.
        least_work = sum(r.nonce + 1 for r in miner.records)
        results[(d, blocks)] = {
            **run, "hashes_tried": miner.total_hashes(),
            "hashes_per_s": miner.total_hashes() / wall,
            "least_nonces": least_work}
        log(f"phase 3 d{d}/n{blocks}/b{pow2} via Miner (pipelined, "
            f"rung {miner.backend.rung}): tip {tip} matches; wall "
            f"{wall:.6f} s, "
            f"{miner.total_hashes() / wall:.6g} hashes/s (reference "
            f"accounting), {launches} launches for {searches} searches; "
            f"kernel {kernel_s:.6f} s ({kernel_s / wall:.4f} of wall), "
            f"least nonces hashed {least_work} "
            f"({least_work / kernel_s / 1e9:.4f} GH/s in the kernel); "
            f"card during the run {run['clocks']}")
    return {**results[(24, 1000)], "d20_wall_s": summary["wall_s"]}


def time_in_turns(ext, configs: dict, reps: int, expect_min: int,
                  device) -> dict:
    """Median CUDA-event time (ms) of one launch at dbits TIMED_DBITS for
    each named config (``count``, optionally its own ``ext``, and the
    keyword arguments of ``sha256_cuda.launch``, from nonce 0), launched in
    turns: one of each per round, in reverse order every other round, so
    that all share the card's state. Each launch's buffer is reset first;
    each config's last result must have ``expect_min``."""
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    fresh = sha256_cuda.new_result(device)
    outs = {name: fresh.clone() for name in configs}
    events = {name: [] for name in configs}
    names = list(configs)
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            cfg = dict(configs[name])
            count = cfg.pop("count")
            launch_ext = cfg.pop("ext", ext)
            outs[name].copy_(fresh)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            sha256_cuda.launch(launch_ext, 0, count, TIMED_DBITS, outs[name],
                               **cfg)
            ev[1].record()
            events[name].append(ev)
    torch.cuda.synchronize()
    medians = {}
    for name in names:
        got = sha256_cuda.read_result(outs[name])[1]
        check(got == expect_min, f"timed launch {name} found {got:#x}, "
              f"not {expect_min:#x}")
        times = sorted(a.elapsed_time(b) for a, b in events[name])
        medians[name] = times[len(times) // 2]
    return medians


def full_sweep_min(winner: int) -> int:
    """The lowest qualifier a sweep of [0, TIMED_NONCES) finds."""
    return winner if winner < TIMED_NONCES else 0xFFFFFFFF


def phase_timing(rng, device):
    """The kernel at the main path's launch shape: one early-exit launch
    over the whole nonce space at dbits 24, for a header whose lowest
    winner W is known. Counts the nonces it hashes (measuring build, over
    OVERSHOOT_LAUNCHES launches) against the overshoot bound, times it in
    turns with a full sweep of
    exactly [0, W], times a full sweep of 2^24 nonces and the plain version
    on the early-exit input, and takes the bound from the function's work.
    Returns the numbers."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda, sha256_torch
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    # A header whose winner lies within a factor 2 of its mean 2^24, so
    # the plain version's run stays short.
    for _ in range(32):
        ext = extend_midstate(*core.header_midstate(random_header(rng)))
        found, winner = sha256_cuda.sweep(ext, 0, NONCE_SPACE, TIMED_DBITS,
                                          device=device, early_exit=True)
        if found and (1 << 23) <= winner < (1 << 25):
            break
    else:
        raise SmokeFailure("no header in 32 draws has a dbits-24 winner in "
                           "[2^23, 2^25)")
    need = winner + 1
    check(sha256_cuda.sweep(ext, 0, need, TIMED_DBITS, device=device)
          == (1, winner), f"{winner:#x} is not the lowest qualifying nonce")
    warps = sha256_cuda.resident_warps(TIMED_DBITS, device)
    g = sha256_cuda.SLICE_NONCES
    fresh = sha256_cuda.new_result(device)
    outs = [fresh.clone() for _ in range(OVERSHOOT_LAUNCHES)]
    hashed = torch.zeros(OVERSHOOT_LAUNCHES, dtype=torch.int64,
                         device=device)
    for i, out in enumerate(outs):
        sha256_cuda.launch(ext, 0, NONCE_SPACE, TIMED_DBITS, out,
                           early_exit=True, hashed=hashed[i:i + 1])
    check(all(sha256_cuda.read_result(out)[1] == winner for out in outs),
          "the measuring build found another winner")
    over = sorted(int(n) - need for n in hashed.tolist())
    median_over = over[len(over) // 2]
    n_hashed = need + median_over
    past_bound = sum(o > warps * g for o in over)

    with ClockSampler() as clocks:
        turns = time_in_turns(
            ext, {"main": {"count": NONCE_SPACE, "early_exit": True},
                  "exact": {"count": need}}, 30, winner, device)
        ext_device = torch.from_numpy(ext).to(device)
        fulls = time_in_turns(
            ext, {"full": {"count": TIMED_NONCES},
                  "full_ext_symbol": {"count": TIMED_NONCES,
                                      "ext": ext_device}},
            50, full_sweep_min(winner), device)
    full, full_symbol = fulls["full"], fulls["full_ext_symbol"]
    ms, exact_ms = turns["main"], turns["exact"]
    regs, per_sm = sha256_cuda.occupancy(TIMED_DBITS, device)
    regs_symbol, per_sm_symbol = sha256_cuda.occupancy(TIMED_DBITS, device,
                                                       ext_from_symbol=True)

    ext_t = torch.as_tensor(ext.astype(np.int64), device=device)
    sha256_torch.sweep_core_ext(ext_t, 0, 1 << 16, TIMED_DBITS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sha256_torch.sweep_core_ext(ext_t, 0, NONCE_SPACE, TIMED_DBITS,
                                        early_exit=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(plain[1] == winner, f"the plain version found {plain[1]:#x}")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    census = sha256_cuda.loop_census(sha256_cuda.disassemble(), TIMED_DBITS)
    adds = sha256_cuda.source_adds(TIMED_DBITS)
    alu_only = sha256_cuda.alu_only_count(census)
    per_nonce = sha256_cuda.bound_sm_clocks_per_nonce(census, adds)
    by_census = sha256_cuda.sm_clocks_per_nonce(census)
    alu, fma, total = sha256_cuda.pipe_counts(census)

    def clocks_ms(nonces: int, clocks_per_nonce: float) -> float:
        return nonces * clocks_per_nonce / (sms * clock_mhz * 1e6) * 1e3

    bound, bound_full = clocks_ms(need, per_nonce), \
        clocks_ms(TIMED_NONCES, per_nonce)
    resident = sha256_cuda.resident_blocks(TIMED_DBITS, device)
    log(f"phase 4 loop of the dbits-{TIMED_DBITS} kernel: {total} "
        f"instructions, {alu} on the ALU pipe ({alu_only} of them ALU-only), "
        f"{fma} on the FMA pipe; by opcode {census}; the source's adds "
        f"{adds} a nonce; bound {per_nonce:.4f} SM clocks a nonce (census "
        f"of this build: {by_census:.4f}); persistent grid {resident} "
        f"blocks, {warps} warps, on {sms} SMs")
    log(f"phase 4 main-path launch (early exit over [0, 2^32), dbits "
        f"{TIMED_DBITS}, winner {winner}, slices of {g} nonces): kernel "
        f"{ms:.4f} ms, bound {bound:.4f} ms for the {need} nonces it needs, "
        f"hashed {n_hashed} nonces in the median of {len(over)} measuring "
        f"launches ({n_hashed / need:.4f} of the need): overshoot "
        f"{median_over} against the bound {warps} warps x {g} = "
        f"{warps * g} (over the launches: min {over[0]}, 90th percentile "
        f"{over[len(over) * 9 // 10]}, max {over[-1]}; {past_bound} past "
        f"the bound); a full sweep of exactly those {need} nonces takes "
        f"{exact_ms:.4f} ms in the same turns ({ms / exact_ms:.4f} of it); "
        f"plain version {plain_ms:.1f} ms")
    log(f"phase 4 full sweep of {TIMED_NONCES} nonces: kernel {full:.4f} ms "
        f"({TIMED_NONCES / full / 1e6:.4f} GH/s), bound {bound_full:.4f} ms "
        f"({bound_full / full:.4f} of the kernel's time; census figure "
        f"{clocks_ms(TIMED_NONCES, by_census):.4f} ms) at {clock_mhz:.0f} "
        f"MHz; card during the timed launches {clocks.summary()}")
    log(f"phase 4 the same sweep with ext from the __constant__ symbol, in "
        f"the same turns: {full_symbol:.4f} ms ({full_symbol / full:.4f} of "
        f"the by-value build's); registers {regs} by value, {regs_symbol} "
        f"from the symbol; blocks per SM {per_sm} and {per_sm_symbol}")
    check(median_over <= warps * g,
          f"the early exit hashed a median {median_over} nonces past the "
          f"need, more than one slice per resident warp ({warps * g})")
    check(ms <= 1.15 * exact_ms,
          f"the main-path launch took {ms:.4f} ms, more than 1.15 times the "
          f"exact sweep of [0, W] ({exact_ms:.4f} ms)")
    check(full >= bound_full,
          f"the 2^24 sweep took {full:.4f} ms, under its bound "
          f"{bound_full:.4f} ms: the bound is not a floor")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "winner": winner, "nonces_needed": need,
            "nonces_hashed": n_hashed, "exact_sweep_ms": exact_ms,
            "ms_per_2^24": full, "bound_ms_per_2^24": bound_full,
            "ms_per_2^24_ext_symbol": full_symbol,
            "ext_symbol_over_by_value_2^24": full_symbol / full,
            "registers": regs, "registers_ext_symbol": regs_symbol,
            "blocks_per_sm": per_sm, "blocks_per_sm_ext_symbol": per_sm_symbol,
            "share_of_bound_2^24": bound_full / full,
            "sm_clocks_per_nonce": per_nonce,
            "source_adds_per_nonce": adds, "loop_alu_only_ops": alu_only,
            "census_sm_clocks_per_nonce": by_census,
            "census_bound_ms_per_2^24": clocks_ms(TIMED_NONCES, by_census),
            "loop_alu_ops": alu, "loop_fma_ops": fma,
            "loop_instructions": total, "slice_nonces": g,
            "resident_warps": warps, "overshoot_bound": warps * g,
            "overshoot": median_over, "overshoot_max": over[-1],
            "overshoot_launches": len(over),
            "overshoot_past_bound": past_bound, "resident_blocks": resident,
            "sms": sms, "sm_clock_mhz": clock_mhz}


def step_edge_cases(rng) -> list[tuple]:
    """(prev, data, heights, nonces, bits) groups of step cases at the
    edges of its inputs, one group per difficulty in STEP_EDGE_BITS: every
    prev word all-zero or all-ones, height 0 or 0xFFFFFFFF (whose next
    block's height wraps to 0), and nonce 0 or 0xFFFFFFFF in both of a
    case's finalizing steps; the data words are seeded."""
    import numpy as np

    rows = [(pv, h, nz) for pv in STEP_EDGE_PREVS for h in STEP_EDGE_HEIGHTS
            for nz in STEP_EDGE_NONCES]
    prev = np.array([[pv] * 8 for pv, _, _ in rows], dtype=np.uint32)
    heights = np.array([h for _, h, _ in rows], dtype=np.int64)
    nonces = np.array([[nz, M32 - nz] for _, _, nz in rows], dtype=np.uint32)
    return [(prev, rng.integers(0, 1 << 32, (len(rows), 2, 8),
                                dtype=np.uint32), heights, nonces, bits)
            for bits in STEP_EDGE_BITS]


def step_vs_plain(prev, data, heights, nonces, bits: int, device
                  ) -> tuple[int, int]:
    """The step kernel against the plain step on the card, bit for bit,
    over n cases (numpy: prev (n, 8), data (n, 2, 8), heights (n,), nonces
    (n, 2)) at ``bits``: each builds a block, finalizes it with its first
    nonce and builds the next at height + 1, then finalizes that into the
    tip with its second nonce; the plain version computes all cases at
    once. Returns (cases that differ, max_abs_err)."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_block
    from mpi_blockchain_tpu_torch.ops.sha256_block import (
        block_template, winner_digest)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n = len(prev)
    prev_t, data_t = card(prev), card(data)
    built, both = [], []
    nonce_out = torch.zeros((n, 2), dtype=torch.uint32, device=device)
    tips = torch.zeros((n, 8), dtype=torch.uint32, device=device)
    for i in range(n):
        h = int(heights[i])
        scratch = sha256_block.new_scratch(device)
        sha256_block.step(scratch, prev=prev_t[i], data=data_t[i, 0],
                          height=h, difficulty_bits=bits)
        built.append(scratch.clone())
        scratch.view(torch.uint32)[1] = int(nonces[i, 0])
        sha256_block.step(scratch, data=data_t[i, 1], height=h + 1,
                          difficulty_bits=bits, nonce_out=nonce_out[i, :1])
        both.append(scratch.clone())
        scratch.view(torch.uint32)[1] = int(nonces[i, 1])
        sha256_block.step(scratch, nonce_out=nonce_out[i, 1:],
                          tip_out=tips[i])
    torch.cuda.synchronize()

    h_t = torch.from_numpy(heights.astype(np.int64)).to(device)
    n_t = sha256_block.to_words(card(nonces))
    reset = torch.tensor([0, M32, 0, 0], dtype=torch.int64,
                         device=device).expand(n, 4)
    ms, tail, ext = block_template(prev_t, data_t[:, 0], h_t, bits)
    want_built = torch.cat([reset, ext, ms, tail], dim=1)
    digest = winner_digest(ms, tail, n_t[:, 0])
    ms2, tail2, ext2 = block_template(digest, data_t[:, 1], h_t + 1, bits)
    want_both = torch.cat([reset, ext2, ms2, tail2], dim=1)
    want_tip = winner_digest(ms2, tail2, n_t[:, 1])
    got = [sha256_block.to_words(t) for t in (torch.stack(built),
                                               torch.stack(both), nonce_out,
                                               tips)]
    want = [want_built, want_both, n_t, want_tip]
    diff = torch.cat([(g - w).abs() for g, w in zip(got, want)], dim=1)
    return int((diff.amax(dim=1) > 0).sum()), int(diff.max())


def k_block_calls_vs_plain(rng, device) -> int:
    """Whole k-block calls (``mine_k``) against ``mine_k_plain`` on the
    CPU at each k in STEP_CALL_KS and cap in STEP_CALL_CAPS (dbits 12: the
    smaller cap leaves some blocks without a winner, the sentinel carried
    on): nonces and tip. Returns the calls that differ."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_block

    bad = 0
    for k in STEP_CALL_KS:
        prev = rng.integers(0, 1 << 32, 8, dtype=np.uint32)
        data = rng.integers(0, 1 << 32, (k, 8), dtype=np.uint32)
        for cap in STEP_CALL_CAPS:
            got = sha256_block.mine_k(torch.from_numpy(prev).to(device),
                                      torch.from_numpy(data).to(device),
                                      41, 12, cap)
            want = sha256_block.mine_k_plain(torch.from_numpy(prev),
                                             torch.from_numpy(data), 41, 12,
                                             cap)
            if [t.cpu().tolist() for t in got] != [t.tolist() for t in want]:
                bad += 1
                log(f"MISMATCH k-block call k={k} cap={cap:#x}: kernel "
                    f"{[t.cpu().tolist() for t in got]} plain "
                    f"{[t.tolist() for t in want]}")
    return bad


def phase_step(rng, device, clock_mhz: float):
    """The fused step kernel on the card: against the plain step, bit for
    bit, over STEP_CASES seeded cases (sentinel nonce among them) and the
    edge cases (``step_edge_cases``); whole k-block calls against the plain
    sequence; then its time three ways, each over STEP_TIMED_LAUNCHES
    finalize-and-build steps: launched from a Python loop (what the host
    pays), enqueued back to back in one call into the library (the device
    time of a launch), and the body's SM clocks from the measuring build's
    clock stamps; its compiled size and ptxas's registers, stack and
    spills. Returns the numbers."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    n, d = STEP_CASES, TIMED_DBITS
    prev = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint32)
    data = rng.integers(0, 1 << 32, (n, 2, 8), dtype=np.uint32)
    heights = rng.integers(0, 1 << 32, n)
    nonces = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
    nonces[0, 0] = nonces[1, 1] = M32
    mismatches, max_err = step_vs_plain(prev, data, heights, nonces, d,
                                        device)
    log(f"phase 5 step kernel vs plain: {n} cases x 3 steps (build, "
        f"finalize and build, finalize into the tip; sentinel nonce in 2), "
        f"mismatches {mismatches}, max_abs_err {max_err}")
    edge_rng = np.random.default_rng(20261019)
    edge_cases, edge_mismatches = 0, 0
    for case in step_edge_cases(edge_rng):
        bad, err = step_vs_plain(*case, device)
        edge_cases += len(case[0])
        edge_mismatches += bad
        max_err = max(max_err, err)
    log(f"phase 5 step kernel vs plain at the edges (prev words "
        f"{STEP_EDGE_PREVS}, heights {STEP_EDGE_HEIGHTS}, bits "
        f"{STEP_EDGE_BITS}, nonces {STEP_EDGE_NONCES}): {edge_cases} cases "
        f"x 3 steps, mismatches {edge_mismatches}")
    call_mismatches = k_block_calls_vs_plain(edge_rng, device)
    log(f"phase 5 k-block calls vs mine_k_plain (k {STEP_CALL_KS}, caps "
        f"{[hex(c) for c in STEP_CALL_CAPS]}): mismatches {call_mismatches}")
    check(mismatches + edge_mismatches + call_mismatches == 0,
          f"step kernel/plain mismatches: {mismatches} seeded, "
          f"{edge_mismatches} at the edges, {call_mismatches} k-block calls")

    prev_t = torch.from_numpy(prev).to(device)
    data_t = torch.from_numpy(data).to(device)
    scratch = sha256_block.new_scratch(device)
    sha256_block.step(scratch, prev=prev_t[0], data=data_t[0, 0],
                      height=int(heights[0]), difficulty_bits=d)
    slot = torch.zeros(1, dtype=torch.uint32, device=device)
    step_args = dict(data=data_t[0, 1], height=1, difficulty_bits=d,
                     nonce_out=slot)
    launches = STEP_TIMED_LAUNCHES

    def timed(enqueue) -> float:
        """CUDA-event ms of what ``enqueue`` puts on the stream."""
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
        enqueue()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1])

    def python_loop():
        for _ in range(launches):
            sha256_block.step(scratch, **step_args)

    sha256_block.step_repeat(100, scratch, **step_args)      # warm-up
    python_us = timed(python_loop) / launches * 1e3
    device_us = timed(lambda: sha256_block.step_repeat(
        launches, scratch, **step_args)) / launches * 1e3
    stamps = torch.zeros(2 * launches, dtype=torch.int64, device=device)
    sha256_block.step_repeat(launches, scratch, stamps=stamps, **step_args)
    clocks = (stamps[1::2] - stamps[::2]).tolist()
    body = spread(clocks)
    body_us = body["median"] / clock_mhz
    plain = []
    for _ in range(5):
        t0 = time.perf_counter()
        sha256_block.step_plain(scratch, **step_args)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    plain_ms = sorted(plain)[len(plain) // 2]
    ops = sha256_block.STEP_DEPENDENT_OPS
    bound_ops = ops / (clock_mhz * 1e6) * 1e3
    # Bytes: the data words, the previous midstate, template and result
    # read; the nonce and the new scratch written.
    step_bytes = 4 * (8 + 24 + 4 + 1 + sha256_block.SCRATCH_WORDS)
    bound_bytes = step_bytes / 3.35e12 * 1e3
    bound = max(bound_ops, bound_bytes)
    # One thread issues at most one instruction a clock: the compiled
    # step's length is a floor of the design (not of the function).
    census = sha256_cuda.function_census(sha256_cuda.disassemble(),
                                         sha256_cuda.STEP_KERNEL_SYMBOL)
    instructions = sum(census.values())
    resources = sha256_cuda.ptxas_report(sha256_cuda.build_report(),
                                         sha256_cuda.STEP_KERNEL_SYMBOL)
    log(f"phase 5 step kernel (finalize and build, {launches} launches): "
        f"{device_us:.4f} us a launch on the card, enqueued back to back in "
        f"one call; {python_us:.4f} us a launch from a Python loop; body "
        f"{body['median']} SM clocks median ({body_us:.4f} us at "
        f"{clock_mhz:.0f} MHz; 90th percentile {body['p90']}, max "
        f"{body['max']}, first launch {clocks[0]}); bound "
        f"{bound * 1e3:.4f} us ({ops} dependent operations at one clock "
        f"each; {step_bytes} bytes take {bound_bytes * 1e6:.4f} ns); "
        f"the compiled kernel has {instructions} instructions "
        f"({instructions / clock_mhz:.4f} us at one a clock), by opcode "
        f"{census}; ptxas {resources}; plain step on the card "
        f"{plain_ms:.3f} ms")
    return {"mismatches": mismatches, "edge_cases": edge_cases,
            "edge_mismatches": edge_mismatches,
            "k_block_call_mismatches": call_mismatches,
            "max_abs_err": max_err, "ms": device_us / 1e3,
            "device_us": device_us, "python_loop_us": python_us,
            "body_us": body_us, "body_clocks": body, "plain_ms": plain_ms,
            "bound_ms": bound, "dependent_ops": ops, "bytes": step_bytes,
            "instructions": instructions, **resources}


def phase_ext_symbol(device):
    """The sweep reading ext from the __constant__ symbol against the
    by-value sweep, full and early-exit, at the slice edges. Returns the
    mismatches."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    fresh = sha256_cuda.new_result(device)
    cases = slice_edge_cases(np.random.default_rng(20261017),
                             sha256_cuda.SLICE_NONCES)
    mismatches = 0
    for hdr, d, base, count in cases:
        ext = extend_midstate(*core.header_midstate(hdr))
        for early_exit in (False, True):
            got = []
            for e in (ext, torch.from_numpy(ext).to(device)):
                out = fresh.clone()
                sha256_cuda.launch(e, base, count, d, out,
                                   early_exit=early_exit)
                got.append(sha256_cuda.read_result(out))
            if got[0] != got[1]:
                mismatches += 1
                log(f"MISMATCH ext symbol dbits={d} base={base:#x} "
                    f"count={count} early_exit={early_exit}: {got}")
    log(f"phase 5 constant-ext sweep vs by-value sweep at the slice "
        f"edges: {2 * len(cases)} comparisons, mismatches {mismatches}")
    check(mismatches == 0, f"{mismatches} constant-ext/by-value mismatches")
    return mismatches


def spread(values) -> dict:
    """Median, 90th percentile and max of ``values`` (and their number)."""
    v = sorted(values)
    if not v:
        return {"n": 0, "median": None, "p90": None, "max": None}
    return {"n": len(v), "median": v[len(v) // 2],
            "p90": v[len(v) * 9 // 10], "max": v[-1]}


def block_gaps(calls) -> dict[str, list[float]]:
    """Per-block device gaps of a fused run from its CUDA-event times (ms
    on one clock), given per k-block call as ``{"sweeps": [(before,
    after)] * k, "steps": [after] * (k + 1)}``; step j runs before sweep j
    and step k finalizes the call. Block j's gap ("gap") runs from the end
    of sweep j to the start of sweep j + 1 of the same call; the step
    between them takes its first part ("step"), the symbol copy the rest
    ("copy"; the sweep's own launch lies inside its events). Nothing
    across two calls counts: the host and the calls' first and last steps
    lie there."""
    out = {"gap": [], "step": [], "copy": []}
    for call in calls:
        sweeps, steps = call["sweeps"], call.get("steps")
        for j in range(len(sweeps) - 1):
            end, start = sweeps[j][1], sweeps[j + 1][0]
            out["gap"].append(start - end)
            if steps is not None:
                out["step"].append(steps[j + 1] - end)
                out["copy"].append(start - steps[j + 1])
    return out


def count_syncs(caught) -> int:
    """Warnings of PyTorch's sync debug mode ("called a synchronizing CUDA
    operation") among ``caught``; its first switch to "warn" also warns
    that the mode is a prototype, which does not count."""
    return sum("synchronizing" in str(w.message) for w in caught)


def sync_detector_works(device) -> bool:
    """Whether sync debug mode flags a known synchronizing call here."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.ones(1, device=device).item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return count_syncs(caught) > 0


def phase_fused(device, miner_chain: dict) -> dict:
    """Mines the FUSED_RUNS pins through FusedMiner: an untimed run (tip,
    launches, host waits, hidden syncs flagged by PyTorch, wall) and an
    events run, whose sweeps are bracketed by CUDA events and whose steps
    are followed by one (kernel share; the per-block device gaps and their
    split, ``block_gaps``; the rest of the wall, host head and tail).
    Returns the numbers by (dbits, blocks)."""
    import torch

    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.fused import FusedMiner
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    check(sync_detector_works(device),
          "sync debug mode did not flag .item() on the card")
    results = {}
    for (d, blocks, pow2), k in FUSED_RUNS.items():
        cfg = MinerConfig(difficulty_bits=d, n_blocks=blocks,
                          batch_pow2=pow2, backend="cuda", kernel="cuda",
                          device="cuda")
        pinned = PINNED_TIPS[(d, blocks, pow2)]
        calls = -(-blocks // k)
        row = {}
        for timed in (False, True):
            fm = FusedMiner(cfg, blocks_per_call=k)
            fm.warmup()
            call_events = []
            mine_k = sha256_block.mine_k

            def timed_mine_k(prev, data, *args, **kwargs):
                n = data.shape[0]
                evs = [torch.cuda.Event(enable_timing=True)
                       for _ in range(3 * n + 1)]
                for ev in evs:      # creates each event before the call
                    ev.record()
                call_events.append(evs)
                return mine_k(prev, data, *args, sweep_events=evs[:2 * n],
                              step_events=evs[2 * n:], **kwargs)

            torch.cuda.synchronize()
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
            if timed:
                sha256_block.mine_k = timed_mine_k
            sha256_cuda.launches = sha256_block.step_launches = 0
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        t0 = time.perf_counter()
                        fm.mine_chain()
                        wall = time.perf_counter() - t0
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
            finally:
                sha256_block.mine_k = mine_k
            sweeps, steps = sha256_cuda.launches, sha256_block.step_launches
            torch.cuda.synchronize()
            syncs = count_syncs(caught)
            tip = fm.node.tip_hash.hex()
            check(tip == pinned, f"fused d{d}/n{blocks} tip {tip} != "
                  f"pinned {pinned}")
            check(sweeps == blocks and steps == blocks + calls,
                  f"fused d{d}/n{blocks}: {sweeps} sweeps and {steps} "
                  f"steps, not {blocks} and {blocks + calls}")
            check(fm.host_waits == calls, f"fused d{d}/n{blocks}: "
                  f"{fm.host_waits} host waits for {calls} calls")
            check(syncs == 0, f"fused d{d}/n{blocks}: PyTorch flagged "
                  f"{syncs} synchronizing operations")
            check(fm.recovery is None or fm.recovery.degradations == [],
                  f"fused d{d}/n{blocks}: the recovery search stepped down")
            if timed:
                times = [[origin.elapsed_time(ev) for ev in evs]
                         for evs in call_events]
                split = block_gaps(
                    [{"sweeps": list(zip(t[:2 * (len(t) // 3):2],
                                         t[1:2 * (len(t) // 3):2])),
                      "steps": t[2 * (len(t) // 3):]} for t in times])
                kernel_s = sum(t[2 * j + 1] - t[2 * j] for t in times
                               for j in range(len(t) // 3)) / 1e3
                gaps_s = sum(split["gap"]) / 1e3
                row.update(timed_wall_s=wall, kernel_s=kernel_s,
                           kernel_share=kernel_s / wall,
                           gap_ms=spread(split["gap"]),
                           gap_step_ms=spread(split["step"]),
                           gap_copy_ms=spread(split["copy"]),
                           gaps_s=gaps_s,
                           rest_s=wall - kernel_s - gaps_s)
            else:
                row.update(wall_s=wall, sweeps=sweeps, steps=steps,
                           host_waits=fm.host_waits, calls=calls,
                           hidden_syncs=syncs)
        results[(d, blocks)] = row
        beside = ""
        if (d, blocks) == (24, 1000):
            beside = (f" (pipelined Miner, phase 3: "
                      f"{miner_chain['wall_s']:.6f} s, kernel share "
                      f"{miner_chain['kernel_s'] / miner_chain['wall_s']:.4f})")
        log(f"phase 5 fused d{d}/n{blocks}/b{pow2} at {k} blocks a call: tip "
            f"{tip} matches; wall {row['wall_s']:.6f} s{beside}; "
            f"{row['sweeps']} sweeps, {row['steps']} steps, "
            f"{row['host_waits']} host waits for {calls} calls, "
            f"{row['hidden_syncs']} hidden syncs; events run: wall "
            f"{row['timed_wall_s']:.6f} s, sweeps {row['kernel_s']:.6f} s "
            f"({row['kernel_share']:.4f} of wall), gaps between sweeps in a "
            f"call {row['gaps_s']:.6f} s, rest (host head and tail, calls' "
            f"first and last steps) {row['rest_s']:.6f} s; per-block gap "
            f"(ms) {row['gap_ms']}, of it the step {row['gap_step_ms']} and "
            f"the symbol copy {row['gap_copy_ms']}")
    return results


def phase_resilience(device) -> dict:
    """Phase 6: the resilience layer on the card, (a) to (e) as the module
    docstring says. Returns the numbers."""
    import statistics

    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.backend import backend_from_config
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.resilience.__main__ import (
        smoke_degradation, smoke_kill_resume)

    out: dict = {}
    # (a) wrapped (launch at once, read back when consumed) and raw (the
    # synchronous search_async), in turns.
    cfg = MinerConfig(difficulty_bits=24, n_blocks=1000, batch_pow2=24,
                      backend="cuda", kernel="cuda", device="cuda")
    pinned = PINNED_TIPS[(24, 1000, 24)]
    runs: dict[str, list] = {turn: [] for turn in MINER_TURNS}
    for turn in MINER_TURNS:
        telemetry.reset()
        backend = backend_from_config(cfg, resilient=(turn != "raw"))
        run = mine_timed(Miner(cfg, backend=backend, pipeline=True))
        run["span_ms_per_block"] = span_ms_per_block(1000)
        runs[turn].append(run)
        check(run["launches"] == run["searches"] == 1000,
              f"6a {turn}: {run['launches']} launches, {run['searches']} "
              f"searches")
        if turn != "raw":
            check(backend.rung == "cuda:cuda" and backend.degradations == []
                  and telemetry.default_registry().total("retries_total")
                  == 0, f"6a wrapped: rung {backend.rung}, degradations "
                  f"{backend.degradations}")
    for turn, rs in runs.items():
        for r in rs:
            check(r["tip_hash"] == pinned, f"6a {turn}: tip {r['tip_hash']}")
        wall = statistics.median(r["wall_s"] for r in rs)
        kernel = statistics.median(r["kernel_s"] for r in rs)
        out[f"miner_d24_n1000_{turn}"] = {
            "wall_s": [r["wall_s"] for r in rs],
            "kernel_s": [r["kernel_s"] for r in rs],
            "kernel_share": [r["kernel_s"] / r["wall_s"] for r in rs],
            "host_ms_per_block": [host_ms_per_block(r, 1000) for r in rs],
            "span_ms_per_block": [r["span_ms_per_block"] for r in rs],
            "clocks": [r["clocks"] for r in rs]}
        log(f"phase 6a d24/n1000 pipelined Miner, {turn}: walls "
            f"{[round(r['wall_s'], 6) for r in rs]} s (median {wall:.6f}), "
            f"sweeps {[round(r['kernel_s'], 6) for r in rs]} s, kernel "
            f"share {[round(r['kernel_s'] / r['wall_s'], 4) for r in rs]}, "
            f"host time a block "
            f"{[round(host_ms_per_block(r, 1000), 4) for r in rs]} ms "
            f"(median wall minus median sweeps: "
            f"{(wall - kernel) / 1000 * 1e3:.4f} ms); by span, ms a block: "
            f"{[{k: round(v, 6) for k, v in r['span_ms_per_block'].items()} for r in rs]}")
    cost = out["telemetry_us_per_block"] = telemetry_us_per_block()
    log(f"phase 6a the Miner's per-block telemetry (_count_sweep and "
        f"_finalize_block, {TELEMETRY_CALLS} calls, in turns on, off, off, "
        f"on): {cost['on']:.4f} us a block on, {cost['off']:.4f} off, "
        f"{cost['cost']:.4f} us for the counters, heartbeats and histogram")

    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        # (b) every CUDA dispatch killed: cuda:cuda -> cuda:torch -> cpu.
        telemetry.reset()
        got = smoke_degradation(tmp, device=device.type)
        steps = telemetry.default_registry().total(
            "backend_degradations_total")
        check(steps == 2, f"6b: {steps} step-downs, not 2")
        out["step_down"] = {"rung": got["degraded"]["rung"],
                            "step_downs": steps,
                            "tip_hash": got["degraded"]["tip_hash"]}
        log(f"phase 6b dead CUDA dispatch (d8/n2/b11): rc 0, {steps} "
            f"step-downs to {got['degraded']['degraded_to']}, tip "
            f"{got['degraded']['tip_hash']} == the --backend cpu oracle's")

        # (c) a corrupt winner at the first dispatch: one retry, same rung.
        plan = tmp / "corrupt.json"
        plan.write_text(json.dumps(fault_plan("backend.cuda.dispatch",
                                              "corrupt")))
        telemetry.reset()
        rc, summary = run_cli(["mine", "--difficulty", "20", "--blocks",
                               "10", "--batch-pow2", "20", "--fault-plan",
                               str(plan)])
        reg = telemetry.default_registry()
        retries, corrupt = reg.total("retries_total"), \
            reg.total("corrupt_results_total")
        check(rc == 0 and summary.get("tip_hash") == PINNED_TIPS[
            (20, 10, 20)], f"6c: rc {rc}, summary {summary}")
        check_no_step_down(summary, "cuda:cuda", "6c")
        check(retries == 1 and corrupt == 1,
              f"6c: {retries} retries, {corrupt} corrupt results, not 1")
        out["corrupt_retried"] = {"retries": retries, "rung":
                                  summary["rung"]}
        log(f"phase 6c corrupt winner at call 0 (d20/n10): {corrupt} caught "
            f"by re-validation, {retries} retry, rung {summary['rung']}, "
            f"tip {summary['tip_hash']} matches the pin")

        # (d) no nvcc: the top rung's kernel cannot build.
        metrics = tmp / "no_nvcc.prom"
        env = without_nvcc(dict(os.environ), str(tmp / "no_cuda_home"))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p)
        proc = subprocess.run(
            [sys.executable, "-m", "mpi_blockchain_tpu_torch", "mine",
             "--difficulty", "8", "--blocks", "1", "--metrics-dump",
             str(metrics)], capture_output=True, text=True, env=env,
            cwd=str(tmp), timeout=300)
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        err = json.loads(lines[-1]) if lines else {}
        text = metrics.read_text() if metrics.exists() else ""
        retries = metric_total(text, "retries_total")
        steps = metric_total(text, "backend_degradations_total")
        check(proc.returncode == 2 and err.get("kind") == "kernel"
              and "nvcc" in err.get("error", ""),
              f"6d: rc {proc.returncode}, stdout {proc.stdout[-400:]!r}, "
              f"stderr {proc.stderr[-800:]!r}")
        check(metrics.exists() and retries == 0 and steps == 0,
              f"6d: metrics dump {metrics.exists()}, {retries} retries, "
              f"{steps} step-downs")
        out["no_nvcc"] = {"rc": proc.returncode, "retries": retries,
                          "step_downs": steps}
        log(f"phase 6d no nvcc: rc {proc.returncode}, {err}, {retries:.0f} "
            f"retries, {steps:.0f} step-downs")

        # (e) SIGKILL mid-run, resume, verify.
        kill_dir = tmp / "kill"
        kill_dir.mkdir()
        got = smoke_kill_resume(kill_dir, device=device.type,
                                difficulty=20, blocks=10)
        check(got["tip_hash"] == PINNED_TIPS[(20, 10, 20)],
              f"6e: resumed tip {got['tip_hash']}")
        out["kill_resume"] = got
        log(f"phase 6e d20 mine --checkpoint-every 1 SIGKILLed after "
            f"{got['mined_before_kill']} blocks (checkpoint at height "
            f"{got['checkpoint_height']}), resumed to {got['resumed_to']}, "
            f"verified, tip matches the pin; torn tail truncated to "
            f"{got['torn_truncated_to']} and re-mined")
    return out


def telemetry_us_per_block(n: int = TELEMETRY_CALLS) -> dict[str, float]:
    """The host time of the ``Miner``'s per-block telemetry on this
    machine, in us a block: its ``_count_sweep`` (one consumed sweep a
    block at d24) and ``_finalize_block``, ``n`` times with the telemetry
    on and off (the kill switch: the helpers hand out the null metric), in
    turns on, off, off, on, medians. ``cost`` is on minus off: what the
    counters, the heartbeats and the latency histogram cost a block."""
    import statistics

    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import BlockRecord, Miner

    miner = Miner(MinerConfig(difficulty_bits=8, n_blocks=1, backend="cpu"),
                  backend=CpuBackend())
    rec = BlockRecord(height=1, nonce=0, hash="00" * 32, wall_ms=2.7,
                      hashes_tried=1 << 24)
    times: dict[str, list[float]] = {"on": [], "off": []}
    for label in ("on", "off", "off", "on"):
        prev = telemetry.set_telemetry_disabled(label == "off")
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                miner._count_sweep("cuda", 1 << 24)
                miner._finalize_block(rec, "cuda")
            times[label].append((time.perf_counter() - t0) / n * 1e6)
        finally:
            telemetry.set_telemetry_disabled(prev)
        miner.records.clear()
    on, off = (statistics.median(times[k]) for k in ("on", "off"))
    return {"on": on, "off": off, "cost": on - off}


def host_ms_per_block(run: dict, blocks: int) -> float:
    """The wall that is not sweep time, per block, in ms."""
    return (run["wall_s"] - run["kernel_s"]) / blocks * 1e3


def span_ms_per_block(blocks: int) -> dict[str, float]:
    """Milliseconds a block each of SPAN_NAMES took in the run since the
    last ``telemetry.reset()`` (``span_seconds`` sums)."""
    from mpi_blockchain_tpu_torch import telemetry

    return {name: telemetry.span_seconds(name) / blocks * 1e3
            for name in SPAN_NAMES}


def chain_nonces(blob: bytes) -> list[int]:
    """The nonces of a chain file's blocks after genesis (the header's last
    four bytes, little-endian)."""
    return [int.from_bytes(blob[h + 76:h + 80], "little")
            for h in range(80, len(blob), 80)]


def mesh_hashes_tried(nonces: list[int], round_size: int) -> int:
    """The reference's ``hashes_tried`` for a chain whose blocks were each
    searched from nonce 0 over the whole space at ``round_size``."""
    from mpi_blockchain_tpu_torch.backend.cuda import reference_hashes_tried

    return sum(reference_hashes_tried(0, NONCE_SPACE, round_size, n)
               for n in nonces)


def last_block(stderr: str) -> dict:
    """The last ``block_mined`` line a ``mine --verbose`` printed."""
    blocks = [json.loads(ln) for ln in stderr.splitlines()
              if '"block_mined"' in ln]
    return blocks[-1] if blocks else {}


def phase_wedge(device) -> dict:
    """Phase 6 (f): the bound on a wedged dispatch, on the card."""
    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.backend import backend_from_config
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models import miner as miner_mod

    import torch

    miner = miner_mod.Miner(MinerConfig(difficulty_bits=64, n_blocks=1,
                                        batch_pow2=20), pipeline=True)
    budget, miner_mod.DISPATCH_TIMEOUT_S = miner_mod.DISPATCH_TIMEOUT_S, \
        WEDGE_BUDGET_S
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        miner.mine_chain()
        raise SmokeFailure("6f: a sweep that cannot finish in the budget "
                           "returned")
    except RuntimeError as e:
        took = time.perf_counter() - t0
        check("dispatch wedged" in str(e), f"6f: {e}")
    finally:
        miner_mod.DISPATCH_TIMEOUT_S = budget
    hdr = bytes(range(80))
    t1 = time.perf_counter()
    got = backend_from_config(MinerConfig(difficulty_bits=20)).search(hdr, 20)
    after = time.perf_counter() - t1
    torch.cuda.synchronize()
    sweep_left = time.perf_counter() - t0
    nonce, _ = core.cpu_search(hdr, 0, NONCE_SPACE, 20)
    check(got.nonce == nonce, f"6f: the search after the wedge found "
          f"{got.nonce}, the C++ sweep {nonce}")
    check(WEDGE_BUDGET_S <= took < 6 * WEDGE_BUDGET_S,
          f"6f: raised after {took:.4f} s for a {WEDGE_BUDGET_S} s budget")
    log(f"phase 6f wedged sweep (early exit over [0, 2^32) at dbits 64): "
        f"'dispatch wedged' raised after {took:.6f} s for a "
        f"{WEDGE_BUDGET_S} s budget; the next search (d20) returned nonce "
        f"{got.nonce} == the C++ sweep's after {after:.6f} s, behind the "
        f"wedged sweep ({sweep_left:.6f} s from the start to the card "
        f"idle)")
    return {"raised_after_s": took, "budget_s": WEDGE_BUDGET_S,
            "next_search_s": after, "next_search_nonce": got.nonce}


def phase_bench(device, fused: dict) -> dict:
    """Phase 7: the bench library on the card. Returns the payloads."""
    from mpi_blockchain_tpu_torch import bench_lib
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    card = nvidia_smi("name,power.limit")
    out: dict = {"sweep": {}}
    for n in BENCH_MINERS:
        with ClockSampler() as clocks:
            got = bench_lib.bench_cuda(seconds=BENCH_SECONDS, n_miners=n,
                                       device=device)
        check(got["kernel"] == "cuda" and "kernel_ms" in got
              and "bound_ms" in got, f"7 sweep m{n}: {got}")
        check(got["bound_ms"] <= got["kernel_ms"],
              f"7 sweep m{n}: a call took {got['kernel_ms']:.4f} ms, under "
              f"its bound {got['bound_ms']:.4f} ms")
        got["clocks"] = clocks.summary()
        out["sweep"][n] = got
        log(f"phase 7 bench --mode sweep, {n} logical miner(s), 2^"
            f"{got['batch_pow2']} x {n} nonces a call, {got['calls']} calls "
            f"in {got['wall_s']} s: hashes_per_sec {got['hashes_per_sec']!r}"
            f", kernel_ms {got['kernel_ms']!r} (median of one call), "
            f"bound_ms {got['bound_ms']!r} ({got['bound_ms'] / got['kernel_ms']:.4f}"
            f" of it); {card}; card during the run {got['clocks']}")

    sha256_cuda.launches = sha256_block.step_launches = 0
    chain = bench_lib.bench_chain(n_blocks=1000, difficulty_bits=24,
                                  batch_pow2=24, blocks_per_call=100,
                                  device=device)
    sweeps, steps = sha256_cuda.launches, sha256_block.step_launches
    check(chain["tip_hash"] == PINNED_TIPS[(24, 1000, 24)],
          f"7 chain: tip {chain['tip_hash']}")
    check(sweeps == 1000 and steps == 1010,
          f"7 chain: {sweeps} sweeps and {steps} steps")
    best = bench_lib.repeat_best(
        lambda: bench_lib.bench_chain(n_blocks=1000, difficulty_bits=24,
                                      batch_pow2=24, blocks_per_call=100,
                                      device=device),
        reps=2, key="wall_s", minimize=True, prior=[chain])
    out["chain"] = {**best, "sweeps": sweeps, "steps": steps}
    log(f"phase 7 bench --mode chain d24/n1000/b24 at 100 blocks a call: "
        f"tip {chain['tip_hash']} matches the pin; walls "
        f"{best['all_wall_s']} s (best {best['wall_s']}, spread "
        f"{best['spread_pct']}%), {sweeps} sweeps and {steps} steps in the "
        f"first; fused d24/n1000 in phase 5: {fused['wall_s']:.6f} s; "
        f"{card}")

    sharded = bench_lib.bench_sharded(device=device)
    check(sharded["tip_hash"] == PINNED_TIPS[(16, 30, 20)]
          and sharded["tip_matches_cpu_oracle"],
          f"7 sharded: {sharded}")
    out["sharded"] = sharded
    single = bench_lib.bench_cuda_single(device=device)
    check(single["tip_hash"] == PINNED_TIPS[(20, 10, 20)]
          and single["tip_matches_cpu_oracle"], f"7 single: {single}")
    out["single"] = single
    log(f"phase 7 bench_sharded d16/n30/b20 at 10 a call: tip matches the "
        f"pin and the C++ oracle, wall {sharded['wall_s']} s; "
        f"bench_cuda_single d20/n10/b20 (pipelined Miner): tip matches, "
        f"wall {single['wall_s']} s, {single['hashes_per_sec']} hashes/s "
        f"(reference accounting); {card}")
    return out


def phase_mesh(device, miner_chain: dict, fused: dict,
               d20_wall: float) -> dict:
    """Phase 8: winner-select. Returns the numbers."""
    from mpi_blockchain_tpu_torch import core, telemetry
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    card = nvidia_smi("name,power.limit")
    out: dict = {}
    pinned = PINNED_TIPS[(24, 1000, 24)]
    with tempfile.TemporaryDirectory() as td:
        for form, extra in (("miner", []),
                            ("fused", ["--fused", "--blocks-per-call",
                                       "100"])):
            chain_file = os.path.join(td, f"{form}.bin")
            telemetry.reset()
            sha256_cuda.launches = sha256_block.step_launches = 0
            t0 = time.perf_counter()
            rc, summary = run_cli(["mine", "--preset", "tpu-mesh8",
                                   "--out", chain_file, *extra])
            wall = time.perf_counter() - t0
            sweeps, steps = sha256_cuda.launches, sha256_block.step_launches
            check(rc == 0 and summary.get("tip_hash") == pinned,
                  f"8 tpu-mesh8 {form}: rc {rc}, {summary}")
            check(summary["config"]["n_miners"] == 8,
                  f"8 tpu-mesh8 {form}: {summary['config']}")
            with open(chain_file, "rb") as f:
                blob = f.read()
            check(core.Node(summary["config"]["difficulty_bits"]).load(blob),
                  f"8 {form}: chain invalid")
            row = {"wall_s": summary["wall_s"], "cli_wall_s": wall,
                   "sweeps": sweeps, "steps": steps,
                   "tip_hash": summary["tip_hash"]}
            if form == "miner":
                want = mesh_hashes_tried(chain_nonces(blob), MESH8_ROUND)
                check(summary["hashes_tried"] == want,
                      f"8 tpu-mesh8: hashes_tried {summary['hashes_tried']}"
                      f", the reference's accounting {want}")
                check(sweeps == 1000, f"8 tpu-mesh8: {sweeps} launches")
                check_no_step_down(summary, "cuda:cuda", "8 tpu-mesh8")
                row["hashes_tried"] = want
                beside = (f"pipelined Miner m1 (phase 3): "
                          f"{miner_chain['wall_s']:.6f} s")
            else:
                check(sweeps == 1000 and steps == 1010,
                      f"8 tpu-mesh8 fused: {sweeps} sweeps, {steps} steps")
                beside = f"fused m1 (phase 5): {fused['wall_s']:.6f} s"
            out[form] = row
            log(f"phase 8 mine --preset tpu-mesh8 ({form}, d24/n1000/b20, "
                f"8 logical miners): tip matches the d24/n1000 pin; wall "
                f"{summary['wall_s']} s (the CLI call {wall:.6f} s) beside "
                f"the {beside}; {sweeps} sweeps, {steps} steps"
                + (f"; hashes_tried {summary['hashes_tried']} == the "
                   f"reference's at rounds of 2^23"
                   if form == "miner" else "") + f"; {card}")

        out["world"] = two_process_world(td, d20_wall)
    return out


def world_argv(chain: tuple, extra: list[str], port: int,
               rank: int) -> list[str]:
    """The command line of rank ``rank`` of a two-rank ``mine`` world at
    ``chain`` (``WORLD_ARGS``' flags) with ``extra`` flags: the CLI through
    ``WORLD_COUNTING_ENTRY``, with ``--verbose``, and Python's fault
    handler, so that a rank that hangs dumps its threads' stacks on
    SIGABRT."""
    return [sys.executable, "-X", "faulthandler", *WORLD_COUNTING_ENTRY,
            "mine", *chain, *extra,
            "--verbose", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(rank)]


def gloo_world(td: str, extra: list[str], what: str,
               chain: tuple = WORLD_ARGS, pin: tuple = (20, 10, 20)
               ) -> tuple[dict, list[tuple[str, str]], float]:
    """Two ``mine`` processes sharing the card over gloo at the chain
    ``chain`` (``--difficulty``, ``--blocks`` and ``--batch-pow2``) whose
    tip is ``PINNED_TIPS[pin]``, with ``extra`` flags: both exit 0 at the
    pinned tip, rank 0 alone prints the summary, on the card's kernel (the
    plain version where ``extra`` asks for ``--device cpu``). Returns rank
    0's summary, each rank's (stdout, stderr) (its launches:
    ``rank_counts``) and the wall of the whole launch."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    # Each rank's output goes to files: pipes read one rank after the
    # other fill on the rank read last, which then blocks mid-run (a
    # block_mined line a block) and the world's collectives with it; and
    # a rank that hangs still shows what it printed.
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        world_argv(chain, extra, port, rank), stdout=out, stderr=err,
        text=True, env=env, cwd=td) for rank, (out, err) in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + 300 - time.perf_counter()))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGABRT)     # the stacks, then death
        time.sleep(2.0)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    spawn_wall = time.perf_counter() - t0
    got = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        got.append((out.read(), err.read()))
        out.close()
        err.close()
    rcs = [p.returncode for p in procs]
    check(rcs == [0, 0], f"{what}: rcs {rcs}; "
          f"{[e[-1500:] for _, e in got]}")
    pinned = PINNED_TIPS[pin]
    summary = json.loads(got[0][0].strip().splitlines()[-1])
    tips = [last_block(err).get("hash") for _, err in got]
    check(summary["tip_hash"] == pinned and tips == [pinned, pinned],
          f"{what}: summary tip {summary['tip_hash']}, ranks' tips {tips}")
    check(got[1][0].strip() == "", f"{what}: rank 1 printed "
          f"{got[1][0][-300:]!r}")
    check(summary["config"]["n_miners"] == 2, f"{what}: {summary}")
    kernel = "torch" if "cpu" in extra else "cuda"
    if summary["fused"]:
        check(summary["kernel"] == kernel, f"{what}: {summary}")
    else:
        check_no_step_down(summary, f"cuda:{kernel}", what)
    return summary, got, spawn_wall


def two_process_world(td: str, d20_wall: float) -> dict:
    """Two ``mine`` processes sharing the card over gloo, d20/n10/b20."""
    chain_file = os.path.join(td, "world.bin")
    summary, _, spawn_wall = gloo_world(td, ["--out", chain_file],
                                        "8 world")
    from mpi_blockchain_tpu_torch import core
    with open(chain_file, "rb") as f:
        check(core.Node(summary["config"]["difficulty_bits"]).load(f.read()),
              "8 world: chain invalid")
    log(f"phase 8 two processes over gloo on one card (d20/n10/b20): both "
        f"ranks reach the pinned tip {PINNED_TIPS[(20, 10, 20)]}, rank 0 "
        f"alone wrote the chain and the summary; wall {summary['wall_s']} s "
        f"(rank 0's mine_chain; the whole launch {spawn_wall:.3f} s) beside "
        f"one process's {d20_wall} s (phase 3); hashes_tried "
        f"{summary['hashes_tried']}, rung {summary['rung']}")
    return {"wall_s": summary["wall_s"], "launch_wall_s": spawn_wall,
            "single_process_wall_s": d20_wall,
            "hashes_tried": summary["hashes_tried"], "rung": summary["rung"]}


def bounded_search_cases(rng) -> list[tuple[bytes, int, int, int]]:
    """(header, dbits, start, count) of the bounded early-exit searches a
    simulation group makes (``SimNode.mine_step``): every budget of
    ``SIM_BOUNDED_COUNTS`` at every dbits of ``SIM_BOUNDED_DBITS``,
    starting at 0, at an odd multiple of the budget, right below 2^32 (the
    range ends at 2^32), and past it (``CudaBackend.launch`` clamps the
    range to 2^32, so the launch's count is a ragged part of the budget),
    each with a seeded random header and, where one is found in the
    tries, a header with a winner in the range."""
    from mpi_blockchain_tpu_torch import core

    cases = []
    for d in SIM_BOUNDED_DBITS:
        for count in SIM_BOUNDED_COUNTS:
            starts = (0, count * (2 * int(rng.integers(1, 1 << 16)) + 1),
                      NONCE_SPACE - count,
                      NONCE_SPACE - max(1, count // 2 - 1))
            for start in starts:
                n = min(start + count, NONCE_SPACE) - start
                cases.append((random_header(rng), d, start, n))
                with contextlib.suppress(SmokeFailure):
                    cases.append((find_header(
                        rng, lambda h: core.cpu_search(h, start, n, d)[0]
                        is not None, tries=4000), d, start, n))
    return cases


def bounded_vs_plain(cases, device) -> tuple[int, int, int]:
    """The kernel against the plain version on the card, and both against
    the C++ ``cpu_search``, over ``cases`` with and without the early exit.
    Returns (comparisons, mismatches, cases with a winner)."""
    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda, sha256_torch
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    compared = mismatches = winners = 0
    for hdr, d, start, n in cases:
        ext = extend_midstate(*core.header_midstate(hdr))
        ext_t = torch.as_tensor(ext.astype(np.int64), device=device)
        oracle, _ = core.cpu_search(hdr, start, n, d)
        winners += oracle is not None
        for early_exit in (False, True):
            k = sha256_cuda.sweep(ext, start, n, d, device=device,
                                  early_exit=early_exit)
            p = sha256_torch.sweep_core_ext(ext_t, start, n, d,
                                            early_exit=early_exit)
            found = k[1] if k[0] > 0 else None
            same = found == oracle and (k == p if not early_exit else
                                        (k[0] > 0) == (p[0] > 0)
                                        and k[1] == p[1])
            compared += 1
            if not same:
                mismatches += 1
                log(f"MISMATCH bounded dbits={d} start={start:#x} count={n} "
                    f"early_exit={early_exit}: kernel {k} plain {p} "
                    f"cpu_search {oracle}")
    return compared, mismatches, winners


def sim_search_shape(rng, device) -> dict:
    """Phase 9 (a)'s search shape on its own: ``SIM_SHAPE_LAUNCHES``
    early-exit launches of ``SIM_SHAPE_NONCES`` nonces at
    ``SIM_SHAPE_DBITS``, each over its own range into its own result
    buffer, between one pair of CUDA events. They are enqueued behind a
    sweep of ``SIM_SHAPE_BLOCKER`` nonces that nothing qualifies in, so
    the card does not wait on the host between them as long as the host
    enqueues them all before that sweep ends (``card_bound``); then the
    events time the launches alone, one after another on the card. Where
    the host fell behind, the events hold its enqueue time, and
    ``launch_ms`` is None. Beside it the host's time to enqueue one, the
    bound from the function's work, and the plain version's time for one
    such search on the card (median of 20)."""
    import statistics

    import numpy as np
    import torch

    from mpi_blockchain_tpu_torch import bench_lib, core
    from mpi_blockchain_tpu_torch.ops import sha256_cuda, sha256_torch
    from mpi_blockchain_tpu_torch.ops.sha256_sched import extend_midstate

    n, d = SIM_SHAPE_NONCES, SIM_SHAPE_DBITS
    ext = extend_midstate(*core.header_midstate(random_header(rng)))
    outs = sha256_cuda.new_result(device).repeat(SIM_SHAPE_LAUNCHES, 1)
    sha256_cuda.launch(ext, 0, n, d, outs[0].clone(), early_exit=True)
    blocked, start, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
    torch.cuda.synchronize()
    blocked.record()
    sha256_cuda.launch(ext, 0, SIM_SHAPE_BLOCKER, SIM_SHAPE_BLOCKER_DBITS,
                       sha256_cuda.new_result(device))
    start.record()
    t0 = time.perf_counter()
    for i in range(SIM_SHAPE_LAUNCHES):
        sha256_cuda.launch(ext, i * n, n, d, outs[i], early_exit=True)
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    ext_t = torch.as_tensor(ext.astype(np.int64), device=device)
    plain = []
    for i in range(20):
        t0 = time.perf_counter()
        sha256_torch.sweep_core_ext(ext_t, i * n, n, d, early_exit=True)
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t0)
    card_bound = 1e3 * enqueue_s < blocked.elapsed_time(start)
    return {"launch_ms": (start.elapsed_time(end) / SIM_SHAPE_LAUNCHES
                          if card_bound else None),
            "enqueue_ms": 1e3 * enqueue_s / SIM_SHAPE_LAUNCHES,
            "card_bound": card_bound,
            "bound_ms": bench_lib.sweep_bound_ms(n, d, device),
            "plain_ms": 1e3 * statistics.median(plain)}


def sim_run(argv: list[str], workdir: str, name: str,
            timed: bool = False) -> dict:
    """Runs ``sim`` through the port's CLI with the kernels' launch counts
    set to 0 just before and read just after, and the run's causal dump
    written to ``workdir``. With ``timed``, CUDA events around every sweep
    launch give the sweeps' time. Returns rc, the summary, the wall, the
    launches, the dump's sha256 and the host spans a search goes through."""
    import hashlib

    import torch

    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    dump = os.path.join(workdir, f"{name}.json")
    launch, events = sha256_cuda.launch, []

    def timed_launch(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        launch(*args, **kwargs)
        ev[1].record()
        events.append(ev)

    telemetry.reset()
    torch.cuda.synchronize()
    if timed:
        sha256_cuda.launch = timed_launch
    sha256_cuda.launches = sha256_block.step_launches = 0
    try:
        t0 = time.perf_counter()
        rc, summary = run_cli(["sim", *argv, "--events-dump", dump])
        wall = time.perf_counter() - t0
    finally:
        sha256_cuda.launch = launch
    launches, steps = sha256_cuda.launches, sha256_block.step_launches
    torch.cuda.synchronize()
    with open(dump, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"rc": rc, "summary": summary, "wall_s": wall,
            "launches": launches, "step_launches": steps,
            "kernel_s": (sum(a.elapsed_time(b) for a, b in events) / 1e3
                         if timed else None),
            "dump_sha256": digest,
            "retries": telemetry.default_registry().total("retries_total"),
            "dispatch_s": telemetry.span_seconds("backend.cuda.dispatch"),
            "host_tail_s": telemetry.span_seconds("backend.cuda.host_tail"),
            "cpu_search_s": telemetry.span_seconds("backend.cpu.search")}


def check_sim_pin(run: dict, pin: dict, what: str) -> None:
    """Fails unless a ``sim`` run exited 0 with the pinned summary and
    causal dump, and no search was retried."""
    got = {k: run["summary"].get(k) for k in pin if k != "dump_sha256"}
    want = {k: v for k, v in pin.items() if k != "dump_sha256"}
    check(run["rc"] == 0 and got == want,
          f"{what}: rc {run['rc']}, {run['summary']} is not the pin {want}")
    check(run["dump_sha256"] == pin["dump_sha256"],
          f"{what}: causal dump sha256 {run['dump_sha256']} is not the "
          f"pin's {pin['dump_sha256']}")
    check(run["retries"] == 0, f"{what}: {run['retries']} retries")


def phase_sim(device) -> dict:
    """Phase 9: the adversarial simulation on the card through ``sim``.
    Returns its numbers."""
    import numpy as np

    from mpi_blockchain_tpu_torch import bench_lib
    from mpi_blockchain_tpu_torch.resilience.__main__ import \
        smoke_determinism
    from mpi_blockchain_tpu_torch.telemetry import flight_recorder

    card = nvidia_smi("name,power.limit")
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) config 5 as users run it: every group's search is one launch.
        preset = sim_run(["--preset", "adversarial"], tmp, "preset")
        check_sim_pin(preset, SIM_PRESET_PIN, "9a sim --preset adversarial")
        searches = 2 * preset["summary"]["steps"]
        check(preset["launches"] == searches
              and preset["step_launches"] == 0,
              f"9a: {preset['launches']} sweep launches and "
              f"{preset['step_launches']} step launches for {searches} "
              f"searches: not every search ran the kernel on cuda:cuda")
        cpp = sim_run(["--difficulty", "16", "--blocks", "20",
                       "--backend", "cpu"], tmp, "preset_cpu")
        check_sim_pin(cpp, SIM_PRESET_PIN, "9a on --backend cpu")
        shape = sim_search_shape(np.random.default_rng(20261019), device)
        out["preset"] = {
            **{f"shape_{k}": v for k, v in shape.items()},
            "wall_s": preset["wall_s"], "launches": preset["launches"],
            "step_launches": preset["step_launches"],
            "host_ms_per_search": 1e3 * preset["wall_s"] / searches,
            "dispatch_ms_per_search": 1e3 * preset["dispatch_s"] / searches,
            "host_tail_ms_per_search":
                1e3 * preset["host_tail_s"] / searches,
            "cpp_wall_s": cpp["wall_s"],
            "cpp_ms_per_search": 1e3 * cpp["cpu_search_s"] / searches}
        a = out["preset"]
        shape_on_card = ("not measured (the host fell behind the card)"
                         if a["shape_launch_ms"] is None
                         else f"{a['shape_launch_ms']:.6f} ms")
        log(f"phase 9a sim --preset adversarial (d16, 20 blocks, 2 groups, "
            f"budget 2^8): pinned tips, steps {preset['summary']['steps']}, "
            f"heights, stats and dump sha256; not degraded; "
            f"{a['launches']} sweep launches for {searches} searches "
            f"(cuda:cuda on every group); wall {a['wall_s']:.6f} s, host "
            f"{a['host_ms_per_search']:.6f} ms a search (of it "
            f"backend.cuda.dispatch {a['dispatch_ms_per_search']:.6f} ms, "
            f"host_tail {a['host_tail_ms_per_search']:.6f} ms); "
            f"--backend cpu (the C++ sweep on this machine's CPU): "
            f"wall {a['cpp_wall_s']:.6f} s, cpu search "
            f"{a['cpp_ms_per_search']:.6f} ms a search; the search shape "
            f"(2^8 nonces, dbits 16) back to back behind a 2^30 sweep "
            f"(queue ahead of the card: {a['shape_card_bound']}): "
            f"{shape_on_card} a launch on the card, "
            f"{a['shape_enqueue_ms']:.6f} ms a launch to enqueue, bound "
            f"{a['shape_bound_ms']:.9f} ms, plain version "
            f"{a['shape_plain_ms']:.6f} ms; {card}")

        # (b) full width: every search a 2^24 sweep; forks and reorgs.
        d24 = sim_run(list(SIM_D24_ARGS), tmp, "d24", timed=True)
        check_sim_pin(d24, SIM_D24_PIN, "9b sim d24/2^24")
        searches = 2 * d24["summary"]["steps"]
        check(d24["launches"] == searches and d24["step_launches"] == 0,
              f"9b: {d24['launches']} launches for {searches} searches")
        out["d24"] = {"wall_s": d24["wall_s"], "launches": d24["launches"],
                      "step_launches": d24["step_launches"],
                      "kernel_s": d24["kernel_s"],
                      "kernel_share": d24["kernel_s"] / d24["wall_s"],
                      "host_ms_per_search": 1e3 * d24["wall_s"] / searches,
                      "reorgs": sum(st["reorgs"]
                                    for st in d24["summary"]["stats"])}
        b = out["d24"]
        log(f"phase 9b sim {' '.join(SIM_D24_ARGS)}: pinned tips, steps "
            f"{d24['summary']['steps']}, heights, stats ({b['reorgs']} "
            f"reorgs) and dump sha256; {b['launches']} sweep launches; wall "
            f"{b['wall_s']:.6f} s, sweeps {b['kernel_s']:.6f} s "
            f"({b['kernel_share']:.6f} of the wall); {card}")

        # (c) the vectorized engine: host numpy in both packages.
        rc, vec = run_cli(["sim", "--preset", "adversarial-bench"])
        check(rc == 0 and {k: vec[k] for k in SIM_BENCH_PIN}
              == SIM_BENCH_PIN, f"9c sim --preset adversarial-bench: {vec}")
        best = bench_lib.repeat_best(bench_lib.bench_sim_adversarial,
                                     reps=2, key="steps_per_sec")
        check({k: best[k] for k in SIM_BENCH_PIN} == SIM_BENCH_PIN,
              f"9c bench_sim_adversarial: {best}")
        out["vec"] = {"cli_steps_per_sec": vec["steps_per_sec"],
                      "steps_per_sec": best["steps_per_sec"],
                      "all_steps_per_sec": best["all_steps_per_sec"],
                      "wall_s": best["wall_s"]}
        log(f"phase 9c sim --preset adversarial-bench: summary matches the "
            f"reference's pin {SIM_BENCH_PIN}; steps_per_sec (host time on "
            f"this GPU machine's CPU; the engine has no device path) "
            f"{vec['steps_per_sec']!r} through the CLI, bench_sim_adversarial "
            f"best of 2 {best['steps_per_sec']!r} (all "
            f"{best['all_steps_per_sec']})")

        # (d) one fixed-seed fault plan: byte-identical dumps on the card,
        # equal to the C++ sweep's and to the reference's.
        tmp_d = pathlib.Path(tmp)
        on_card = smoke_determinism(tmp_d, device="cuda")
        on_cpu = smoke_determinism(tmp_d, device="cpu")
        check(on_card["sha256"] == on_cpu["sha256"]
              == SIM_DETERMINISM_SHA256,
              f"9d determinism: card {on_card['sha256']}, cpu "
              f"{on_cpu['sha256']}, reference {SIM_DETERMINISM_SHA256}")
        out["determinism_sha256"] = on_card["sha256"]
        log(f"phase 9d smoke_determinism: the faulted sim's causal dump "
            f"({on_card['dump_bytes']} bytes) is byte-identical across 2 "
            f"runs on the card and equal to the --backend cpu runs' and the "
            f"reference's (sha256 {on_card['sha256']})")

        # (e) a run that cannot converge: rc 1, the recorder dumps.
        fr = os.path.join(tmp, "flight.json")
        try:
            never = sim_run([*SIM_NEVER_ARGS, "--flight-recorder", fr], tmp,
                            "never")
        finally:
            flight_recorder.uninstall()
        check(never["rc"] == 1 and never["summary"]
              == SIM_NEVER_PIN["summary"]
              and never["dump_sha256"] == SIM_NEVER_PIN["dump_sha256"]
              and never["retries"] == 0,
              f"9e: rc {never['rc']}, {never['summary']}, dump "
              f"{never['dump_sha256']}")
        check(never["launches"] == 2 * 10_000,
              f"9e: {never['launches']} launches for 20000 searches")
        with open(fr) as f:
            recorded = json.load(f)
        check(recorded["reason"].startswith("sim non-convergence")
              and set(recorded["causal"]) == {"0", "1", "bus"}
              and all(recorded["causal"].values()),
              f"9e flight recorder: {recorded['reason']!r}, causal logs "
              f"{sorted(recorded['causal'])}")
        out["never"] = {"wall_s": never["wall_s"],
                        "launches": never["launches"]}
        log(f"phase 9e sim {' '.join(SIM_NEVER_ARGS)} on the card: rc 1, "
            f"the pinned sim_done line and dump, a flight-recorder dump with "
            f"the causal logs of both groups and the bus; "
            f"{never['launches']} launches in {never['wall_s']:.6f} s")

    # (f) the kernel at the budgets the simulation gives it.
    cases = bounded_search_cases(np.random.default_rng(20261018))
    compared, mismatches, winners = bounded_vs_plain(cases, device)
    check(mismatches == 0, f"9f: {mismatches} bounded-search mismatches")
    out["bounded"] = {"cases": len(cases), "compared": compared,
                      "mismatches": mismatches, "with_winner": winners}
    log(f"phase 9f bounded searches (counts {SIM_BOUNDED_COUNTS}, dbits "
        f"{SIM_BOUNDED_DBITS}; starts 0, an odd multiple of the budget, "
        f"2^32 - count and a range clamped at 2^32): {len(cases)} cases "
        f"({winners} with a winner), {compared} comparisons of kernel, "
        f"plain version and cpu_search, mismatches {mismatches}. Phase 1 "
        f"holds whole and ragged slices of 32 and [2^32 - 1, 2^32) at "
        f"dbits 0; none of these cases repeats one of its")
    return out


@contextlib.contextmanager
def recording_payloads():
    """Records every payload the front door's template feed hands the
    miner, per height (the last read wins, as the mined block embeds the
    boundary-time template); the feed's own history keeps only the last
    256 heights."""
    from mpi_blockchain_tpu_torch.service.frontdoor import TemplateFeed

    real, payloads = TemplateFeed.payload_for, {}

    def recording(self, height):
        data = real(self, height)
        payloads[height] = data
        return data
    TemplateFeed.payload_for = recording
    try:
        yield payloads
    finally:
        TemplateFeed.payload_for = real


def discards_by_reason() -> dict[str, float]:
    """``speculative_discards_total`` by reason since the last reset."""
    from mpi_blockchain_tpu_torch import telemetry

    return {dict(m.labels)["reason"]: m.value
            for m in telemetry.default_registry().metrics()
            if m.name == "speculative_discards_total"}


def checked_heights(seed: int, blocks: int) -> list[int]:
    """SERVE_CHECKED_HEIGHTS heights in [1, blocks], chosen from the
    seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return sorted(int(h) for h in rng.choice(
        np.arange(1, blocks + 1), SERVE_CHECKED_HEIGHTS, replace=False))


def lowest_winner(blob: bytes, height: int, dbits: int) -> tuple[int, int]:
    """(the nonce of the block at ``height`` in a chain file, the C++
    sweep's lowest qualifying nonce over [0, that nonce])."""
    from mpi_blockchain_tpu_torch import core

    header = blob[80 * height:80 * height + 80]
    nonce = int.from_bytes(header[76:80], "little")
    found, _ = core.cpu_search(header, 0, nonce + 1, dbits)
    return nonce, found


def served_cases(blob: bytes, heights, dbits: int,
                 half: int = SERVE_WINDOW_HALF) -> list[tuple]:
    """The serve path's own inputs for ``bounded_vs_plain``: for each
    height, that block's header from a served chain file and the nonces
    around its winner, [winner - half, winner + half) clamped to [0,
    2^32)."""
    cases = []
    for h in heights:
        header = blob[80 * h:80 * h + 80]
        winner = int.from_bytes(header[76:80], "little")
        start = max(0, winner - half)
        end = min(NONCE_SPACE, winner + half)
        cases.append((header, dbits, start, end - start))
    return cases


def serve_run(argv: list[str], load: dict | None) -> dict:
    """``serve`` through the port's CLI on a thread, with ``run_load``
    streaming ``load`` at its door from this thread while it mines (or
    no load). The kernels' launch counts are set to 0 just before and read
    just after. Returns the summary, the load's report, the door's state,
    the payloads it handed the miner, the launches, spans and discards."""
    import torch

    from mpi_blockchain_tpu_torch import service, telemetry
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda
    from mpi_blockchain_tpu_torch.service.loadgen import run_load

    done: dict = {}
    installed = threading.Event()
    install = service.install_service

    def installing(*args, **kwargs):
        done["state"] = install(*args, **kwargs)
        installed.set()
        return done["state"]

    def run():
        try:
            done["rc"], done["summary"] = run_cli(["serve", *argv,
                                                   "--port", "0"])
        except BaseException as e:     # re-raised on the smoke's thread
            done["error"] = e
        finally:
            installed.set()

    telemetry.reset()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    sha256_cuda.launches = sha256_block.step_launches = 0
    service.install_service = installing
    try:
        with recording_payloads() as payloads:
            thread = threading.Thread(target=run, name="serve", daemon=True)
            thread.start()
            installed.wait(timeout=120)
            state, report = done.get("state"), None
            if load is not None and state is not None:
                report = run_load(state.server.url("/"), seed=load["seed"],
                                  n=load["n"], workers=load["workers"],
                                  mempool_probe=state.mempool.depth)
                report["ended_before_chain"] = thread.is_alive()
            thread.join(timeout=600)
    finally:
        service.install_service = install
    launches, steps = sha256_cuda.launches, sha256_block.step_launches
    if "error" in done:
        raise done["error"]
    check(not thread.is_alive() and done.get("rc") == 0
          and state is not None, f"serve {' '.join(argv)}: rc "
          f"{done.get('rc')}, {done.get('summary')}")
    return {"summary": done["summary"], "report": report, "state": state,
            "payloads": dict(payloads), "launches": launches,
            "step_launches": steps, "discards": discards_by_reason(),
            "span_s": {name: telemetry.span_seconds(name)
                       for name in ("miner.sweep", "backend.cuda.dispatch")}}


def check_load(report: dict, state, n: int, what: str) -> None:
    """Every request answered, typed, and no accepted tx lost."""
    check(report["requests"] == n and report["errors"] == 0
          and report["untyped_sheds"] == 0,
          f"{what}: {report['requests']} of {n} answered, outcomes "
          f"{report['by_outcome']}")
    lost = [t for t in report["accepted_txids"]
            if state.tx_status(t)[0] != 200]
    check(not lost, f"{what}: accepted then lost: {lost[:4]}")


def serve_row(run: dict, blocks: int) -> dict:
    """The numbers phase 10 (b) prints for one ``serve_run``: the chain's
    wall (the summary's), launches, discards and their share of the
    launches, the two spans a block, inclusion, and the load's report."""
    rep, svc = run["report"] or {}, run["summary"]["service"]
    launches = run["launches"]
    discards = sum(run["discards"].values())
    return {
        "wall_s": run["summary"]["wall_s"], "launches": launches,
        "discards": run["discards"],
        "discarded_share": discards / launches if launches else None,
        "sweep_ms_per_block": 1e3 * run["span_s"]["miner.sweep"] / blocks,
        "dispatch_ms_per_block":
            1e3 * run["span_s"]["backend.cuda.dispatch"] / blocks,
        "included": svc["mempool"]["included_total"],
        "mempool_depth_max": svc["mempool"]["depth_max"],
        "load_wall_s": rep.get("wall_s"),
        **{k: rep.get(k) for k in (
            "requests_per_sec", "p99_latency_ms", "max_latency_ms",
            "shed_fraction", "ended_before_chain", "shed_reasons")}}


@contextlib.contextmanager
def probing_blocks(heights: dict[str, int]):
    """Scrapes the run's metrics server from inside the run: at the
    heights in ``heights`` the ``Miner``'s ``_block_mined`` seam (after
    the append, on the mining thread) reads ``/healthz`` or ``/metrics``.
    Yields {name: (status, body)}."""
    import urllib.error
    import urllib.request

    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.perfwatch.server import active_server

    got: dict = {}
    real = Miner._block_mined

    def probe(self, rec):
        real(self, rec)
        for name, height in heights.items():
            if rec.height != height:
                continue
            srv = active_server()
            try:
                with urllib.request.urlopen(srv.url(f"/{name}"),
                                            timeout=10) as r:
                    got[name] = (r.status, r.read().decode())
            except urllib.error.HTTPError as e:
                got[name] = (e.code, e.read().decode())
    Miner._block_mined = probe
    try:
        yield got
    finally:
        Miner._block_mined = real


def phase_serve(device) -> dict:
    """Phase 10: the front door on the card, (a) to (c) as the module
    docstring says. Returns its numbers."""
    import statistics

    import torch

    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.models.miner import Miner
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda
    from mpi_blockchain_tpu_torch.service import __main__ as serve_smoke
    from mpi_blockchain_tpu_torch.service import (Mempool, TemplateFeed,
                                                  install_service,
                                                  uninstall_service)
    from mpi_blockchain_tpu_torch.service.loadgen import run_load

    card = nvidia_smi("name,power.limit")
    out: dict = {}
    # (a) the serve smoke on the card.
    telemetry.reset()
    sha256_cuda.launches = sha256_block.step_launches = 0
    t0 = time.perf_counter()
    smoke = serve_smoke.smoke(device=device.type)
    took = time.perf_counter() - t0
    a = out["smoke"] = {k: smoke[k] for k in (
        "requests_per_sec", "p99_latency_ms", "shed_fraction",
        "mempool_depth_max", "included_total", "step_downs", "sheds",
        "verdict", "faults_fired")}
    a.update(launches=sha256_cuda.launches,
             step_launches=sha256_block.step_launches, wall_s=took,
             retries=telemetry.default_registry().total("retries_total"))
    check(smoke["chain_identical"] and smoke["step_downs"] == ["cuda:torch"]
          and a["launches"] > 0, f"10a: {a}")
    history = {int(h): d.encode() for h, d in smoke["history"].items()}
    replay = serve_smoke.replay_oracle(history, serve_smoke.SMOKE_BLOCKS,
                                       serve_smoke.SMOKE_DIFFICULTY)
    compared, mismatches, _ = bounded_vs_plain(served_cases(
        replay.node.save(), sorted(history), serve_smoke.SMOKE_DIFFICULTY),
        device)
    a.update(kernel_vs_plain=compared, mismatches=mismatches)
    check(mismatches == 0, f"10a: {mismatches} kernel/plain/C++ mismatches "
          f"on the smoke's headers")
    log(f"phase 10a serve smoke on the card (d12/n6, cap 8, 4 txs a "
        f"template, batches 10 + 16): strict plan fired {a['faults_fired']} "
        f"faults, stepped down {a['step_downs']}, degraded stamp, chain == "
        f"the C++ replay of the door's templates; {a['launches']} kernel "
        f"launches before the step-down; streamed batch "
        f"{a['requests_per_sec']} requests/s, p99 {a['p99_latency_ms']} ms "
        f"(bound {a['verdict']}), shed fraction {a['shed_fraction']}, "
        f"mempool high-water {a['mempool_depth_max']}, included "
        f"{a['included_total']}; {took:.3f} s; the kernel == the plain "
        f"sweep == cpu_search on the served headers ({compared} "
        f"comparisons, 0 mismatches); card {card}")

    # (b) full width, with and without the seeded load, in turns.
    blocks = int(SERVE_ARGS[SERVE_ARGS.index("--blocks") + 1])
    runs: dict[str, list] = {"load": [], "quiet": []}
    for turn in SERVE_TURNS:
        run = serve_run(list(SERVE_ARGS),
                        SERVE_LOAD if turn == "load" else None)
        summary = run["summary"]
        check(summary["height"] == blocks and run["launches"] > 0
              and summary["service"]["degraded"] is False,
              f"10b {turn}: {summary}")
        if turn == "quiet":
            check(summary["tip_hash"] == PINNED_TIPS[(24, 1000, 24)],
                  f"10b quiet: tip {summary['tip_hash']} is not the pin")
        else:
            check_load(run["report"], run["state"], SERVE_LOAD["n"],
                       "10b load")
        runs[turn].append(run)
    first = runs["load"][0]
    cfg = MinerConfig(difficulty_bits=24, n_blocks=blocks, batch_pow2=24,
                      backend="cuda", kernel="cuda", device="cuda")
    replay = Miner(cfg, pipeline=False)
    replay.payload_for = lambda h: first["payloads"][h]
    sha256_cuda.launches = 0
    replay.mine_chain()
    replay_launches = sha256_cuda.launches
    check(replay.node.tip_hash.hex() == first["summary"]["tip_hash"],
          f"10b: the loaded chain {first['summary']['tip_hash']} is not "
          f"the sequential replay's {replay.node.tip_hash.hex()}")
    blob = first["state"].miner.node.save()
    winners = {h: lowest_winner(blob, h, 24)
               for h in checked_heights(SERVE_LOAD["seed"], blocks)}
    check(all(n == f for n, f in winners.values()),
          f"10b: winners (nonce, C++ lowest) {winners}")
    compared, mismatches, _ = bounded_vs_plain(
        served_cases(blob, sorted(winners), 24), device)
    check(mismatches == 0, f"10b: {mismatches} kernel/plain/C++ mismatches "
          f"on the served headers")
    # The same load against an idle door: the door's own cost.
    torch.cuda.synchronize()
    telemetry.reset()
    idle_miner = Miner(cfg)
    pool = Mempool()
    idle = install_service(idle_miner, port=0, mempool=pool,
                           feed=TemplateFeed(pool, cfg))
    try:
        idle_report = run_load(idle.server.url("/"),
                               seed=SERVE_LOAD["seed"], n=SERVE_LOAD["n"],
                               workers=SERVE_LOAD["workers"],
                               mempool_probe=pool.depth)
    finally:
        uninstall_service(idle)
    check_load(idle_report, idle, SERVE_LOAD["n"], "10b idle door")

    b = out["full_width"] = {
        turn: [serve_row(r, blocks) for r in rs]
        for turn, rs in runs.items()}
    b["idle_door"] = {k: idle_report[k] for k in (
        "requests_per_sec", "p99_latency_ms", "max_latency_ms",
        "shed_fraction", "wall_s")}
    b["replay_wall_s"] = sum(r.wall_ms for r in replay.records) / 1e3
    b["replay_launches"] = replay_launches
    b["winners"] = {str(h): nf[0] for h, nf in winners.items()}
    b.update(kernel_vs_plain=compared, mismatches=mismatches)
    out["step_launches"] = a["step_launches"] + sum(
        r["step_launches"] for rs in runs.values() for r in rs)
    for turn in ("load", "quiet"):
        for r in b[turn]:
            log(f"phase 10b serve {' '.join(SERVE_ARGS)}, {turn}: wall "
                f"{r['wall_s']} s, {r['launches']} launches, discards "
                f"{r['discards']} ({r['discarded_share']:.4f} of launches), "
                f"miner.sweep {r['sweep_ms_per_block']:.6f} ms a block, "
                f"backend.cuda.dispatch {r['dispatch_ms_per_block']:.6f} "
                f"ms a block, included {r['included']}, mempool high-water "
                f"{r['mempool_depth_max']}"
                + ("" if turn == "quiet" else
                   f"; load {r['requests_per_sec']} requests/s, p99 "
                   f"{r['p99_latency_ms']} ms, max {r['max_latency_ms']} "
                   f"ms, shed fraction {r['shed_fraction']} "
                   f"{r['shed_reasons']}, load wall {r['load_wall_s']} s, "
                   f"ended before the chain: {r['ended_before_chain']}"))
    walls = {t: statistics.median(r["wall_s"] for r in b[t])
             for t in ("load", "quiet")}
    log(f"phase 10b medians: wall with load {walls['load']} s, without "
        f"{walls['quiet']} s ({walls['load'] / walls['quiet']:.4f} x); the "
        f"same load at an idle door: {b['idle_door']}; the loaded chain == "
        f"its sequential replay on the card ({b['replay_wall_s']:.6f} s, "
        f"{replay_launches} launches); winners at heights "
        f"{sorted(winners)} are the C++ sweep's lowest, and the kernel == "
        f"the plain sweep == cpu_search around them ({b['kernel_vs_plain']} "
        f"comparisons, 0 mismatches); card {card}")

    # (c) mine --serve-metrics 0 at the d20/n10/b20 pin.
    telemetry.reset()
    sha256_cuda.launches = 0
    with probing_blocks(SERVE_PROBE_HEIGHTS) as got:
        rc, summary = run_cli(["mine", *SERVE_METRICS_ARGS,
                               "--serve-metrics", "0"])
    launches = sha256_cuda.launches
    check(rc == 0 and summary.get("tip_hash") == PINNED_TIPS[(20, 10, 20)],
          f"10c: rc {rc}, {summary}")
    code, body = got.get("healthz", (None, "{}"))
    health = json.loads(body)
    beat = health.get("heartbeats", {}).get("miner_heartbeat", {})
    check(code == 200 and health.get("status") == "ok"
          and beat.get("value") == 5 and beat.get("age_s") is not None
          and beat["age_s"] < 30, f"10c /healthz mid-run: {code} {health}")
    prom = got.get("metrics", (None, ""))[1]
    blocks_mined = metric_total(prom, "blocks_mined_total")
    hashes = metric_total(prom, "hashes_tried_total")
    check(blocks_mined == 10 and hashes == summary["hashes_tried"],
          f"10c /metrics: blocks_mined_total {blocks_mined}, "
          f"hashes_tried_total {hashes}, summary {summary['hashes_tried']}")
    out["serve_metrics"] = {"healthz_age_s": beat["age_s"],
                            "blocks_mined_total": blocks_mined,
                            "hashes_tried_total": hashes,
                            "launches": launches}
    log(f"phase 10c mine --serve-metrics 0 d20/n10/b20: tip matches the "
        f"pin, {launches} launches; /healthz at block 5: 200 ok, "
        f"miner_heartbeat 5 aged {beat['age_s']} s; /metrics at block 10: "
        f"blocks_mined_total {blocks_mined:.0f}, hashes_tried_total "
        f"{hashes:.0f} == the summary's")
    return out


def check_device_union(union_s: float, event_sum_s: float,
                       what: str) -> None:
    """The device windows' union may not exceed the sweeps' CUDA-event
    sum: a window stamped on the host's clock at the consume would count
    the card's idle time as busy. The miner's events bracket the kernel
    alone and ``mine_timed``'s the library's call around it, on one
    stream, so each window is at most its sweep's event time."""
    check(union_s <= event_sum_s,
          f"{what}: device-segment union {union_s:.6f} s exceeds the "
          f"sweeps' CUDA-event sum {event_sum_s:.6f} s")


def check_bubble(bubble: float, event_sum_s: float, wall_s: float,
                 what: str) -> float:
    """``bubble_fraction`` agrees with 1 - the sweeps' CUDA-event sum /
    wall within ``BUBBLE_TOLERANCE``; returns the latter."""
    expected = 1 - event_sum_s / wall_s
    check(abs(bubble - expected) <= BUBBLE_TOLERANCE,
          f"{what}: bubble_fraction {bubble} against 1 - sweeps / wall "
          f"{expected:.4f}")
    return expected


def check_critical_path(report: dict, blocks: int, what: str) -> float:
    """Every height 1..blocks has a complete critical path with its gap
    under ``COMPLETE_GAP_PCT``; returns the largest gap share."""
    from mpi_blockchain_tpu_torch.blocktrace.critical_path import \
        COMPLETE_GAP_PCT

    check(report["heights"] == list(range(1, blocks + 1)),
          f"{what}: critical path heights {report['heights'][:5]}... "
          f"({len(report['heights'])}), not 1..{blocks}")
    for h in report["heights"]:
        b = report["blocks"][str(h)]
        check(b["complete"] and b["gap_pct"] < COMPLETE_GAP_PCT,
              f"{what}: block {h} incomplete: gap {b['gap_pct']}%, path "
              f"{b['critical_path']}")
    return max(report["blocks"][str(h)]["gap_pct"]
               for h in report["heights"])


def check_no_incident(incident_dir: str, events: list, registry,
                      what: str) -> None:
    """A clean run raises no incident: no bundle, no ``incident`` event,
    no ``incidents_total``."""
    bundles = sorted(pathlib.Path(incident_dir).glob("incident_*.json"))
    check(not bundles and not events
          and registry.total("incidents_total") == 0,
          f"{what}: a clean run raised incidents: bundles "
          f"{[b.name for b in bundles]}, events {events}")


def event_cost_us(device, n: int = EVENT_COST_LAUNCHES) -> dict:
    """Host us of ``sha256_cuda.sweep_launch`` with its one plain event
    and inside ``timed_launches`` with a timing pair from the pool, in
    turns plain, timed, timed, plain after a warming timed turn, medians;
    the sweep is one nonce at a difficulty nothing meets. ``plain_us`` a
    launch (every untraced launch) and dropping it (its event destroyed);
    ``timed_us`` a traced launch and dropping it (its pair back in the
    pool); ``read_us`` its ``timing()`` once done; ``extra_us`` what a
    traced launch adds, timed and read less plain."""
    import statistics

    import torch

    from mpi_blockchain_tpu_torch import core
    from mpi_blockchain_tpu_torch.ops import extend_midstate, sha256_cuda

    ext = extend_midstate(*core.header_midstate(bytes(range(80))))

    def turn(timed: bool) -> tuple[float, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sha256_cuda.timed_launches(timed):
            swept = [sha256_cuda.sweep_launch(ext, 0, 1, 64, device=device)
                     for _ in range(n)]
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if timed:
            for launched in swept:
                launched.timing()
        t3 = time.perf_counter()
        swept.clear()
        t4 = time.perf_counter()
        return (t1 - t0 + t4 - t3) / n * 1e6, (t3 - t2) / n * 1e6

    turn(True)
    times: dict[str, list[float]] = {"plain": [], "timed": [], "read": []}
    for label in ("plain", "timed", "timed", "plain"):
        launch_us, read_us = turn(label == "timed")
        times[label].append(launch_us)
        if label == "timed":
            times["read"].append(read_us)
    out = {f"{k}_us": statistics.median(v) for k, v in times.items()}
    out["extra_us"] = out["timed_us"] + out["read_us"] - out["plain_us"]
    return out


def tracing_cost(rows: dict) -> dict:
    """What tracing costs the pipelined ``Miner``, from phase 11 a's runs
    in ``TRACE_TURNS``: each traced run against the off run next to it
    (traced, off, off, traced pairs the first with the second and the
    fourth with the third), host ms a block traced less off, and the
    median walls."""
    import statistics

    traced, off = rows["traced"], rows["off"]
    pairs = [round(t["host_ms_per_block"] - o["host_ms_per_block"], 4)
             for t, o in zip(traced, off)]
    return {"pair_ms_per_block": pairs,
            "median_ms_per_block": statistics.median(pairs),
            "median_wall_s": {
                turn: statistics.median(r["wall_s"] for r in rows[turn])
                for turn in ("traced", "off")}}


def traced_miner_run(traced: bool) -> dict:
    """One d24/n1000 pipelined Miner run, the telemetry on or off (the
    kill switch ``MPIBT_TELEMETRY_OFF`` sets), with ``mine_timed``'s
    events around the library's call that launches every sweep; traced,
    also its pipeline object, its critical path checked for every height,
    the device windows' union held to the sweeps' event sum and its
    bubble to 1 - that sum / wall."""
    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.blocktrace.critical_path import \
        critical_path_report
    from mpi_blockchain_tpu_torch.config import MinerConfig
    from mpi_blockchain_tpu_torch.meshwatch.pipeline import (
        pipeline_report, profiler, reset_profiler)
    from mpi_blockchain_tpu_torch.models.miner import Miner

    cfg = MinerConfig(difficulty_bits=24, n_blocks=1000, batch_pow2=24,
                      backend="cuda", kernel="cuda", device="cuda")
    telemetry.reset()
    reset_profiler()
    prev = telemetry.set_telemetry_disabled(not traced)
    try:
        miner = Miner(cfg, pipeline=True)
        run = mine_timed(miner, bracket="library", sample_clocks=False)
    finally:
        telemetry.set_telemetry_disabled(prev)
    what = f"phase 11a {'traced' if traced else 'off'}"
    check(run["tip_hash"] == PINNED_TIPS[(24, 1000, 24)],
          f"{what}: tip {run['tip_hash']}")
    check(run["launches"] == 1000, f"{what}: {run['launches']} launches")
    check(miner.backend.rung == "cuda:cuda"
          and miner.backend.degradations == [],
          f"{what}: rung {miner.backend.rung}, degradations "
          f"{miner.backend.degradations}")
    out = {"wall_s": run["wall_s"], "kernel_s": run["kernel_s"],
           "launches": run["launches"],
           "host_ms_per_block": host_ms_per_block(run, 1000)}
    if not traced:
        check(profiler().records() == [], f"{what}: records were kept")
        return out
    records = profiler().records()
    pipe = pipeline_report(records)
    rank = pipe["ranks"]["0"]
    report = critical_path_report(records)
    out["max_gap_pct"] = check_critical_path(report, 1000, what)
    check_device_union(rank["device_busy_s"], run["kernel_s"], what)
    expected_bubble = check_bubble(pipe["bubble_fraction"], run["kernel_s"],
                                   run["wall_s"], what)
    discards = telemetry.default_registry().total(
        "speculative_discards_total")
    out.update(pipeline={
        "host_overlapped_fraction": pipe["host_overlapped_fraction"],
        "bubble_fraction": pipe["bubble_fraction"],
        "speculative_discards": int(discards)},
        device_union_s=rank["device_busy_s"],
        union_over_events=rank["device_busy_s"] / run["kernel_s"],
        expected_bubble=expected_bubble,
        pipeline_wall_s=rank["wall_s"],
        unattributed_segments=report["unattributed_segments"])
    return out


def incident_run(td: str, name: str, faulted: bool) -> dict:
    """``mine`` d20/n10/b20 with ``--incident-dir`` and INCIDENT_ENV, with
    or without INCIDENT_FAULT; returns rc, summary, the incident events,
    the bundles and the registry's ``incidents_total``."""
    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.meshwatch.pipeline import reset_profiler

    incident_dir = os.path.join(td, name)
    argv = ["mine", "--difficulty", "20", "--blocks", "10",
            "--batch-pow2", "20", "--incident-dir", incident_dir]
    if faulted:
        plan = os.path.join(td, f"{name}_plan.json")
        with open(plan, "w") as f:
            json.dump({"version": 1, "strict": True,
                       "faults": [INCIDENT_FAULT]}, f)
        argv += ["--fault-plan", plan]
    telemetry.reset()
    telemetry.clear_events()
    reset_profiler()
    saved = {k: os.environ.get(k) for k in INCIDENT_ENV}
    os.environ.update(INCIDENT_ENV)
    try:
        rc, summary = run_cli(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    what = f"phase 11c {name}"
    check(rc == 0, f"{what}: rc {rc}: {summary}")
    check_no_step_down(summary, "cuda:cuda", what)
    check(summary.get("tip_hash") == PINNED_TIPS[(20, 10, 20)],
          f"{what}: tip {summary.get('tip_hash')}")
    return {"summary": summary,
            "events": telemetry.recent_events(event="incident"),
            "bundles": sorted(pathlib.Path(incident_dir).glob(
                "incident_*.json")),
            "incidents_total": telemetry.default_registry().total(
                "incidents_total"),
            "dir": incident_dir}


def phase_trace(device, cold_nvcc: int) -> dict:
    """Phase 11: per-block tracing on the main path. (a) the d24/n1000
    pipelined Miner traced and off in turns: walls, host ms a block, the
    pipeline object, every height's critical path, the device windows
    against the sweeps' events, and the timing events' host cost a
    launch; (b) ``mine --fused`` d24/n1000 at 100 a call, traced: the
    pipeline object, one host wait a call, no hidden sync, each k-block
    program built once, no nvcc build on the warm cache (``cold_nvcc``:
    the startup build's, 1 from a cold checkout); (c) ``--incident-dir``:
    the clean d20/n10 run raises nothing, the faulted one one
    ``event_storm`` with a complete bundle; (d) the overhead audits on the
    card, against the reference's bound."""
    import torch

    from mpi_blockchain_tpu_torch import dispatchwatch, telemetry
    from mpi_blockchain_tpu_torch.blocktrace.overhead import (
        measure_block_observe, measure_trace_overhead)
    from mpi_blockchain_tpu_torch.chainwatch import BUNDLE_KEYS
    from mpi_blockchain_tpu_torch.meshwatch.pipeline import reset_profiler
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda
    from mpi_blockchain_tpu_torch.perfwatch.detector import SECTION_BOUNDS

    out: dict = {"miner": {"traced": [], "off": []}}
    for turn in TRACE_TURNS:
        row = traced_miner_run(turn == "traced")
        out["miner"][turn].append(row)
        extra = ""
        if turn == "traced":
            extra = (f"; pipeline {row['pipeline']}; critical path "
                     f"complete for heights 1..1000, max gap "
                     f"{row['max_gap_pct']}%; device union "
                     f"{row['device_union_s']:.6f} s = "
                     f"{row['union_over_events']:.6f} of the sweeps' "
                     f"events; 1 - sweeps / wall "
                     f"{row['expected_bubble']:.4f}")
        log(f"phase 11a d24/n1000 pipelined Miner, {turn}: wall "
            f"{row['wall_s']:.6f} s, sweeps {row['kernel_s']:.6f} s, host "
            f"{row['host_ms_per_block']:.4f} ms a block{extra}")
    out["tracing_cost"] = tracing_cost(out["miner"])
    cost = out["tracing_cost"]
    log(f"phase 11a tracing's cost: host ms a block traced less off, pair "
        f"by pair {cost['pair_ms_per_block']}, median "
        f"{cost['median_ms_per_block']:.4f} ms; walls traced "
        f"{cost['median_wall_s']['traced']:.6f} s against off "
        f"{cost['median_wall_s']['off']:.6f} s (medians)")
    events = event_cost_us(device)
    out["event_cost_us"] = events
    log(f"phase 11a timing events a launch: sweep_launch "
        f"{events['timed_us']:.4f} us traced (a pooled pair recorded in "
        f"the library's call) and {events['read_us']:.4f} us to read it, "
        f"against {events['plain_us']:.4f} us with one plain event: "
        f"{events['extra_us']:.4f} us more a traced launch")

    # (b) the fused run through the CLI, traced, with the census. The
    # detector's check also takes its one-time prototype warning.
    check(sync_detector_works(device),
          "sync debug mode did not flag .item() on the card")
    dispatchwatch.clear_compiles()
    telemetry.reset()
    reset_profiler()
    sha256_cuda.launches = sha256_block.step_launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rc, summary = run_cli(["mine", "--fused", "--blocks-per-call",
                                   "100", "--difficulty", "24", "--blocks",
                                   "1000", "--batch-pow2", "24"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = count_syncs(caught)
    where = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchronizing" in str(w.message)]
    census = dispatchwatch.compile_census()
    nvcc = census.get(sha256_cuda.COMPILE_SITE, {}).get("compiles", 0)
    fused = census.get("fused", {})
    check(rc == 0 and summary.get("tip_hash")
          == PINNED_TIPS[(24, 1000, 24)],
          f"phase 11b mine --fused: rc {rc}, {summary}")
    check("pipeline" in summary, "phase 11b: no pipeline object")
    check(summary["host_waits"] == 10 and syncs == 0,
          f"phase 11b: {summary['host_waits']} host waits for 10 calls, "
          f"{syncs} hidden syncs at {where}")
    check(fused.get("compiles") == fused.get("cache_entries") == 1
          and dispatchwatch.recompiles(census) == 0,
          f"phase 11b: fused census {fused}")
    check(nvcc == 0, f"phase 11b: {nvcc} nvcc builds on a warm cache")
    check(cold_nvcc in (0, 1), f"startup: {cold_nvcc} nvcc builds")
    out["fused"] = {"summary_pipeline": summary["pipeline"],
                    "wall_s": summary["wall_s"],
                    "host_waits": summary["host_waits"],
                    "hidden_syncs": syncs, "census": census,
                    "sweeps": sha256_cuda.launches,
                    "steps": sha256_block.step_launches,
                    "startup_nvcc_builds": cold_nvcc}
    log(f"phase 11b mine --fused d24/n1000 at 100 a call, traced: tip "
        f"matches, wall {summary['wall_s']} s, pipeline "
        f"{summary['pipeline']}, {summary['host_waits']} host waits for 10 "
        f"calls, {syncs} hidden syncs; census {census}; nvcc builds: "
        f"{cold_nvcc} at startup, 0 in the run")

    # (c) the watchdog: a clean run and a faulted one.
    with tempfile.TemporaryDirectory() as td:
        clean = incident_run(td, "clean", faulted=False)
        check_no_incident(clean["dir"], clean["events"],
                          telemetry.default_registry(), "phase 11c clean")
        faulted = incident_run(td, "faulted", faulted=True)
        names = [b.name for b in faulted["bundles"]]
        check([e["rule"] for e in faulted["events"]] == ["event_storm"]
              and faulted["incidents_total"] == 1
              and names == ["incident_0001_event_storm.json"],
              f"phase 11c faulted: incidents {faulted['events']}, bundles "
              f"{names}")
        bundle = json.loads(faulted["bundles"][0].read_text())
        missing = set(BUNDLE_KEYS) - set(bundle)
        memory = bundle["memory"].get(f"cuda:{device.index}", {})
        check(not missing and memory.get("bytes_in_use", 0) > 0,
              f"phase 11c: bundle missing {sorted(missing)}, memory "
              f"{bundle['memory']}")
        out["incidents"] = {
            "clean": {"rung": clean["summary"]["rung"]},
            "faulted": {"rung": faulted["summary"]["rung"],
                        "detail": bundle["detail"],
                        "heights": bundle["heights"],
                        "memory": memory}}
    log(f"phase 11c --incident-dir d20/n10: clean run at the pin, 0 "
        f"incidents, no bundle; faulted run ({INCIDENT_FAULT}) at the pin, "
        f"rc 0, one event_storm {bundle['detail']} at heights "
        f"{bundle['heights']}, bundle with all {len(BUNDLE_KEYS)} keys, "
        f"memory {memory}")

    # (d) the overhead audits on the card, after the estimator's zero.
    bound = SECTION_BOUNDS["trace_overhead"]
    null = measure_trace_overhead(device=str(device), null=True)
    reads = []
    for attempt, kwargs in enumerate(OVERHEAD_ATTEMPTS):
        if attempt:
            time.sleep(OVERHEAD_PAUSE_S)
        reads.append(measure_trace_overhead(device=str(device), **kwargs))
        if reads[-1]["overhead_pct"] <= bound:
            break
    check(reads[-1]["overhead_pct"] <= bound,
          f"phase 11d: overhead {[r['overhead_pct'] for r in reads]}% "
          f"over the {bound}% bound")
    observe = measure_block_observe(device=str(device))
    check(observe["block_observe_us"]
          <= SECTION_BOUNDS["trace_block_observe"],
          f"phase 11d: block observe {observe}")
    out["overhead"] = {"null": null, "trace_overhead": reads,
                       "trace_block_observe": observe}
    log(f"phase 11d trace_overhead on the card: null (both halves off) "
        f"{null['overhead_pct']}%, reads "
        f"{[r['overhead_pct'] for r in reads]}% (bound {bound}%), last "
        f"read {reads[-1]}; block observe {observe} (bound "
        f"{SECTION_BOUNDS['trace_block_observe']} us)")
    return out


def cli_run_timed(argv: list[str]) -> dict:
    """``mine`` through the CLI in this process with CUDA events around the
    library's call that launches each sweep (``timed_library_calls``):
    rc, summary, the sweeps' event time and the sweep and step launches.
    The wall is the summary's (``mine_chain`` alone: arming the shard and
    its final write lie outside it)."""
    import torch

    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.meshwatch.pipeline import reset_profiler
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    telemetry.reset()
    reset_profiler()
    events: list = []
    sha256_cuda.launches = sha256_block.step_launches = 0
    torch.cuda.synchronize()
    with timed_library_calls(sha256_cuda.library(), events,
                             lambda: torch.cuda.Event(enable_timing=True)):
        rc, summary = run_cli(argv)
    sweeps, steps = sha256_cuda.launches, sha256_block.step_launches
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    return {"rc": rc, "summary": summary, "wall_s": summary.get("wall_s"),
            "kernel_s": kernel_s, "sweeps": sweeps, "steps": steps}


def check_final_shard(obs: str, summary: dict, what: str) -> dict:
    """The run's final shard: finished, under rank 0, with ``cuda:0``
    memory watermarks, a pipeline tail that renders a report, and (the
    per-block driver) ``hashes_tried_total`` equal to the summary's."""
    from mpi_blockchain_tpu_torch.meshwatch.aggregate import (rank_status,
                                                              read_shards)
    from mpi_blockchain_tpu_torch.meshwatch.pipeline import pipeline_report

    shards = read_shards(obs)
    check([s["rank"] for s in shards] == [0], f"{what}: shards "
          f"{[s['rank'] for s in shards]}")
    final = shards[0]
    status = rank_status(shards)["ranks"]["0"]
    check(final["final"] and final["exit_status"] == 0
          and status["status"] == "finished",
          f"{what}: final shard {status}")
    hashed = sum(m["value"] for m in
                 final["registry"].get("hashes_tried_total", []))
    if "hashes_tried" in summary:
        check(hashed == summary["hashes_tried"],
              f"{what}: shard hashes_tried_total {hashed}, summary "
              f"{summary['hashes_tried']}")
    memory = final["memory"].get("cuda:0", {})
    check(memory.get("bytes_in_use", 0) > 0, f"{what}: memory "
          f"{final['memory']}")
    report = pipeline_report(final["pipeline"])
    check(report["dispatch_count"] > 0
          and report["bubble_fraction"] is not None,
          f"{what}: pipeline tail report {report}")
    return {"hashes_tried_total": hashed, "memory": memory,
            "pipeline_tail": len(final["pipeline"]),
            "tail_report": {k: report[k] for k in (
                "dispatch_count", "bubble_fraction",
                "host_overlapped_fraction")},
            "seq": final["seq"], "compiles": final["compiles"]}


def flush_cost_ms(td: str, n: int = MESH_OBS_FLUSHES) -> dict:
    """What one shard flush holds the interpreter for, after a d24/n1000
    run (the profiler holds its 1000 records, so a shard carries the full
    512-record tail), with the watchdog armed as ``--mesh-obs`` arms it:
    medians over ``n`` writes of building the payload (its forced
    chainwatch sweep included), of its ``json.dumps``, and of the whole
    atomic write; and the shard's bytes."""
    import statistics

    from mpi_blockchain_tpu_torch import chainwatch
    from mpi_blockchain_tpu_torch.meshwatch.shard import ShardWriter

    writer = ShardWriter(os.path.join(td, "flush"))
    times: dict[str, list[float]] = {"payload_ms": [], "dumps_ms": [],
                                     "flush_ms": []}
    chainwatch.install(None)
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            payload = writer.payload()
            t1 = time.perf_counter()
            data = json.dumps(payload, sort_keys=True, default=str)
            t2 = time.perf_counter()
            writer.write()
            t3 = time.perf_counter()
            for key, dt in (("payload_ms", t1 - t0), ("dumps_ms", t2 - t1),
                            ("flush_ms", t3 - t2)):
                times[key].append(dt * 1e3)
    finally:
        chainwatch.uninstall()
    return {**{k: statistics.median(v) for k, v in times.items()},
            "bytes": len(data), "pipeline_records": len(payload["pipeline"])}


def run_module(module: str, args: list[str], timeout: float,
               counted: bool = False) -> dict:
    """``python -m module args`` from the checkout's root in a session of
    its own (the smokes start rank processes; a timeout kills them all):
    rc, the last JSON line of its stdout, its stdout, the tail of its
    stderr, wall. ``counted`` runs the module's ``main`` through
    ``MODULE_COUNTING_ENTRY``, which prints the process's sweep launches
    last on stderr (``rank_launches`` reads them)."""
    import signal

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    entry = (["-c", MODULE_COUNTING_ENTRY.format(module=module + ".__main__")]
             if counted else ["-m", module])
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *entry, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO_ROOT,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.strip().startswith("{")]
    return {"rc": proc.returncode,
            "out": json.loads(lines[-1]) if lines else {}, "stdout": out,
            "err": err[-2000:], "wall_s": time.perf_counter() - t0}


def mesh_world(td: str) -> dict:
    """Two ``mine --mesh-obs`` processes over gloo on one card at the
    d20/n10/b20 pin: both shards under their ranks, both ranks on the
    card's rung with no retry or step-down, the ``mesh.sweep`` rounds
    joined across both, the compile census alike, and a ``MeshServer`` on
    the directory."""
    import urllib.request

    from mpi_blockchain_tpu_torch.meshprof.analyzer import analyze_skew
    from mpi_blockchain_tpu_torch.meshwatch.aggregate import (mesh_compiles,
                                                              read_shards)
    from mpi_blockchain_tpu_torch.meshwatch.server import MeshServer
    from mpi_blockchain_tpu_torch.meshwatch.world import rung_fault
    from mpi_blockchain_tpu_torch.perfwatch.detector import SECTION_BOUNDS

    what = "phase 12e gloo world"
    obs = os.path.join(td, "mesh")
    summary, got, _ = gloo_world(td, ["--mesh-obs", obs], what)
    shards = read_shards(obs)
    check([(s["rank"], s["world_size"], s["final"]) for s in shards]
          == [(0, 2, True), (1, 2, True)],
          f"{what}: shards {[(s['rank'], s['world_size']) for s in shards]}")
    for shard in shards:
        # Rank 1 prints no summary; its shard speaks for it.
        fault = rung_fault(shard["rank"], "cuda", shard,
                           got[0][0] if shard["rank"] == 0 else None)
        check(fault is None, f"{what}: {fault}")
    report = analyze_skew(shards)
    rounds = [len([sp for sp in s["skew_spans"] if sp["site"] == "mesh.sweep"])
              for s in shards]
    site = report["sites"].get("mesh.sweep", {})
    check(site.get("ranks") == [0, 1] and rounds[0] == rounds[1]
          == site.get("rounds", -1) > 0,
          f"{what}: mesh.sweep spans {rounds}, joined {site}")
    bound = SECTION_BOUNDS["collective_skew"]
    check(report["max_skew_ms"] < bound,
          f"{what}: max skew {report['max_skew_ms']} ms, bound {bound}")
    compiles = mesh_compiles(shards)
    check(not compiles.get("divergent", False),
          f"{what}: divergent compile census {compiles}")
    server = MeshServer(obs, port=0, stall_s=1e9)
    server.start()
    try:
        with urllib.request.urlopen(server.url("/healthz"), timeout=10) as r:
            healthz = (r.status, json.loads(r.read()))
        with urllib.request.urlopen(server.url("/ranks"), timeout=10) as r:
            ranks = json.loads(r.read())
        with urllib.request.urlopen(server.url("/metrics"), timeout=10) as r:
            metrics = r.read().decode()
    finally:
        server.close()
    check(healthz[0] == 200 and healthz[1]["healthy"],
          f"{what}: /healthz {healthz}")
    check({r: v["status"] for r, v in ranks.items()}
          == {"0": "finished", "1": "finished"}, f"{what}: /ranks {ranks}")
    check('rank="0"' in metrics and 'rank="1"' in metrics,
          f"{what}: /metrics has no rank labels")
    return {"wall_s": summary["wall_s"], "rounds": site["rounds"],
            "max_skew_ms": report["max_skew_ms"],
            "straggler_rank": report["straggler_rank"],
            "skew": {k: site[k] for k in ("skew_ms", "clock_offset_ms",
                                          "idle_chip_ms")},
            "compiles": compiles,
            "pipeline_records_by_rank": [len(s["pipeline"])
                                         for s in shards]}


def phase_mesh_obs(device, keep_world: str | None = None) -> dict:
    """Phase 12: mesh observability on the card. (a) ``mine --mesh-obs``
    at d24/n1000/2^24 through the pipelined ``Miner``, with and without
    the shard in turns (MESH_OBS_TURNS), and ``mine --fused --mesh-obs``:
    the pins, the final shards, wall and host ms a block; (b) to (d) the
    meshwatch, chainwatch and blocktrace smokes with their ranks on the
    card; (e) two gloo processes at the d20/n10 pin with ``--mesh-obs``,
    the skew analyzer and a ``MeshServer`` on their shards, which are
    copied to ``keep_world`` when it is given (phase 14 reads them)."""
    import statistics

    out: dict = {"miner": {"obs": [], "off": []}}
    pin = PINNED_TIPS[(24, 1000, 24)]
    with tempfile.TemporaryDirectory() as td:
        for i, turn in enumerate(MESH_OBS_TURNS):
            obs = os.path.join(td, f"miner{i}")
            argv = ["mine", *MESH_OBS_ARGS]
            if turn == "obs":
                argv += ["--mesh-obs", obs]
            run = cli_run_timed(argv)
            what = f"phase 12a mine {turn}"
            check(run["rc"] == 0 and run["summary"].get("tip_hash") == pin,
                  f"{what}: rc {run['rc']}, {run['summary']}")
            check_no_step_down(run["summary"], "cuda:cuda", what)
            check(run["sweeps"] == 1000, f"{what}: {run['sweeps']} sweeps")
            row = {"wall_s": run["wall_s"], "kernel_s": run["kernel_s"],
                   "host_ms_per_block": host_ms_per_block(run, 1000),
                   "launches": run["sweeps"]}
            if turn == "obs":
                row["shard"] = check_final_shard(obs, run["summary"], what)
            out["miner"][turn].append(row)
            log(f"{what} d24/n1000/b24 (pipelined Miner): tip matches, "
                f"wall {row['wall_s']} s, sweeps {row['kernel_s']:.6f} s, "
                f"host {row['host_ms_per_block']:.4f} ms a block, "
                f"{row['launches']} launches"
                + (f"; final shard {row['shard']}" if turn == "obs"
                   else ""))
        med = {turn: {k: statistics.median(r[k] for r in rows)
                      for k in ("wall_s", "host_ms_per_block")}
               for turn, rows in out["miner"].items()}
        out["cost"] = {
            "wall_s": med["obs"]["wall_s"] - med["off"]["wall_s"],
            "host_ms_per_block": med["obs"]["host_ms_per_block"]
            - med["off"]["host_ms_per_block"], "medians": med}
        log(f"phase 12a the shard's cost (medians of {MESH_OBS_TURNS}): "
            f"wall {med['obs']['wall_s']} s with against "
            f"{med['off']['wall_s']} s without ({out['cost']['wall_s']:+.4f}"
            f" s), host {med['obs']['host_ms_per_block']:.4f} against "
            f"{med['off']['host_ms_per_block']:.4f} ms a block "
            f"({out['cost']['host_ms_per_block']:+.4f})")
        out["flush"] = flush_cost_ms(td)
        log(f"phase 12a one shard flush after the run (medians of "
            f"{MESH_OBS_FLUSHES}): payload {out['flush']['payload_ms']:.3f}"
            f" ms, json.dumps {out['flush']['dumps_ms']:.3f} ms, the whole "
            f"write {out['flush']['flush_ms']:.3f} ms, "
            f"{out['flush']['bytes']} bytes, "
            f"{out['flush']['pipeline_records']} pipeline records")
        obs = os.path.join(td, "fused")
        run = cli_run_timed(["mine", "--fused", "--blocks-per-call", "100",
                             *MESH_OBS_ARGS, "--mesh-obs", obs])
        what = "phase 12a mine --fused --mesh-obs"
        check(run["rc"] == 0 and run["summary"].get("tip_hash") == pin,
              f"{what}: rc {run['rc']}, {run['summary']}")
        check(run["sweeps"] == 1000 and run["steps"] == 1010,
              f"{what}: {run['sweeps']} sweeps, {run['steps']} steps")
        out["fused"] = {"wall_s": run["wall_s"], "kernel_s": run["kernel_s"],
                        "sweeps": run["sweeps"], "steps": run["steps"],
                        "shard": check_final_shard(obs, run["summary"],
                                                   what)}
        log(f"{what} d24/n1000 at 100 a call: tip matches, wall "
            f"{run['wall_s']} s, {run['sweeps']} sweeps and {run['steps']} "
            f"steps; final shard {out['fused']['shard']}")

        # (e) first: it shares phase 8's world shape.
        out["world"] = mesh_world(td)
        if keep_world is not None:
            shutil.copytree(os.path.join(td, "mesh"), keep_world)
        log(f"phase 12e two processes over gloo with --mesh-obs "
            f"(d20/n10/b20): both ranks at the pin, shards rank_0000 and "
            f"rank_0001 final; {out['world']['rounds']} mesh.sweep rounds "
            f"joined across both ranks, max skew "
            f"{out['world']['max_skew_ms']} ms, {out['world']['skew']}; "
            f"compiles {out['world']['compiles']}; MeshServer /healthz 200, "
            f"/ranks both finished, /metrics rank-labeled; both ranks on "
            f"cuda:cuda, no retry or step-down; pipeline records in the "
            f"shards' tails {out['world']['pipeline_records_by_rank']}")

    for name, module, key in SMOKES:
        res = run_module(module, ["smoke"], SMOKE_TIMEOUT_S)
        check(res["rc"] == 0 and res["out"].get("ok") is True,
              f"phase 12{key} {name} smoke on the card: rc {res['rc']}, "
              f"{res['out']}, {res['err']}")
        out[name] = {**res["out"], "wall_s": res["wall_s"]}
        log(f"phase 12{key} {module} smoke (ranks on the card, each "
            f"held by the smoke to cuda:cuda with no step-down and no retry "
            f"but its plan's): "
            f"{res['out']}, {res['wall_s']:.1f} s")
    stale = out["meshwatch"]["stale_ranks"]
    check(stale == [2], f"phase 12b: stale ranks {stale}")
    check(out["chainwatch"]["incident_rank"] == 2
          and out["chainwatch"]["clean_incidents"] == 0,
          f"phase 12c: {out['chainwatch']}")
    return out


def rank_counts(stderr: str) -> dict:
    """The launch counts a ``COUNTING_ENTRY`` or ``WORLD_COUNTING_ENTRY``
    rank reported."""
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith('{"sweep_launches"')]
    check(bool(lines), f"no launch count on the rank's stderr: "
          f"{stderr[-400:]}")
    return json.loads(lines[-1])


def rank_launches(stderr: str) -> int:
    """The sweep launches a ``COUNTING_ENTRY`` rank reported."""
    return rank_counts(stderr)["sweep_launches"]


def registry_total(shard: dict, name: str, **labels) -> float:
    """A shard's ``name`` summed over the samples carrying ``labels``."""
    return sum(m["value"] for m in shard["registry"].get(name, [])
               if all(m["labels"].get(k) == v for k, v in labels.items()))


def clean_elastic_world(tmp: pathlib.Path) -> dict:
    """13 a's world with no fault plan: every rank exits 0 with no
    eviction, on ``cuda:cuda``. Returns the world's wall, the ranks'
    ``mine_chain`` walls and their launches."""
    from mpi_blockchain_tpu_torch.meshwatch.world import reap
    from mpi_blockchain_tpu_torch.resilience import __main__ as res

    t0 = time.perf_counter()
    procs = res._elastic_ranks(tmp, "clean", "cuda",
                               lambda r: list(ELASTIC_CHAIN),
                               entry=COUNTING_ENTRY)
    try:
        got = {r: p.communicate(timeout=300) for r, p in procs.items()}
    finally:
        reap(procs.values())
    wall = time.perf_counter() - t0
    rcs = {r: p.returncode for r, p in procs.items()}
    check(set(rcs.values()) == {0}, f"13a clean world: rcs {rcs}; "
          f"{[err[-400:] for _, err in got.values()]}")
    summaries = {r: res._last_json(out) for r, (out, _) in got.items()}
    for r, summary in summaries.items():
        check(summary["mesh"]["evicted"] == [] and summary["height"]
              == int(ELASTIC_CHAIN[ELASTIC_CHAIN.index("--blocks") + 1]),
              f"13a clean world rank {r}: {summary}")
        check_no_step_down(summary, "cuda:cuda", f"13a clean rank {r}")
    return {"wall_s": wall,
            "mine_wall_s": {r: v["wall_s"] for r, v in summaries.items()},
            "launches": {r: rank_launches(err)
                         for r, (_, err) in got.items()}}


def forensics_run(dump: str, trace: str) -> dict:
    """``python -m mpi_blockchain_tpu_torch.forensics --events DUMP
    --json --trace TRACE`` in a process of its own: rc 0, the report with
    its sections (``attack_audit`` non-empty exactly when the dump holds
    ``attack_*`` events), and a trace row for every node that logged."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.forensics",
         "--events", dump, "--json", "--trace", trace],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT,
        timeout=FORENSICS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"forensics on {dump}: rc "
          f"{proc.returncode}: {proc.stderr[-800:]}")
    report = json.loads(proc.stdout)
    with open(dump) as f:
        nodes = json.load(f)["nodes"]
    attacked = any(str(e.get("kind", "")).startswith("attack_")
                   for events in nodes.values() for e in events)
    check({"fork_tree", "reorg_audit", "convergence", "attack_audit"}
          <= set(report) and bool(report["attack_audit"]) == attacked,
          f"forensics on {dump}: sections {sorted(report)}, attack audit "
          f"{bool(report['attack_audit'])}, attack events {attacked}")
    with open(trace) as f:
        rows = {e["args"]["name"] for e in json.load(f)["traceEvents"]
                if e["ph"] == "M"}
    # A row for every node that logged an event (the bus pseudo-node of a
    # run that lost no delivery logs none).
    logged = {f"node {e['node']}" for events in nodes.values()
              for e in events}
    check(rows == logged and logged,
          f"forensics trace of {dump}: rows {sorted(rows)}, nodes that "
          f"logged {sorted(logged)}")
    tree, conv = report["fork_tree"], report["convergence"]
    return {"nodes": len(nodes), "events": report["events_merged"],
            "blocks": len(tree["blocks"]),
            "orphaned": len(tree["orphaned"]), "reorgs": conv["reorgs"],
            "converged": conv["converged"], "attacks": attacked,
            "wall_s": wall}


def phase_elastic(device) -> dict:
    """Phase 13: the elastic mesh and forensics on the card. (a) the
    seeded ``mesh.rank_death`` world twice on the card and once on the C++
    sweep, and a clean world; (b) the elastic smoke's SIGKILL world; (c)
    ``mine --elastic --miners 4`` with a collective fault and without; (d)
    forensics over 13 a's dump, a card sim's and the adversarial scenario
    preset's; (e) the skew smoke."""
    from mpi_blockchain_tpu_torch import core, telemetry
    from mpi_blockchain_tpu_torch.meshwatch.aggregate import (rank_status,
                                                              read_shards)
    from mpi_blockchain_tpu_torch.ops import sha256_cuda
    from mpi_blockchain_tpu_torch.resilience import __main__ as res

    card = nvidia_smi("name,power.limit")
    out: dict = {}
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        # (a) the seeded death, on the card twice and on the C++ sweep.
        runs = {}
        for name, on in (("cuda0", "cuda"), ("cuda1", "cuda"),
                         ("cpu", "cpu")):
            runs[name] = res.elastic_rank_death_world(
                tmp, name, on, chain=list(ELASTIC_CHAIN),
                entry=COUNTING_ENTRY)
        victim = runs["cuda0"]["victim"]
        check(all(r["victim"] == victim for r in runs.values()),
              f"13a victims {[r['victim'] for r in runs.values()]}")
        for r, dump in runs["cuda0"]["dumps"].items():
            check(dump == runs["cuda1"]["dumps"][r]
                  == runs["cpu"]["dumps"][r],
                  f"13a rank {r}: dumps differ between the card's two "
                  f"worlds and the C++ sweep's")
        launches = {name: {r: rank_launches(run["stderr"][r])
                           for r in run["summaries"]}
                    for name, run in runs.items()}
        check(all(n > 0 for name in ("cuda0", "cuda1")
                  for n in launches[name].values())
              and set(launches["cpu"].values()) == {0},
              f"13a launches {launches}")
        restripe = {r: registry_total(shard, "speculative_discards_total",
                                      reason="restripe")
                    for r, shard in runs["cuda0"]["shards"].items()}
        clean = clean_elastic_world(tmp)
        out["death"] = {
            "victim": victim, "height": res.RANK_DEATH_HEIGHT,
            "wall_s": {name: run["wall_s"] for name, run in runs.items()},
            "mine_wall_s": {name: {r: v["wall_s"] for r, v in
                                   run["summaries"].items()}
                            for name, run in runs.items()},
            "launches": launches, "restripe_discards": restripe,
            "dump_bytes": {r: len(d) for r, d in
                           runs["cuda0"]["dumps"].items()},
            "clean": clean}
        log(f"phase 13a four mine --elastic ranks (d20/n6/b20) under the "
            f"seeded mesh.rank_death plan: victim {victim} exited 137 with "
            f"no final shard and no dump at height {res.RANK_DEATH_HEIGHT}, "
            f"every survivor evicted it there, exited 0 on cuda:cuda with a "
            f"valid chain; survivor dumps byte-identical across two card "
            f"worlds and the C++ sweep's ({out['death']['dump_bytes']} "
            f"bytes); world walls {out['death']['wall_s']} s, mine_chain "
            f"walls {out['death']['mine_wall_s']} s; the clean world "
            f"{clean['wall_s']:.3f} s (mine_chain {clean['mine_wall_s']} "
            f"s); sweep launches {launches}, clean {clean['launches']}; "
            f"speculative discards for restripe {restripe}; {card}")

        # (b) a SIGKILLed rank, evicted through the shard oracle.
        got = res.smoke_elastic_sigkill(tmp, "cuda", entry=COUNTING_ENTRY)
        status = rank_status(read_shards(tmp / "sigkill" / "mesh"),
                             stall_s=2.0)["ranks"][str(got["victim"])]
        check(status["recommended_action"] == "evict",
              f"13b the victim's oracle verdict {status}")
        incidents = {r: registry_total(shard, "incidents_total",
                                       rule="stale_rank")
                     for r, shard in got["shards"].items()}
        check(set(incidents.values()) == {1},
              f"13b stale_rank incidents by survivor {incidents}")
        out["sigkill"] = {
            "victim": got["victim"], "oracle": status["stale_reason"],
            "eviction_heights": got["eviction_heights"],
            "blocks": got["blocks"], "difficulty": got["difficulty"],
            "wall_s": got["wall_s"],
            "mine_wall_s": {r: v["wall_s"]
                            for r, v in got["summaries"].items()},
            "launches": {r: rank_launches(err)
                         for r, err in got["stderr"].items()},
            "stale_rank_incidents": incidents}
        log(f"phase 13b four mine --elastic ranks on the card, rank "
            f"{got['victim']} SIGKILLed mid-run: the oracle reads it "
            f"{status['stale_reason']} ({status['recommended_action']}), "
            f"every survivor evicted it (heights "
            f"{got['eviction_heights']} of {got['blocks']} d"
            f"{got['difficulty']} blocks), exited 0 on cuda:cuda with a "
            f"valid chain and fired one stale_rank incident; world wall "
            f"{got['wall_s']:.3f} s, mine_chain walls "
            f"{out['sigkill']['mine_wall_s']} s, sweep launches "
            f"{out['sigkill']['launches']}; {card}")

        # (c) the in-process flavor: a collective fault shrinks 4 -> 3.
        plan = tmp / "collective.json"
        plan.write_text(json.dumps({"version": 1, "faults": [
            ELASTIC_COLLECTIVE_FAULT]}))
        rows = {}
        for form, extra in (("clean", []), ("fault",
                                            ["--fault-plan", str(plan)])):
            telemetry.reset()
            sha256_cuda.launches = 0
            rc, summary = run_cli([*ELASTIC_MESH_ARGS, *extra])
            n = sha256_cuda.launches
            what = f"13c mine --elastic --miners 4 ({form})"
            check(rc == 0 and summary.get("tip_hash")
                  == PINNED_TIPS[(20, 10, 20)], f"{what}: rc {rc}, {summary}")
            mesh = summary["mesh"]["device_mesh"]
            want = (3, True) if form == "fault" else (4, False)
            check((mesh["n_live"], mesh["shrunk"]) == want
                  and summary["backend"] == "cuda" and n > 0,
                  f"{what}: {mesh}, backend {summary['backend']}, "
                  f"{n} launches")
            rows[form] = {"wall_s": summary["wall_s"], "launches": n,
                          "n_live": mesh["n_live"]}
        rows["shrink_cost_s"] = rows["fault"]["wall_s"] - \
            rows["clean"]["wall_s"]
        out["mesh"] = rows
        log(f"phase 13c mine --elastic --miners 4 (d20/n10/b20): the "
            f"parallel.collective fault at call "
            f"{ELASTIC_COLLECTIVE_FAULT['call']} shrank the logical miners "
            f"4 -> 3 and the tip is the pin; wall {rows['fault']['wall_s']} "
            f"s against {rows['clean']['wall_s']} s without the fault (the "
            f"shrink's cost {rows['shrink_cost_s']:+.3f} s); sweep launches "
            f"{rows['fault']['launches']} and {rows['clean']['launches']}; "
            f"{card}")

        # (d) forensics over an elastic dump and two sims' dumps.
        sims = {}
        for name, argv in (("sim", FORENSICS_SIM_ARGS),
                           ("attack", FORENSICS_ATTACK_ARGS)):
            dump = str(tmp / f"{name}.json")
            telemetry.reset()
            rc, _ = run_cli([*argv, "--events-dump", dump])
            check(rc == 0, f"13d {' '.join(argv)}: rc {rc}")
            sims[name] = dump
        elastic_dump = str(tmp / "cuda0" / "dump_0.json")
        out["forensics"] = {
            name: forensics_run(dump, str(tmp / f"trace_{name}.json"))
            for name, dump in (("elastic", elastic_dump),
                               ("sim", sims["sim"]),
                               ("attack", sims["attack"]))}
        check(out["forensics"]["attack"]["attacks"],
              "13d: the adversarial scenario's dump holds no attack")
        log(f"phase 13d python -m mpi_blockchain_tpu_torch.forensics --json "
            f"--trace: rc 0 with the fork tree, reorg audit and convergence "
            f"on 13 a's rank-0 dump, on sim --preset adversarial on the card "
            f"and on the adversarial scenario preset (with its attack "
            f"audit), a trace row for every node: {out['forensics']}")

    # (e) the skew smoke, its ranks on the card.
    res_e = run_module("mpi_blockchain_tpu_torch.meshwatch", ["skew-smoke"],
                       SMOKE_TIMEOUT_S)
    check(res_e["rc"] == 0 and res_e["out"].get("ok") is True,
          f"phase 13e skew smoke on the card: rc {res_e['rc']}, "
          f"{res_e['out']}, {res_e['err']}")
    out["skew"] = {**res_e["out"], "wall_s": res_e["wall_s"]}
    log(f"phase 13e mpi_blockchain_tpu_torch.meshwatch skew-smoke (two "
        f"same-seed four-rank --elastic worlds on the card, each rank held "
        f"to cuda:cuda): {res_e['out']}, {res_e['wall_s']:.1f} s; {card}")
    return out


def perfwatch_cli(argv: list[str]) -> tuple[int, str, str]:
    """``python -m mpi_blockchain_tpu_torch.perfwatch argv`` in this
    process: rc, stdout, stderr."""
    from mpi_blockchain_tpu_torch.perfwatch.__main__ import main as pw_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pw_main(argv)
    return rc, out.getvalue(), err.getvalue()


def perfwatch_json(argv: list[str], what: str, want_rc: int = 0) -> dict:
    """The perfwatch CLI's JSON (its last stdout line), held to ``want_rc``."""
    rc, out, err = perfwatch_cli(argv)
    lines = out.strip().splitlines()
    check(rc == want_rc and bool(lines),
          f"{what}: rc {rc} (want {want_rc}), {out[-600:]!r} {err[-600:]!r}")
    return json.loads(lines[-1])


def _without(doc: dict, *keys: str) -> dict:
    return {k: v for k, v in doc.items() if k not in keys}


def perfwatch_history(td: str, bench: dict, card: str) -> dict:
    """Phase 14 (a) and (b): the seeded history, the card's payloads
    recorded beside it, the injected drop and the roofline."""
    from mpi_blockchain_tpu_torch.perfwatch.attribution import \
        payload_utilization
    from mpi_blockchain_tpu_torch.perfwatch.history import HistoryStore

    hist = os.path.join(td, "history.jsonl")
    seeded = perfwatch_json(["record", "--history", hist,
                             "--seed-bench-rounds"], "phase 14a seed")
    check(seeded["recorded"] > 0, f"phase 14a seed: {seeded}")
    keys = {}
    for i, (section, path) in enumerate(PERFWATCH_RECORDS):
        payload = bench
        for step in path:
            payload = payload[step]
        fname = os.path.join(td, f"payload_{i}.json")
        with open(fname, "w") as f:
            json.dump(payload, f)
        rec = perfwatch_json(["record", "--history", hist, "--section",
                              section, "--payload", fname, "--source",
                              "chip_smoke"], f"phase 14a record {section}")
        keys[".".join(map(str, path))] = rec["key"]
    sources = {key: {e.source for e in entries} for key, entries in
               HistoryStore(hist).by_key().items()}
    mixed = {k: v for k, v in sources.items()
             if "chip_smoke" in v and len(v) > 1}
    check(not mixed, f"phase 14a: keys holding a seeded and a card entry: "
          f"{mixed}")
    clean = perfwatch_json(["check", "--json", "--history", hist],
                           "phase 14a check")
    check(clean["regressions"] == 0, f"phase 14a check: {clean}")
    report = perfwatch_json(["report", "--history", hist], "phase 14b report")
    roofline = report.get("roofline") or {}
    pct = roofline.get("bound_utilization_pct", 0.0)
    check(roofline == payload_utilization(bench["sweep"][1]),
          f"phase 14b: roofline {roofline} is not the m1 sweep's")
    check(0.0 < pct <= 100.0,
          f"phase 14b: bound_utilization_pct {pct} outside (0, 100]")
    log(f"phase 14a perfwatch record --seed-bench-rounds: {seeded['recorded']}"
        f" seeded entries; the card's keys {keys}, none holding a seeded "
        f"entry; check --json rc 0, 0 regressions across "
        f"{len(clean['findings'])} series; {card}")
    log(f"phase 14b report roofline (newest card sweep, m1): "
        f"{json.dumps(roofline, sort_keys=True)}; m8: "
        f"{json.dumps(payload_utilization(bench['sweep'][8]), sort_keys=True)}"
        f"; {card}")

    drop = {**bench["sweep"][1], "hashes_per_sec_per_chip":
            PERFWATCH_DROP * bench["sweep"][1]["hashes_per_sec_per_chip"]}
    cand = os.path.join(td, "drop.json")
    with open(cand, "w") as f:
        json.dump(drop, f)
    before = pathlib.Path(hist).read_bytes()
    judged = perfwatch_json(["check", "--json", "--history", hist,
                             "--section", "sweep", "--candidate", cand],
                            "phase 14a candidate", want_rc=1)
    check(pathlib.Path(hist).read_bytes() == before,
          "phase 14a: check --candidate wrote the history")
    perfwatch_json(["record", "--history", hist, "--section", "sweep",
                    "--payload", cand, "--source", "chip_smoke"],
                   "phase 14a record the drop")
    flagged = perfwatch_json(["check", "--json", "--history", hist],
                             "phase 14a check after the drop", want_rc=1)
    bad = [f for f in flagged["findings"] if f["verdict"] == "regression"]
    check(flagged["regressions"] == 1 and len(bad) == 1
          and bad[0]["key"] == keys["sweep.1"],
          f"phase 14a: after the drop {bad}")
    log(f"phase 14a the m1 sweep at {PERFWATCH_DROP} of its rate: check "
        f"--candidate rc 1 ({judged['findings'][0]['delta_pct']}% worse, "
        f"allowed {judged['findings'][0]['allowed_pct']}%), history "
        f"unchanged; recorded, check rc 1 with exactly one regression, on "
        f"{bad[0]['key']}")
    return {"seeded": seeded["recorded"], "keys": keys,
            "roofline": roofline,
            "roofline_m8": payload_utilization(bench["sweep"][8]),
            "drop": bad[0]}


def perfwatch_mesh_views(td: str, world: str | None, card: str) -> dict:
    """Phase 14 (d): the mesh views over a two-rank card world's shards,
    each CLI's JSON against the port's in-process function."""
    from mpi_blockchain_tpu_torch.blocktrace.critical_path import \
        critical_path_report
    from mpi_blockchain_tpu_torch.meshprof.analyzer import analyze_skew
    from mpi_blockchain_tpu_torch.meshwatch.aggregate import (
        mesh_compiles, mesh_incidents, read_shards)
    from mpi_blockchain_tpu_torch.perfwatch.detector import SECTION_BOUNDS

    if world is None:
        world = os.path.join(td, "mesh")
        gloo_world(td, ["--mesh-obs", world], "phase 14d gloo world")
    shards = read_shards(world)
    check([s["rank"] for s in shards] == [0, 1],
          f"phase 14d: shards of ranks {[s['rank'] for s in shards]}")
    records = [r for s in shards for r in s.get("pipeline") or []]
    d = ["--mesh-dir", world]
    cp = perfwatch_json(["critical-path", "--json", *d],
                        "phase 14d critical-path")
    blocks = cp.get("blocks", {})
    check(cp.get("heights") == list(range(1, 11)) and all(
        blocks[str(h)]["complete"] for h in range(1, 11)),
        f"phase 14d critical-path: heights {cp.get('heights')}, "
        f"{ {h: b.get('complete') for h, b in blocks.items()} }")
    check(_without(cp, "event", "source") == critical_path_report(records),
          "phase 14d critical-path: the CLI differs from the function")
    trace = os.path.join(td, "critical_path.json")
    traced = perfwatch_json(["critical-path", "--json", "--trace", trace, *d],
                            "phase 14d critical-path --trace")
    with open(trace) as f:
        events = len(json.load(f)["traceEvents"])
    check(traced["trace"]["events"] == events > 0,
          f"phase 14d --trace: {traced.get('trace')}, {events} events")
    skew = perfwatch_json(["mesh-skew", "--json", *d], "phase 14d mesh-skew")
    bound = SECTION_BOUNDS["collective_skew"]
    check(_without(skew, "event", "source") == analyze_skew(shards),
          "phase 14d mesh-skew: the CLI differs from the function")
    check(skew["site_count"] > 0 and skew["max_skew_ms"] < bound,
          f"phase 14d mesh-skew: {skew['site_count']} sites, max skew "
          f"{skew['max_skew_ms']} ms, bound {bound}")
    inc = perfwatch_json(["incidents", "--json", *d], "phase 14d incidents")
    check(inc["count"] == 0 and inc["incidents"] == mesh_incidents(shards),
          f"phase 14d incidents: {inc}")
    comp = perfwatch_json(["compiles", "--json", *d], "phase 14d compiles")
    mesh = comp.get("mesh", {})
    check(mesh == mesh_compiles(shards)
          and sorted(mesh.get("by_rank", {})) == ["0", "1"]
          and mesh.get("divergent") is False,
          f"phase 14d compiles: {mesh}")
    cost = comp.get("cost", {})
    check(cost.get("loop_instructions_per_nonce", 0) > 0,
          f"phase 14d compiles: cost probe {cost}")
    log(f"phase 14d mesh views over two gloo ranks' shards (d20/n10/b20): "
        f"critical-path heights 1..10 complete, {events} trace events; "
        f"mesh-skew {skew['site_count']} site(s), max skew "
        f"{skew['max_skew_ms']} ms (bound {bound}); {inc['count']} open "
        f"incidents; compiles by rank {mesh['by_rank']}, not divergent; "
        f"cost probe {json.dumps(cost, sort_keys=True)}; each CLI equal to "
        f"the in-process function; {card}")
    return {"events": events, "max_skew_ms": skew["max_skew_ms"],
            "sites": skew["site_count"], "compiles": mesh, "cost": cost}


def world_rounds(nonces: list[int], round_size: int) -> int:
    """Rounds a world sweeps for a chain whose blocks were each searched
    from nonce 0 (one slice a rank a round): the round of each winner."""
    return sum(n // round_size + 1 for n in nonces)


def block_heights(stderr: str) -> list[int]:
    """The heights of the ``block_mined`` lines a ``mine`` printed."""
    return [json.loads(ln)["height"] for ln in stderr.splitlines()
            if '"block_mined"' in ln]


def fused_world(td: str, world_wall: float | None,
                fused_wall: float | None) -> dict:
    """Phase 15 (a): ``mine --fused`` as two gloo processes sharing the
    card at the d24/n1000/b24 pin. Both ranks reach the pin, rank 0 alone
    writes the chain and the summary; each rank sweeps one slice a round
    (the rounds the chain's winners need) and steps once a block and once
    a call, and prints one ``block_mined`` a block."""
    from mpi_blockchain_tpu_torch import core

    what = "15a fused world"
    chain_file = os.path.join(td, "fused_world.bin")
    summary, got, launch_wall = gloo_world(
        td, ["--fused", "--blocks-per-call", str(FUSED_WORLD_K), "--out",
             chain_file], what, chain=FUSED_WORLD_CHAIN, pin=(24, 1000, 24))
    with open(chain_file, "rb") as f:
        blob = f.read()
    check(core.Node(24).load(blob), f"{what}: chain invalid")
    blocks = int(FUSED_WORLD_CHAIN[3])
    rounds = world_rounds(chain_nonces(blob), 2 << int(FUSED_WORLD_CHAIN[5]))
    steps = blocks + -(-blocks // FUSED_WORLD_K)
    counts = [rank_counts(err) for _, err in got]
    for rank, c in enumerate(counts):
        check(c == {"sweep_launches": rounds, "step_launches": steps},
              f"{what}: rank {rank} launched {c}, not {rounds} sweeps and "
              f"{steps} steps")
        check(block_heights(got[rank][1]) == list(range(1, blocks + 1)),
              f"{what}: rank {rank}'s block_mined lines are not one a "
              f"block")
    check(summary["host_waits"] == rounds,
          f"{what}: {summary['host_waits']} host waits for {rounds} rounds")
    log(f"phase 15a mine --fused --blocks-per-call {FUSED_WORLD_K} as two "
        f"gloo processes on one card (d24/n1000/b24): both ranks reach the "
        f"pin, rank 0 alone wrote the chain and the summary; wall "
        f"{summary['wall_s']} s (rank 0's mine_chain; the whole launch "
        f"{launch_wall:.3f} s) beside the per-block world's "
        f"{world_wall} s at d20/n10 (phase 8) and one process's fused "
        f"{fused_wall} s at d24/n1000 (phase 5); launches a rank "
        f"{[(c['sweep_launches'], c['step_launches']) for c in counts]} "
        f"(sweeps, steps) for {rounds} rounds; {summary['host_waits']} host "
        f"waits; bubble_fraction "
        f"{summary.get('pipeline', {}).get('bubble_fraction')}; one "
        f"block_mined a block on each rank's stderr; "
        f"{nvidia_smi('name,power.limit')}")
    return {"wall_s": summary["wall_s"], "launch_wall_s": launch_wall,
            "rounds": rounds, "launches": counts,
            "host_waits": summary["host_waits"],
            "pipeline": summary.get("pipeline"),
            "per_block_world_wall_s": world_wall,
            "single_process_fused_wall_s": fused_wall}


def trace_kernels(path: str, launch_span: str) -> dict:
    """A ``trace_mining`` trace's kernels of ``TRACE_KERNELS`` by kind,
    the host spans (user annotations) by name, and how many of those
    kernels were launched inside a ``launch_span`` span: their launch's
    runtime event (the kernel's correlation id) lies inside one on the
    same thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans: dict[str, list] = {}
    launches = {}
    kernels = {kind: [] for kind in TRACE_KERNELS}
    for ev in events:
        cat, args = ev.get("cat"), ev.get("args", {})
        if cat == "user_annotation":
            spans.setdefault(ev["name"], []).append(ev)
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launches[args["correlation"]] = ev
        elif cat == "kernel":
            for kind, name in TRACE_KERNELS.items():
                if name in ev["name"]:
                    kernels[kind].append(ev)

    def inside(ev, span) -> bool:
        return span["tid"] == ev["tid"] and span["ts"] <= ev["ts"] \
            and ev["ts"] + ev.get("dur", 0) <= span["ts"] + span["dur"]

    enclosed = 0
    for ev in (ev for evs in kernels.values() for ev in evs):
        launch = launches.get(ev.get("args", {}).get("correlation"))
        if launch is not None and any(inside(launch, sp)
                                      for sp in spans.get(launch_span, [])):
            enclosed += 1
    return {"kernels": {kind: len(evs) for kind, evs in kernels.items()},
            "spans": {name: len(evs) for name, evs in sorted(spans.items())},
            "enclosed": enclosed}


def profiled_mines(td: str) -> dict:
    """Phase 15 (b): ``mine --profile DIR`` at the d20/n10/b20 pin, per
    block and fused, each without and with the capture: the pin every
    time; the trace holds one ``sha256d_sweep_kernel`` event a sweep
    launch (and, fused, one ``block_step_kernel`` a step), each launched
    inside its form's host span; the ring one ``block_mined`` a block
    (the repair, 15 d)."""
    from mpi_blockchain_tpu_torch import telemetry
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    out: dict = {}
    for form, extra in PROFILE_FORMS.items():
        row: dict = {}
        for profiled in (False, True):
            what = f"15b mine {form}{' --profile' if profiled else ''}"
            logdir = os.path.join(td, f"trace_{form}")
            flags = ["--profile", logdir] if profiled else []
            telemetry.reset()
            telemetry.clear_events()
            sha256_cuda.launches = sha256_block.step_launches = 0
            t0 = time.perf_counter()
            rc, summary = run_cli(["mine", *WORLD_ARGS, *extra, *flags])
            wall = time.perf_counter() - t0
            sweeps, steps = sha256_cuda.launches, sha256_block.step_launches
            check(rc == 0 and summary.get("tip_hash")
                  == PINNED_TIPS[(20, 10, 20)], f"{what}: rc {rc}, {summary}")
            ringed = telemetry.recent_events(event="block_mined")
            check([r["height"] for r in ringed] == list(range(1, 11)),
                  f"{what}: the ring's block_mined heights "
                  f"{[r['height'] for r in ringed]}")
            key = "profiled" if profiled else "plain"
            row[key] = {"wall_s": summary["wall_s"], "cli_wall_s": wall,
                        "sweeps": sweeps, "steps": steps}
            if not profiled:
                continue
            traces = sorted(pathlib.Path(logdir).glob("*.pt.trace.json"))
            check(len(traces) == 1, f"{what}: traces {traces}")
            got = trace_kernels(str(traces[0]), LAUNCH_SPANS[form])
            row["trace"] = got
            log(f"phase {what}: {got}")
            want = {"sweep": sweeps, "step": steps}
            check(got["kernels"] == want,
                  f"{what}: the trace holds kernels {got['kernels']}, the "
                  f"run launched {want}")
            check(got["enclosed"] == sweeps + steps,
                  f"{what}: {got['enclosed']} of {sweeps + steps} kernels "
                  f"launched inside a {LAUNCH_SPANS[form]} span")
        out[form] = row
        log(f"phase 15b mine{' --fused' if form == 'fused' else ''} "
            f"--profile at the d20/n10/b20 pin: tip matches with and "
            f"without; walls {row['plain']['wall_s']} s without, "
            f"{row['profiled']['wall_s']} s with the capture (the CLI "
            f"calls {row['plain']['cli_wall_s']:.6f} and "
            f"{row['profiled']['cli_wall_s']:.6f} s); the trace holds "
            f"{row['trace']['kernels']} kernels for {sweeps} sweep and "
            f"{steps} step launches, each launched inside "
            f"{LAUNCH_SPANS[form]}; spans {row['trace']['spans']}; 10 "
            f"block_mined on the ring; {nvidia_smi('name,power.limit')}")
    return out


def graft_twin() -> dict:
    """Phase 15 (c): ``graft_entry.dryrun_multichip(GRAFT_MINERS)`` and
    ``entry()`` on the card give the CPU's line and numbers."""
    from mpi_blockchain_tpu_torch import graft_entry
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_cuda

    lines, entries = {}, {}
    for dev in ("cpu", "cuda"):
        sha256_cuda.launches = sha256_block.step_launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            graft_entry.dryrun_multichip(GRAFT_MINERS, device=dev)
        launches = (sha256_cuda.launches, sha256_block.step_launches)
        lines[dev] = [ln for ln in buf.getvalue().splitlines()
                      if ln.startswith("dryrun_multichip(")]
        fn, args = graft_entry.entry(device=dev)
        entries[dev] = [int(x) for x in fn(*args)]
    check(lines["cuda"] == lines["cpu"] and len(lines["cuda"]) == 1,
          f"15c dryrun_multichip({GRAFT_MINERS}): card {lines['cuda']}, "
          f"CPU {lines['cpu']}")
    check(entries["cuda"] == entries["cpu"] and entries["cuda"][0] > 0,
          f"15c entry(): card {entries['cuda']}, CPU {entries['cpu']}")
    log(f"phase 15c graft_entry on the card: {lines['cuda'][0]} (the CPU's "
        f"line); entry() {entries['cuda']} == the CPU's; dry run launches "
        f"(sweeps, steps) {launches}")
    return {"line": lines["cuda"][0], "entry": entries["cuda"],
            "sweeps": launches[0], "steps": launches[1]}


def phase_ported_paths(mesh: dict | None = None,
                       fused: dict | None = None) -> dict:
    """Phase 15: the last of the reference's paths on the card, (a) to
    (d) as the module docstring says. Returns the numbers."""
    out: dict = {}
    with tempfile.TemporaryDirectory() as td:
        out["fused_world"] = fused_world(
            td, mesh["world"]["wall_s"] if mesh else None,
            fused["wall_s"] if fused else None)
        out["profile"] = profiled_mines(td)
    out["graft"] = graft_twin()
    return out


def phase_perfwatch(device, bench: dict | None = None,
                    world: str | None = None) -> dict:
    """Phase 14: the perf sentinel's CLIs on the card (module docstring).
    ``bench`` is phase 7's payloads (measured here when None); ``world``
    is a directory of 12 e's shards (a two-rank world is run here when
    None)."""
    import re

    from mpi_blockchain_tpu_torch.ops import sha256_cuda

    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    if bench is None:
        bench = phase_bench(device, {"wall_s": float("nan")})
    out: dict = {}
    with tempfile.TemporaryDirectory() as td:
        out["history"] = perfwatch_history(td, bench, card)

        before = sha256_cuda.launches
        smoke = perfwatch_json(["smoke"], "phase 14c perfwatch smoke")
        launches = sha256_cuda.launches - before
        check(smoke.get("ok") is True and smoke["healthz"] == "ok"
              and smoke["sweep_launches"] == launches > 0
              and set(smoke["rungs"]) == {"cuda:cuda"},
              f"phase 14c perfwatch smoke: {smoke}, {launches} launches")
        out["smoke"] = smoke
        log(f"phase 14c perfwatch smoke on the card: rc 0, /healthz "
            f"{smoke['healthz']}, /metrics {smoke['metrics_lines']} lines "
            f"with the needles; {launches} sweep launches, rungs "
            f"{smoke['rungs']}; span_attribution_dominant "
            f"{smoke['span_attribution_dominant']}, buckets (s) "
            f"{smoke['span_buckets']}; {card}")

        out["mesh"] = perfwatch_mesh_views(td, world, card)

    res = run_module("mpi_blockchain_tpu_torch.dispatchwatch", ["smoke"],
                     PERFWATCH_TIMEOUT_S, counted=True)
    dw = res["out"]
    check(res["rc"] == 0 and dw.get("ok") is True
          and dw.get("cost", {}).get("loop_instructions_per_nonce", 0) > 0,
          f"phase 14e dispatchwatch smoke: rc {res['rc']}, {dw}, "
          f"{res['err']}")
    out["dispatchwatch"] = {**dw, "launches": rank_launches(res["err"]),
                            "wall_s": res["wall_s"]}
    log(f"phase 14e python -m mpi_blockchain_tpu_torch.dispatchwatch smoke: "
        f"rc 0, {json.dumps(dw, sort_keys=True)}, "
        f"{out['dispatchwatch']['launches']} sweep launches, "
        f"{res['wall_s']:.1f} s; {card}")
    res = run_module("mpi_blockchain_tpu_torch.telemetry", ["--steps", "3"],
                     PERFWATCH_TIMEOUT_S, counted=True)
    missing = [n for n in METRICS_NEEDLES
               if not re.search(n, res["stdout"], re.M)]
    tel_launches = rank_launches(res["err"]) if res["rc"] == 0 else 0
    check(res["rc"] == 0 and not missing and tel_launches > 0
          and 'backend="cuda"' in res["stdout"],
          f"phase 14e telemetry CLI: rc {res['rc']}, missing {missing}, "
          f"{tel_launches} launches, {res['err']}")
    out["telemetry"] = {"launches": tel_launches, "wall_s": res["wall_s"],
                        "snapshot_lines": len(res["stdout"].splitlines())}
    out["launches"] = {"perfwatch_smoke": launches,
                       "dispatchwatch_smoke":
                           out["dispatchwatch"]["launches"],
                       "telemetry_cli": tel_launches}
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14e python -m mpi_blockchain_tpu_torch.telemetry --steps 3: "
        f"rc 0, the metrics-smoke needles, "
        f"{out['telemetry']['snapshot_lines']} snapshot lines, "
        f"{tel_launches} sweep launches, {res['wall_s']:.1f} s; phase 14 "
        f"took {out['wall_s']:.1f} s; {card}")
    return out


def sanitizer_build():
    """Builds phase 16's sanitizer driver (nvcc), beside the kernels."""
    from mpi_blockchain_tpu_torch.analysis import sanitizers

    nvcc = sanitizers.find_nvcc()
    check(nvcc is not None, "no nvcc for the sanitizer driver")
    return sanitizers.build_driver(pathlib.Path(REPO_ROOT), nvcc)


def sanitizer_verdicts(result: dict) -> list[str]:
    """Phase 16 (b)'s check of one run of the sanitizer matrix
    (``analysis.sanitizers.run_matrix``): fails unless the driver's known
    answers held on the card with no tool, and every tool that could
    check here ran it with no error and no failed case and reported its
    poisoned run. Returns the lines to print: one a tool, and one for
    each tool that could not check here."""
    status = result.get("status")
    check(status in ("ok", "tool_unusable", "errors"),
          f"phase 16b sanitizer matrix could not run: {status}, "
          f"{result.get('reason')}")
    plain = result["plain"]
    check(plain["rc"] == 0 and plain["cases_failed"] == 0
          and plain["cases_passed"] >= SANITIZER_CASES,
          f"phase 16b sanitizer driver with no tool: rc {plain['rc']}, "
          f"{plain['cases_passed']} cases ok, {plain['cases_failed']} "
          f"FAIL: {plain['tail'][-600:]}")
    lines = []
    for tool, v in result["clean"].items():
        if not v["usable"]:
            lines.append(f"phase 16b compute-sanitizer --tool {tool} cannot "
                         f"check on this machine: {v['tool_error']} "
                         f"({result['sanitizer']})")
            continue
        poisons = {k: p["errors"] for k, p in result["poisoned"].items()
                   if k.startswith(tool + ":")}
        check(v["errors"] == 0 and v["rc"] == 0 and v["cases_failed"] == 0
              and all(poisons.values()),
              f"phase 16b {tool}: {v['errors']} error(s) "
              f"{v['by_kernel']}, rc {v['rc']}, {v['cases_failed']} case(s) "
              f"FAIL, poisoned runs reported {poisons}: {v['tail'][-600:]}")
        lines.append(f"phase 16b compute-sanitizer --tool {tool}: 0 errors "
                     f"over {v['cases_passed']} cases; poisoned runs "
                     f"reported {poisons or 'none for this tool'}")
    check(status != "errors", f"phase 16b sanitizer matrix: {result}")
    return lines


def phase_static_analysis() -> dict:
    """Phase 16: the port's chainlint and the CUDA library's sanitizer
    matrix on the card, (a) and (b) as the module docstring says. Returns
    the CLI's timings and the matrix's verdicts."""
    from mpi_blockchain_tpu_torch.analysis import pass_families
    from mpi_blockchain_tpu_torch.analysis.sanitizers import kernel_verdicts

    card = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.analysis",
         "--audit-suppressions", "--json"],
        capture_output=True, text=True, cwd=REPO_ROOT,
        timeout=ANALYSIS_TIMEOUT_S, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    lint_wall_s = time.perf_counter() - t0
    try:
        payload = json.loads(proc.stdout)
    except ValueError:
        payload = {}
    check(proc.returncode == 0 and payload.get("findings") == []
          and payload.get("stale_suppressions") == []
          and set(payload.get("pass_timings_ms", {})) == set(pass_families()),
          f"phase 16a chainlint: rc {proc.returncode}, "
          f"{proc.stdout[-2000:]}, {proc.stderr[-4000:]}")
    notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("note:")]
    log(f"phase 16a python -m mpi_blockchain_tpu_torch.analysis "
        f"--audit-suppressions: rc 0, 0 findings, 0 stale suppressions, "
        f"{len(payload['pass_timings_ms'])} families in {lint_wall_s:.1f} s "
        f"(ms by family {payload['pass_timings_ms']}); {card}")
    for note in notes:
        log(f"phase 16a {note}")

    res = run_module("mpi_blockchain_tpu_torch.analysis.sanitizers", [],
                     SANITIZER_TIMEOUT_S)
    result = res["out"]
    check(bool(result), f"phase 16b sanitizer matrix printed nothing: rc "
                        f"{res['rc']}, {res['err']}")
    lines = sanitizer_verdicts(result)
    plain = result["plain"]
    log(f"phase 16b sanitizer driver ({result['driver']}) with no tool: "
        f"{plain['cases_passed']} cases hold their known answers, "
        f"0 FAIL; matrix status {result['status']} in {res['wall_s']:.1f} s; "
        f"{card}")
    for line in lines:
        log(line)
    return {"lint_ms": payload["pass_timings_ms"],
            "lint_wall_s": lint_wall_s, "notes": notes,
            "status": result["status"], "reason": result["reason"],
            "sanitizer": result["sanitizer"],
            "cases": plain["cases_passed"],
            "kernels": kernel_verdicts(result),
            "matrix_wall_s": res["wall_s"]}


def budget_verdict(res: dict, mover: str, what: str) -> str:
    """Phase 17's check of one run of a budget mover's ``--check``
    (``run_module``'s result): rc 0 and a last ``{mover}:`` line on stderr
    saying the budget reproduces. A drifted or unarmed budget fails with
    the mover's own verdict. Returns that line."""
    lines = [ln for ln in res["err"].splitlines()
             if ln.startswith(f"{mover}:")]
    check(res["rc"] == 0 and bool(lines) and "reproduces" in lines[-1],
          f"phase {what} {mover} --check: rc {res['rc']}, "
          f"{lines[-1] if lines else res['err'][-1500:]}")
    return lines[-1]


def budget_world(timeout: float = BUDGET_TIMEOUT_S) -> list[dict]:
    """Phase 17 (c): ``shard_budget --check`` as two gloo ranks sharing
    the card at BUDGET_WORLD_ROUND. Returns each rank's ``run_module``-like
    result (rc, its stderr's tail, wall)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p))
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.analysis.shard_budget",
         "--check", "--device", "cuda", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(rank), *BUDGET_WORLD_ROUND],
        stdout=subprocess.DEVNULL, stderr=err, text=True, env=env,
        cwd=REPO_ROOT) for rank, err in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    results = []
    for p, err in zip(procs, logs):
        err.seek(0)
        results.append({"rc": p.returncode, "err": err.read()[-2000:],
                        "wall_s": wall})
        err.close()
    return results


def phase_budgets() -> dict:
    """Phase 17: the budget movers' checks on the card, (a) to (c) as the
    module docstring says. Returns their walls and the censuses."""
    card = nvidia_smi("name,power.limit")
    res = run_module("mpi_blockchain_tpu_torch.analysis.transfer_budget",
                     ["--check"], BUDGET_TIMEOUT_S)
    log(f"phase 17a {budget_verdict(res, 'transfer_budget', '17a')} in "
        f"{res['wall_s']:.1f} s; {card}")
    transfers = res["out"]
    out = {"transfer_wall_s": res["wall_s"], "transfers": transfers}

    res = run_module("mpi_blockchain_tpu_torch.analysis.opbudget",
                     ["--check"], BUDGET_TIMEOUT_S)
    log(f"phase 17b {budget_verdict(res, 'opbudget', '17b')} in "
        f"{res['wall_s']:.1f} s; {card}")
    for cls, row in sorted(res["out"]["classes"].items()):
        log(f"phase 17b class {cls} (d{row['difficulty_bits']}): loop "
            f"{row['loop_instructions']} instructions, ALU-only "
            f"{row['alu_only']}, source adds {row['source_adds']}, bound "
            f"{row['bound_sm_clocks_per_nonce']:.4f} SM clocks a nonce; "
            f"nvcc {res['out']['nvcc_release']}; {card}")
    out.update(op_wall_s=res["wall_s"], ops=res["out"])

    ranks = budget_world()
    for rank, res in enumerate(ranks):
        line = budget_verdict(res, "shard_budget", f"17c rank {rank}")
        log(f"phase 17c rank {rank}: {line}; world wall "
            f"{res['wall_s']:.1f} s; {card}")
    out["world_wall_s"] = ranks[0]["wall_s"]
    return out


def gate_verdict(res: dict) -> list[str]:
    """Phase 18's check of ``gate --device cuda --resolve`` (``run_module``'s
    result): rc 0, the card named, and one ``resolves`` line for every step
    of ``gate.STEPS``, in its order. Returns the gate's lines."""
    from mpi_blockchain_tpu_torch.gate import STEPS

    lines = [ln for ln in res["stdout"].splitlines()
             if ln.startswith("gate: ")]
    steps = [ln.split(":")[1].strip() for ln in lines[1:-1]]
    check(res["rc"] == 0 and bool(lines)
          and lines[0].startswith("gate: device cuda: ")
          and steps == [s.name for s in STEPS]
          and all(": resolves: " in ln for ln in lines[1:-1])
          and lines[-1].startswith(f"gate: resolved {len(STEPS)} step(s)"),
          f"phase 18 gate --resolve: rc {res['rc']}, "
          f"{res['stdout'][-3000:]} {res['err']}")
    return lines


def phase_gate() -> dict:
    """Phase 18: the port's gate parses its whole plan on the card, as the
    module docstring says. Returns its wall and step count."""
    card = nvidia_smi("name,power.limit")
    res = run_module("mpi_blockchain_tpu_torch.gate",
                     ["--device", "cuda", "--resolve"], GATE_TIMEOUT_S)
    lines = gate_verdict(res)
    for line in lines:
        log(f"phase 18 {line}")
    log(f"phase 18 gate --device cuda --resolve: rc 0, {len(lines) - 2} "
        f"steps resolve in {res['wall_s']:.1f} s; {card}")
    return {"wall_s": res["wall_s"], "steps": len(lines) - 2}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        from mpi_blockchain_tpu_torch.core.build import ensure_built
        from mpi_blockchain_tpu_torch.ops import sha256_cuda
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not here ({e})",
              file=sys.stderr)
        return 1
    keep = tempfile.mkdtemp(prefix="chip_smoke_")
    # The runs in this process print a block_mined line a block (the event
    # stream's INFO on stderr): into a file here, so that the output stays
    # readable; the ring keeps them as well.
    from mpi_blockchain_tpu_torch.utils.logging import get_logger
    events_log = open(os.path.join(keep, "events.log"), "w")
    get_logger().handlers[0].setStream(events_log)
    try:
        device = torch.device("cuda", 0)
        card = nvidia_smi("name,power.limit")
        log(card)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            builds = [pool.submit(sha256_cuda.build),
                      pool.submit(ensure_built),
                      pool.submit(sanitizer_build)]
            for b in builds:
                b.result()
        log(f"built the CUDA kernel, the C++ core and the sanitizer driver "
            f"in {time.perf_counter() - t0:.1f} s")
        from mpi_blockchain_tpu_torch import dispatchwatch
        startup_nvcc = dispatchwatch.compile_census().get(
            sha256_cuda.COMPILE_SITE, {}).get("compiles", 0)
        rng = np.random.default_rng(20261016)
        mismatches, max_err = phase_kernel_vs_plain(rng, device)
        phase_backend(rng, device)
        chain = phase_tips(device)
        timing = phase_timing(rng, device)
        step = phase_step(rng, device, timing["sm_clock_mhz"])
        symbol_mismatches = phase_ext_symbol(device)
        fused = phase_fused(device, chain)
        resilience = phase_resilience(device)
        resilience["wedge"] = phase_wedge(device)
        bench = phase_bench(device, fused[(24, 1000)])
        mesh = phase_mesh(device, chain, fused[(24, 1000)],
                          chain["d20_wall_s"])
        sim = phase_sim(device)
        serve = phase_serve(device)
        trace = phase_trace(device, startup_nvcc)
        world = os.path.join(keep, "mesh")
        mesh_obs = phase_mesh_obs(device, keep_world=world)
        elastic = phase_elastic(device)
        perfwatch = phase_perfwatch(device, bench, world)
        ported = phase_ported_paths(mesh, fused[(24, 1000)])
        static = phase_static_analysis()
        phase_budgets()
        phase_gate()
    except (SmokeFailure, subprocess.CalledProcessError, RuntimeError,
            ValueError, AssertionError) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        get_logger().handlers[0].setStream(sys.stderr)
        events_log.close()
        shutil.rmtree(keep, ignore_errors=True)
    f24, f16 = fused[(24, 1000)], fused[(16, 30)]
    world15 = ported["fused_world"]["launches"]
    log(f"card: {card}")
    log(json.dumps({"kernels": [{
        "name": "sha256d_sweep", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": f24["sweeps"],
        "launches_miner_d24_n1000": chain["launches"],
        "searches": chain["searches"], "mismatches": mismatches,
        "ext_symbol_mismatches": symbol_mismatches,
        "max_abs_err": max_err, "bound_by": "operations", "library_ms": None,
        **timing,
        "d24_n1000_wall_s": chain["wall_s"],
        "d24_n1000_hashes_per_s": chain["hashes_per_s"],
        "d24_n1000_kernel_s": chain["kernel_s"],
        "d24_n1000_kernel_share": chain["kernel_s"] / chain["wall_s"],
        "d24_n1000_least_nonces": chain["least_nonces"],
        "fused_d24_n1000": f24, "fused_d16_n30": f16,
        "launches_bench_chain_d24_n1000": bench["chain"]["sweeps"],
        "launches_mesh8_miner_d24_n1000": mesh["miner"]["sweeps"],
        "launches_mesh8_fused_d24_n1000": mesh["fused"]["sweeps"],
        "launches_sim_adversarial": sim["preset"]["launches"],
        "launches_sim_d24": sim["d24"]["launches"],
        "bounded_mismatches": sim["bounded"]["mismatches"],
        "launches_serve_smoke": serve["smoke"]["launches"],
        "launches_serve_d24_n1000": {
            turn: [r["launches"] for r in rs] for turn, rs in
            serve["full_width"].items() if turn in ("load", "quiet")},
        "launches_serve_metrics_d20_n10":
            serve["serve_metrics"]["launches"],
        "serve_mismatches": serve["smoke"]["mismatches"]
        + serve["full_width"]["mismatches"],
        "launches_trace_miner_d24_n1000": {
            turn: [r["launches"] for r in rows]
            for turn, rows in trace["miner"].items()},
        "launches_trace_fused_d24_n1000": trace["fused"]["sweeps"],
        "launches_mesh_obs_miner_d24_n1000": {
            turn: [r["launches"] for r in rows]
            for turn, rows in mesh_obs["miner"].items()},
        "launches_mesh_obs_fused_d24_n1000": mesh_obs["fused"]["sweeps"],
        "launches_elastic": {
            "a_rank_death": elastic["death"]["launches"],
            "a_clean": elastic["death"]["clean"]["launches"],
            "b_sigkill": elastic["sigkill"]["launches"],
            "c_mesh": {form: elastic["mesh"][form]["launches"]
                       for form in ("fault", "clean")}},
        "launches_perfwatch": perfwatch["launches"],
        "launches_ported_paths": {
            "a_fused_world_by_rank": [c["sweep_launches"] for c in world15],
            "b_profile": {form: [r["sweeps"] for r in
                                 (row["plain"], row["profiled"])]
                          for form, row in ported["profile"].items()},
            "c_graft": ported["graft"]["sweeps"]},
        "bench": bench, "mesh8": mesh, "resilience": resilience,
        "sim": sim, "serve": serve, "trace": trace,
        "mesh_obs": mesh_obs, "elastic": elastic,
        "perfwatch": perfwatch, "ported_paths": ported,
        "sanitizers": static["kernels"]["sha256d_sweep"],
        "sanitizers_ext_symbol_copy": static["kernels"]["ext_symbol_copy"],
        "sanitizer_cases": static["cases"],
        "static_analysis": {k: static[k] for k in (
            "lint_ms", "lint_wall_s", "status", "reason", "sanitizer",
            "matrix_wall_s")}}, {
        "name": "sha256d_block_step", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": STEP_REPLACES,
        "launches": f24["steps"], "bound_by": "operations",
        "library_ms": None, **step,
        "launches_bench_chain_d24_n1000": bench["chain"]["steps"],
        "launches_mesh8_fused_d24_n1000": mesh["fused"]["steps"],
        "launches_sim_adversarial": sim["preset"]["step_launches"],
        "launches_sim_d24": sim["d24"]["step_launches"],
        "launches_serve": serve["step_launches"],
        "launches_trace_fused_d24_n1000": trace["fused"]["steps"],
        "launches_mesh_obs_fused_d24_n1000": mesh_obs["fused"]["steps"],
        "launches_ported_paths": {
            "a_fused_world_by_rank": [c["step_launches"] for c in world15],
            "b_profile_fused": [r["steps"] for r in (
                ported["profile"]["fused"]["plain"],
                ported["profile"]["fused"]["profiled"])],
            "c_graft": ported["graft"]["steps"]},
        "gap_d24_n1000": {key: f24[key] for key in GAP_KEYS},
        "gap_d16_n30": {key: f16[key] for key in GAP_KEYS},
        "sanitizers": static["kernels"]["sha256d_block_step"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
