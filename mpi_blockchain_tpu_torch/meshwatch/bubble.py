"""The pipeline-bubble audit: before/after ``bubble_fraction`` from a
fixed-seed instrumented mine (the ``pipeline_bubble`` bench section).

The port's copy of the reference's ``meshwatch/bubble.py``, on the same
C++ sweep (``backend="cpu"``): the audit prices how far the pipelined
driver hides per-block host work behind a sweep of several milliseconds.
On the card a d15 sweep takes microseconds against milliseconds of
checkpoint writes, so the same mine there would read close to 1: a
different measurement. The card's own bubble is measured at full width
by ``chip_smoke.py`` (phase 11 a).

Runs the SAME deterministic cpu-world mine twice — once through the
sequential oracle (``Miner(pipeline=False)``), once through the async
double-buffered pipeline — with per-block checkpoint writes through the
real ``on_block`` seam (the host work the pipeline exists to hide), then
prices both legs with meshwatch's ``pipeline_report``:

* ``bubble_fraction_sequential`` — the BEFORE number: every checkpoint
  write, winner validation and template build serializes with the
  device, so the device idles behind them;
* ``bubble_fraction`` — the AFTER number, the section's headline: the
  same host work overlapped by the speculatively-dispatched next sweep.
  ``detector.SECTION_BOUNDS`` caps it at 0.15.

The audit also proves the two legs mined byte-identical chains
(``chain_identical`` — the determinism contract is part of the payload,
not a separate trust), and reports whether the ``device`` stage is the
dominant per-block critical-path stage on every block of the pipelined
leg (``device_dominant_blocks`` vs ``blocks`` — the blocktrace form of
the same acceptance). ``meshwatch pipeline-smoke`` gates all three.

The mine is seed-fixed: winner nonces are a pure function of
(payloads, difficulty), so the work per block is identical run to run —
only scheduler weather moves the fractions, which is why the smoke uses
the best-of-N shape the other absolute-bound gates use.
"""
from __future__ import annotations

import pathlib
import tempfile

#: The fixed audit config: difficulty and payload prefix chosen so
#: every block's deterministic winner nonce buys a sweep comfortably
#: above the per-block host work it must hide (with the "sweep" prefix
#: at difficulty 15 the smallest winner across the 12 heights is 7793
#: nonces — several ms of C++ search on any box), blocks enough to
#: average scheduler weather. Winner nonces are a pure function of
#: (prefix, difficulty), so these numbers cannot drift per machine.
AUDIT_DIFFICULTY = 15
AUDIT_BLOCKS = 12
AUDIT_PREFIX = "sweep"


def _mine_leg(pipeline: bool, difficulty: int, blocks: int,
              workdir: pathlib.Path) -> dict:
    """One instrumented mine against a fresh profiler; returns the leg's
    pipeline report + chain hashes + per-block critical-path split."""
    from ..blocktrace.critical_path import critical_path_report
    from ..config import MinerConfig
    from ..models.miner import Miner
    from ..utils.checkpoint import save_chain
    from .pipeline import pipeline_report, profiler, reset_profiler

    cfg = MinerConfig(difficulty_bits=difficulty, n_blocks=blocks,
                      backend="cpu", data_prefix=AUDIT_PREFIX)
    ckpt = workdir / ("chain-pipelined.ckpt" if pipeline
                      else "chain-sequential.ckpt")
    miner = Miner(cfg, pipeline=pipeline)
    reset_profiler()

    def on_block(rec) -> None:
        # The real checkpoint seam, every block: the serialized host
        # work whose overlap (or not) IS the measurement.
        with profiler().segment_on_last("checkpoint"):
            save_chain(miner.node, ckpt, cfg)

    miner.mine_chain(on_block=on_block)
    records = profiler().records()
    report = pipeline_report(records)
    crit = critical_path_report(records)
    dominant = 0
    for h in crit["heights"]:
        stages = crit["blocks"][str(h)]["stages_ms"]
        if stages and max(stages, key=stages.get) == "device":
            dominant += 1
    return {
        "bubble_fraction": report["bubble_fraction"],
        "host_overlapped_fraction": report["host_overlapped_fraction"],
        "dispatches": report["dispatch_count"],
        "heights": crit["heights"],
        "device_dominant_blocks": dominant,
        "chain": miner.chain_hashes(),
    }


def measure_pipeline_bubble(difficulty: int = AUDIT_DIFFICULTY,
                            blocks: int = AUDIT_BLOCKS) -> dict:
    """The ``pipeline_bubble`` bench payload (module docstring)."""
    # The checkpoint writes go to the temporary directory (TMPDIR); the
    # reference prefers /dev/shm, which lies outside what the port writes.
    with tempfile.TemporaryDirectory() as tmp:
        workdir = pathlib.Path(tmp)
        seq = _mine_leg(False, difficulty, blocks, workdir)
        pip = _mine_leg(True, difficulty, blocks, workdir)
    return {
        "backend": "cpu",
        "difficulty_bits": difficulty,
        "n_blocks": blocks,
        # The section headline, bounded by SECTION_BOUNDS (<= 0.15).
        "bubble_fraction": pip["bubble_fraction"],
        "host_overlapped_fraction": pip["host_overlapped_fraction"],
        # The BEFORE leg: same seed, sequential oracle.
        "bubble_fraction_sequential": seq["bubble_fraction"],
        "host_overlapped_fraction_sequential":
            seq["host_overlapped_fraction"],
        "dispatches": pip["dispatches"],
        "blocks": len(pip["heights"]),
        "device_dominant_blocks": pip["device_dominant_blocks"],
        "chain_identical": seq["chain"] == pip["chain"],
    }
