"""blocktrace: per-block critical-path attribution.

The port's copy of the reference's ``blocktrace`` package, in three
pieces:

* **context** (re-exported here): a thread-local block trace context, a
  ``(height, template, rank)`` identity pushed by ``trace_block(height,
  template=...)`` around everything a block goes through. Pipeline
  profiler segments recorded inside it carry the ``height`` (so each block
  of a fused call keeps its own validate/append segments), and
  ``emit_event`` stamps a ``trace`` field onto every event emitted in it.
* **critical_path**: joins pipeline records into a per-block waterfall:
  each stage's exclusive wall time, the longest dependency chain, a
  device / collective / host split, and gap accounting such that
  ``sum(stages) + gap == wall`` exactly. A pure function of its records.
  ``observe_block_metrics`` feeds the live ``block_critical_path_ms`` and
  ``block_trace_gap_pct`` histograms and is where the ``chainwatch``
  watchdog is evaluated.
* **overhead**: prices the instrumentation itself, instrumented against
  ``MPIBT_TELEMETRY_OFF`` in paired rounds (``python -m
  mpi_blockchain_tpu_torch.blocktrace overhead``).

This ``__init__`` re-exports only the context layer: ``meshwatch.pipeline``
imports it from the telemetry hot path, and the analyzer imports
meshwatch back, so pulling it in here would make a cycle.
"""
from __future__ import annotations

from .context import (BlockTrace, current_trace, trace_block,  # noqa: F401
                      trace_dict)
