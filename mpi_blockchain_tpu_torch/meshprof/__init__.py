"""meshprof: collective-skew spans and device-memory watermarks.

The port's part of the reference's ``meshprof``:

* **spans**: every rank stamps monotonic enter/exit times per collective
  site (``skew_span(site=...)``) into a bounded ring; the winner-select
  round of a world of processes is the instrumented seam
  (``mesh.sweep``).
* **analyzer**: joins the spans of every rank's meshwatch shard into
  per-(site, round) arrival-delta distributions, names the straggler
  rank, its lag and the implied idle time, with per-rank clock offsets
  normalized out first; ``publish_skew`` mirrors a report onto the
  registry (the ``collective_skew_ms{site}`` histogram, which chainwatch's
  ``collective_skew_spike`` rule reads, and ``mesh_straggler_rank``).
* **memory**: per-device allocator watermarks sampled at dispatch
  boundaries (``torch.cuda.memory_stats``), never initializing CUDA in a
  process that has not; shards, incident bundles and the
  ``hbm_watermark_growth`` rule read them.

Every emit point records nothing under ``MPIBT_TELEMETRY_OFF``.
"""
from __future__ import annotations

from .analyzer import (analyze_skew, publish_skew,  # noqa: F401
                       skew_shape, skew_summary)
from .memory import (device_memory_stats, memory_snapshot,  # noqa: F401
                     sample_memory)
from .spans import clear_spans, skew_span, spans_tail  # noqa: F401
