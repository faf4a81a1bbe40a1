"""meshprof: collective-skew spans and device-memory watermarks.

The port's part of the reference's ``meshprof``:

* **spans**: every rank stamps monotonic enter/exit times per collective
  site (``skew_span(site=...)``) into a bounded ring; the winner-select
  round of a world of processes is the instrumented seam
  (``mesh.sweep``).
* **memory**: per-device allocator watermarks sampled at dispatch
  boundaries (``torch.cuda.memory_stats``), never initializing CUDA in a
  process that has not; incident bundles and the ``hbm_watermark_growth``
  rule read them.

The skew analyzer reads per-rank shards and waits for the ``--mesh-obs``
slice of the port. Every emit point records nothing under
``MPIBT_TELEMETRY_OFF``.
"""
from __future__ import annotations

from .memory import (device_memory_stats, memory_snapshot,  # noqa: F401
                     sample_memory)
from .spans import clear_spans, skew_span, spans_tail  # noqa: F401
