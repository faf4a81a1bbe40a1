"""meshwatch: the dispatch pipeline profiler.

The port's part of the reference's ``meshwatch``: ``pipeline`` times every
miner dispatch's segments (enqueue, device, validate, append, checkpoint)
into a bounded ring, prices per-dispatch overlap and the device's bubble
fraction (``pipeline_report``), and exports a wall-clock Perfetto
timeline (``to_chrome_trace``). The per-rank shards, their aggregation,
the mesh server and the CLI wait for the ``--mesh-obs`` slice of the
port. Standard library only.
"""
from __future__ import annotations

from .pipeline import (DispatchRecord, PipelineProfiler,  # noqa: F401
                       pipeline_report, profiler, reset_profiler,
                       strip_block_identity, to_chrome_trace)
