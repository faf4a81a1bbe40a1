"""meshwatch: per-rank telemetry shards, mesh-wide aggregation, and the
dispatch pipeline profiler.

The port's copy of the reference's ``meshwatch``:

* **shard**: each rank atomically writes a rank-stamped shard file
  (registry snapshot, heartbeats, event and causal tails, pipeline
  records, skew spans, memory watermarks, open incidents, the compile
  census, the door's stats) into a shared directory on a background
  flusher (``--mesh-obs DIR`` / ``MPIBT_MESH_OBS`` on mine, bench, sim and
  serve). A clean exit writes a ``final`` shard with its exit status; a
  SIGKILLed rank leaves a non-final shard whose age keeps growing, and
  that asymmetry is the dead-rank signal.
* **aggregate**: merges shards into one mesh view (counters summed,
  gauges and histograms per rank under a ``rank`` label, heartbeats
  compared); ``mesh_health`` names stale, failed and missing ranks, and
  ``server.MeshServer`` serves it as the mesh ``/healthz``.
* **pipeline**: times every miner dispatch's segments (enqueue, device,
  validate, append, checkpoint) into a bounded ring, prices per-dispatch
  overlap and the device's bubble fraction (``pipeline_report``), and
  exports a wall-clock Perfetto timeline (``to_chrome_trace``);
  ``bubble`` is the reference's fixed-seed bubble audit on the C++ sweep.

CLI: ``python -m mpi_blockchain_tpu_torch.meshwatch {merge,report,watch,
smoke,bubble,pipeline-smoke}``. Standard library only.
"""
from __future__ import annotations

from .aggregate import (merge_shards, mesh_health,  # noqa: F401
                        rank_status, read_shards,
                        recommended_action, render_mesh_prometheus)
from .pipeline import (DispatchRecord, PipelineProfiler,  # noqa: F401
                       pipeline_report, profiler, reset_profiler,
                       strip_block_identity, to_chrome_trace)
from .shard import ShardWriter, install, installed, uninstall  # noqa: F401
