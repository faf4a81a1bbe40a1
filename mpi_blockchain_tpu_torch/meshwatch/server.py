"""Mesh-aware HTTP endpoint over a shard directory.

The port's copy of the reference's ``meshwatch/server.py``.
The per-process perfwatch server answers for ONE rank; this one answers
for the mesh: every scrape re-reads the shard directory, merges, and
serves

* ``/healthz`` — ``aggregate.mesh_health``: 200 while every expected
  rank is fresh or finished, 503 naming stale/failed/missing ranks;
* ``/metrics`` — the merged Prometheus view (counters summed,
  gauges/histograms per-rank under ``rank``, ``mesh_live_ranks`` /
  ``mesh_rank_up`` liveness series);
* ``/ranks`` — the per-rank liveness JSON (status, stale reason, shard
  age, heartbeat age, pid);
* ``/incidents`` — every open chainwatch incident carried by the
  shards, rank-stamped (the live-SLO view; ``/healthz`` carries the
  same list under its additive ``incidents`` key).

Run it with ``python -m mpi_blockchain_tpu_torch.meshwatch watch --dir
DIR``.
The lifecycle scaffolding (bind, daemon serve thread, idempotent
``close()``, hardened ``_send``) is inherited from perfwatch's
``MetricsServer`` — one copy, hardened once; this server only swaps in
its own routes and stays out of the perfwatch active-server registry
(it observes a directory, not this process's registry).
"""
from __future__ import annotations

import json

from ..perfwatch.server import MetricsServer, _Handler
from .aggregate import merge_shards, mesh_health, mesh_incidents, \
    read_shards, render_mesh_prometheus


class _MeshHandler(_Handler):
    def do_GET(self) -> None:  # noqa: N802 (stdlib signature)
        ctx = self.server_ctx
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            code, payload = mesh_health(ctx.directory,
                                        stall_s=ctx.mesh_stall_s)
            self._send(code, json.dumps(payload, sort_keys=True) + "\n",
                       "application/json")
        elif path == "/metrics":
            shards = read_shards(ctx.directory)
            _, health = mesh_health(ctx.directory,
                                    stall_s=ctx.mesh_stall_s,
                                    shards=shards)
            body = render_mesh_prometheus(merge_shards(shards), health)
            self._send(200, body,
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/ranks":
            _, health = mesh_health(ctx.directory,
                                    stall_s=ctx.mesh_stall_s)
            self._send(200, json.dumps(health.get("ranks", {}),
                                       sort_keys=True) + "\n",
                       "application/json")
        elif path == "/incidents":
            incidents = mesh_incidents(read_shards(ctx.directory))
            self._send(200, json.dumps({"incidents": incidents,
                                        "count": len(incidents)},
                                       sort_keys=True) + "\n",
                       "application/json")
        else:
            self._send(404, json.dumps({
                "error": f"unknown path {path!r}",
                "endpoints": ["/healthz", "/incidents", "/metrics",
                              "/ranks"]}) + "\n",
                "application/json")


class MeshServer(MetricsServer):
    """Threaded endpoint over a shard directory; scrape-time merging."""

    handler_cls = _MeshHandler
    register_active = False     # observes a directory, not this process

    def __init__(self, directory, port: int = 0, host: str = "127.0.0.1",
                 stall_s: float | None = None):
        super().__init__(port=port, host=host)
        self.directory = directory
        # None defers to aggregate's MPIBT_MESH_STALL default — distinct
        # from the base class's per-process healthz budget.
        self.mesh_stall_s = stall_s

    def url(self, path: str = "/healthz") -> str:
        return super().url(path)
