"""Live observability of the port: the reference's ``perfwatch`` without
its CLI and attribution.

* ``server``: ``MetricsServer``, the stdlib HTTP endpoint behind
  ``--serve-metrics PORT`` (or ``MPIBT_METRICS_PORT``) on mine, sim and
  bench, serving ``/metrics``, ``/healthz`` and ``/events``; the front
  door's server builds on it.
* ``history``: the append-only JSONL store of bench payloads
  (``PERF_HISTORY.jsonl``), keyed by section and configuration.
* ``detector``: the spread-aware change detector and the absolute
  ``SECTION_BOUNDS`` (the ``serve`` p99 cap the serve smoke is judged by).

Standard library only. The ``python -m ... perfwatch`` CLI (record,
check, report) is not ported yet.
"""
from __future__ import annotations

from .detector import check_candidate, check_history  # noqa: F401
from .history import HistoryStore  # noqa: F401
from .server import MetricsServer, active_server  # noqa: F401
