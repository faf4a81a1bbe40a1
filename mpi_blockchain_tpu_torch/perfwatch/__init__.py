"""Live observability and the perf-regression sentinel of the port: the
reference's ``perfwatch``.

* ``server``: ``MetricsServer``, the stdlib HTTP endpoint behind
  ``--serve-metrics PORT`` (or ``MPIBT_METRICS_PORT``) on mine, sim and
  bench, serving ``/metrics``, ``/healthz`` and ``/events``; the front
  door's server builds on it.
* ``history``: the append-only JSONL store of bench payloads, keyed by
  section and configuration, and its seeding from the repo's bench round
  records (``seed_from_bench_rounds``).
* ``detector``: the spread-aware change detector and the absolute
  ``SECTION_BOUNDS``.
* ``attribution``: the card's roofline (a sweep rate against the sweep's
  own bound), the span-split attribution, and the pipeline and memory
  axes.

CLI: ``python -m mpi_blockchain_tpu_torch.perfwatch {record,check,report,
critical-path,mesh-skew,incidents,compiles,serve,smoke}``; ``check``
exits 1 on a regression. ``__main__`` lists where it differs from the
reference. The package itself is standard library only.
"""
from __future__ import annotations

from .detector import check_candidate, check_history  # noqa: F401
from .history import HistoryStore  # noqa: F401
from .server import MetricsServer, active_server  # noqa: F401
