"""Telemetry of the port: a metrics registry and a JSON-lines event stream.

The port's copy of the part of the reference's ``telemetry`` package that
the resilience layer needs: counters and gauges on a process-local
registry (``registry``), the event stream (``events``), a progress
heartbeat gauge and a Prometheus dump. Histograms, spans, NVTX ranges,
the profiler and the rest of the observability wait for a later slice of
the port. All of it is host-side and standard library only.
"""
from __future__ import annotations

import pathlib

from .events import clear_events, emit_event, recent_events  # noqa: F401
from .registry import (Counter, Gauge, MetricError,  # noqa: F401
                       Registry, default_registry, reset)


def counter(name: str, help: str = "", **labels) -> Counter:
    """Get-or-create a counter on the default registry."""
    return default_registry().counter(name, help=help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    """Get-or-create a gauge on the default registry."""
    return default_registry().gauge(name, help=help, **labels)


def heartbeat(name: str) -> Gauge:
    """Get-or-create a progress-heartbeat gauge: the value is a progress
    marker (a height), the age of its ``last_set`` its staleness. Names
    end in ``_heartbeat``."""
    if not name.endswith("_heartbeat"):
        raise MetricError(f"heartbeat gauge {name!r} must end "
                          f"'_heartbeat'")
    return default_registry().gauge(
        name, help="progress heartbeat (value: progress marker; "
                   "last_set age: staleness)")


def render_prometheus() -> str:
    return default_registry().render_prometheus()


def dump_metrics(path: str | pathlib.Path) -> pathlib.Path:
    """Writes the default registry's Prometheus snapshot to ``path``."""
    path = pathlib.Path(path)
    path.write_text(render_prometheus())
    return path
