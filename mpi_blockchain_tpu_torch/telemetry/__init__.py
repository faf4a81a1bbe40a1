"""Telemetry of the port: a metrics registry, spans, a JSON-lines event
stream, causal logs and the crash flight recorder.

The port's copy of the part of the reference's ``telemetry`` package that
the port's layers use: counters, gauges and histograms on a process-local
registry (``registry``), host spans filed as ``span_seconds``
(``spans``), the event stream (``events``), the simulation's Lamport-clock
causal logs (``causal``), the crash dump of all of these on an abnormal
exit (``flight_recorder``, ``--flight-recorder`` on mine/sim/bench), a
progress heartbeat gauge and a Prometheus dump. The profiler capture and
the rest of the observability wait for a later slice of the port. All of
it is host-side and standard library only.
"""
from __future__ import annotations

import pathlib

from .causal import (CausalLog, LamportClock,  # noqa: F401
                     dump_causal_logs, load_causal_dump)
from .events import clear_events, emit_event, recent_events  # noqa: F401
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricError, Registry, default_registry, reset,
                       set_telemetry_disabled, telemetry_disabled)


def counter(name: str, help: str = "", **labels) -> Counter:
    """Get-or-create a counter on the default registry."""
    return default_registry().counter(name, help=help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    """Get-or-create a gauge on the default registry."""
    return default_registry().gauge(name, help=help, **labels)


def histogram(name: str, help: str = "", **labels) -> Histogram:
    """Get-or-create a histogram on the default registry."""
    return default_registry().histogram(name, help=help, **labels)


def span_seconds(name: str) -> float:
    """Seconds the spans named ``name`` took in all (0 when none ran)."""
    for m in default_registry().metrics():
        if m.name == "span_seconds" and dict(m.labels).get("span") == name:
            return m.sum
    return 0.0


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
