"""Telemetry of the port: a metrics registry, spans, a JSON-lines event
stream, causal logs and the crash flight recorder.

The port's copy of the part of the reference's ``telemetry`` package that
the port's layers use: counters, gauges and histograms on a process-local
registry (``registry``), host spans filed as ``span_seconds``
(``spans``), the event stream (``events``), the simulation's Lamport-clock
causal logs (``causal``), the crash dump of all of these on an abnormal
exit (``flight_recorder``, ``--flight-recorder`` on mine/sim/bench), a
progress heartbeat gauge (``heartbeat_snapshot`` is what ``/healthz`` and
the front door's accept gate read), this process's mesh rank
(``set_mesh_rank``; ``blocktrace`` frames and ``meshwatch.pipeline``
records carry it, ``rank_counter`` labels with it) and a Prometheus dump.
``python -m mpi_blockchain_tpu_torch.telemetry`` (``__main__``) runs the
instrumented mine and faulted simulation on the card (``--device cpu``:
the C++ sweep) and prints the snapshot. The profiler capture that nests
the spans beside the card's kernels is ``utils/profiling.py``
(``mine --profile``). All of it is host-side and standard library only.
"""
from __future__ import annotations

import pathlib

from .causal import (CausalLog, LamportClock,  # noqa: F401
                     dump_causal_logs, load_causal_dump)
from .events import clear_events, emit_event, recent_events  # noqa: F401
from . import registry as _registry
from .registry import (NULL_METRIC, Counter, Gauge,  # noqa: F401
                       Histogram, MetricError, Registry, default_registry,
                       reset, set_telemetry_disabled, telemetry_disabled)


def counter(name: str, help: str = "", **labels) -> Counter:
    """Get-or-create a counter on the default registry (the null metric
    while the kill switch is on)."""
    if _registry._telemetry_off:
        return NULL_METRIC
    # ``Registry._get``'s hit on its call-site table, answered here
    # without its frame: counters are per-sweep emits.
    reg = _registry._default
    try:
        m = reg._by_call.get((Counter, name, tuple(labels.items())))
    except TypeError:               # an unhashable label value
        m = None
    if m is None or (help and not m.help):
        return reg._get(Counter, name, help, labels)
    return m


# ---- mesh-rank context ----------------------------------------------------
# One rank id per process, stamped by whoever knows it first
# (``parallel.distributed.init_distributed``). Per-rank metrics take their
# ``rank`` label from it through ``rank_counter``.

_mesh_rank: int = 0


def set_mesh_rank(rank: int) -> None:
    """Declares this process's mesh rank (0-based); ``rank_counter``
    labels with it by default."""
    global _mesh_rank
    _mesh_rank = int(rank)


def mesh_rank() -> int:
    return _mesh_rank


def rank_counter(name: str, help: str = "", rank: int | None = None,
                 **labels) -> Counter:
    """A counter labeled with the mesh rank (this process's by default)."""
    if telemetry_disabled():
        return NULL_METRIC
    labels = dict(labels)
    labels["rank"] = str(rank if rank is not None else mesh_rank())
    return default_registry().counter(name, help=help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    """Get-or-create a gauge on the default registry."""
    if telemetry_disabled():
        return NULL_METRIC
    return default_registry().gauge(name, help=help, **labels)


def histogram(name: str, help: str = "", **labels) -> Histogram:
    """Get-or-create a histogram on the default registry."""
    if telemetry_disabled():
        return NULL_METRIC
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
    if _registry._telemetry_off:
        return NULL_METRIC
    # As in ``counter``: the call-site table's hit without a frame.
    reg = _registry._default
    m = reg._by_call.get((Gauge, name, ()))
    if m is None or not m.help:
        return reg._get(Gauge, name, _HEARTBEAT_HELP, {})
    return m


_HEARTBEAT_HELP = ("progress heartbeat (value: progress marker; last_set "
                   "age: staleness)")


def heartbeat_snapshot(registry: Registry | None = None) -> dict:
    """Every ``*_heartbeat`` gauge as {``name{k=v}...``: {"value",
    "age_s"}}: the one spelling of a heartbeat that ``/healthz`` and the
    front door's accept gate read."""
    reg = registry if registry is not None else default_registry()
    beats: dict[str, dict] = {}
    for m in reg.metrics():
        if m.kind != "gauge" or not m.name.endswith("_heartbeat"):
            continue
        age = m.age_s()
        label = m.name + "".join(f"{{{k}={v}}}" for k, v in m.labels)
        beats[label] = {"value": m.value,
                        "age_s": None if age is None else round(age, 3)}
    return beats


def render_prometheus() -> str:
    return default_registry().render_prometheus()


def dump_metrics(path: str | pathlib.Path) -> pathlib.Path:
    """Writes the default registry's Prometheus snapshot to ``path``."""
    path = pathlib.Path(path)
    path.write_text(render_prometheus())
    return path
