"""Process-local metrics registry: counters and gauges.

The port's copy of the reference's ``telemetry/registry.py``, cut to what
the resilience layer needs: counters, gauges, the get-or-create
``Registry`` and its Prometheus text snapshot. Histograms, spans, the kill
switch and the rest of the observability wait for a later slice of the
port.

* **Host-only.** Metrics are plain Python objects mutated on the host.
* **Thread-safe.** Any thread may count (the CPU backend's ranks run on a
  pool), so every mutation takes the metric's lock.

Identity is (name, sorted label items): ``counter("x", backend="cpu")``
returns the same object on every call, and re-registering a name with a
different metric kind raises ``MetricError``.
"""
from __future__ import annotations

import threading
import time

LabelItems = tuple[tuple[str, str], ...]


class MetricError(ValueError):
    """Metric misuse: kind conflict, negative counter increment, ..."""


def _label_items(labels: dict) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(items: LabelItems, extra: LabelItems = ()) -> str:
    pairs = sorted(items + extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _render_value(v: float) -> str:
    if isinstance(v, bool):  # bool is an int subclass; be explicit
        return str(int(v))
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return f"{v:.9g}"


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = "", labels: LabelItems = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter. ``inc`` with a negative amount raises."""

    kind = "counter"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._value = 0

    def inc(self, amount: int | float = 1) -> None:
        if amount < 0:
            raise MetricError(
                f"counter {self.name!r} cannot decrease (inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def sample_lines(self) -> list[str]:
        return [f"{self.name}{_render_labels(self.labels)} "
                f"{_render_value(self.value)}"]

    def to_dict(self) -> dict:
        return {"kind": self.kind, "labels": dict(self.labels),
                "value": self.value}


class Gauge(_Metric):
    """Point-in-time value: set / inc / dec.

    Every mutation stamps ``last_set`` on the monotonic clock, so readers
    can tell "0 because idle since t" from "0 because never set":
    ``age_s()`` is None until the first mutation, and a never-set gauge
    emits no Prometheus sample (its 0.0 default would be a lie).
    """

    kind = "gauge"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._value = 0.0
        self._last_set: float | None = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            self._last_set = time.monotonic()

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self._value += amount
            self._last_set = time.monotonic()

    def dec(self, amount: float = 1) -> None:
        with self._lock:
            self._value -= amount
            self._last_set = time.monotonic()

    @property
    def value(self):
        with self._lock:
            return self._value

    def age_s(self) -> float | None:
        """Seconds since the last mutation; None when never set."""
        with self._lock:
            if self._last_set is None:
                return None
            return time.monotonic() - self._last_set

    def sample_lines(self) -> list[str]:
        with self._lock:
            never_set = self._last_set is None
        if never_set:
            return []
        return [f"{self.name}{_render_labels(self.labels)} "
                f"{_render_value(self.value)}"]

    def to_dict(self) -> dict:
        age = self.age_s()
        return {"kind": self.kind, "labels": dict(self.labels),
                "value": self.value,
                "age_s": None if age is None else round(age, 3)}


# Prometheus TYPE keyword per metric kind.
_PROM_TYPE = {"counter": "counter", "gauge": "gauge"}


class Registry:
    """Get-or-create metric store + the Prometheus exporter."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, LabelItems], _Metric] = {}

    def _get(self, cls, name: str, help: str, labels: dict):
        key = (name, _label_items(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=key[1])
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise MetricError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            if help and not m.help:
                m.help = help
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def total(self, name: str) -> float:
        """The sum of every labelset of metric ``name`` (0 when it was
        never registered)."""
        return sum(m.value for m in self.metrics() if m.name == name)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format snapshot."""
        lines: list[str] = []
        seen_header: set[str] = set()
        for m in self.metrics():
            if m.name not in seen_header:
                seen_header.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {_PROM_TYPE[m.kind]}")
            lines.extend(m.sample_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-able snapshot: {metric name: [per-labelset dicts]}."""
        out: dict[str, list] = {}
        for m in self.metrics():
            out.setdefault(m.name, []).append(m.to_dict())
        return out


_default = Registry()
_default_lock = threading.Lock()


def default_registry() -> Registry:
    return _default


def reset() -> Registry:
    """Replaces the default registry with a fresh one (test and CLI
    isolation). Call sites resolve ``default_registry()`` per call, so the
    swap is safe at any quiet point."""
    global _default
    with _default_lock:
        _default = Registry()
        return _default
