"""Process-local metrics registry: counters, gauges, histograms.

The port's copy of the reference's ``telemetry/registry.py``: counters,
gauges, histograms with a bounded deterministic reservoir, the
get-or-create ``Registry`` with its span log and Prometheus text snapshot,
and the kill switch that turns spans off.

* **Host-only.** Metrics are plain Python objects mutated on the host.
* **Thread-safe.** Any thread may count (the CPU backend's ranks run on a
  pool), so every mutation takes the metric's lock.
* **Bounded.** Histograms keep exact count/sum/min/max plus a fixed-size
  reservoir (seeded reservoir sampling, Vitter's algorithm R), so a
  million observations cost the memory of a thousand.

Identity is (name, sorted label items): ``counter("x", backend="cpu")``
returns the same object on every call, and re-registering a name with a
different metric kind raises ``MetricError``.
"""
from __future__ import annotations

import collections
import os
import random
import threading
import time
import zlib

LabelItems = tuple[tuple[str, str], ...]

# ---- the kill switch --------------------------------------------------------
# MPIBT_TELEMETRY_OFF (or ``set_telemetry_disabled(True)``) turns every span
# into a bare yield (no clock read, no stack push, nothing filed) and makes
# the helpers ``telemetry.counter/gauge/histogram/heartbeat`` hand out the
# shared null metric. It exists to price the instrumentation itself, as in
# the reference; direct Registry calls stay live.

_telemetry_off = bool(os.environ.get("MPIBT_TELEMETRY_OFF"))


def telemetry_disabled() -> bool:
    return _telemetry_off


def set_telemetry_disabled(flag: bool) -> bool:
    """Flips the kill switch; returns the previous state (callers restore
    it in a finally)."""
    global _telemetry_off
    prev = _telemetry_off
    _telemetry_off = bool(flag)
    return prev


# Finished spans kept for inspection; bounded so a long run cannot grow the
# registry without limit.
SPAN_LOG_SIZE = 4096


class MetricError(ValueError):
    """Metric misuse: kind conflict, negative counter increment, ..."""


def _label_items(labels: dict) -> LabelItems:
    if len(labels) <= 1:
        # The common case on the hot path, without a sort.
        return tuple((str(k), str(v)) for k, v in labels.items())
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


class Histogram(_Metric):
    """Distribution with exact count/sum/min/max + a bounded reservoir.

    Quantiles come from the reservoir (nearest rank on the sorted sample).
    The reservoir uses Vitter's algorithm R with a per-metric crc32-seeded
    RNG, so a run is exactly reproducible and no global RNG state is
    touched.
    """

    kind = "histogram"
    RESERVOIR_SIZE = 1024
    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name, help="", labels=(),
                 reservoir_size: int | None = None):
        super().__init__(name, help, labels)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._cap = (reservoir_size if reservoir_size is not None
                     else self.RESERVOIR_SIZE)
        self._reservoir: list[float] = []
        seed = zlib.crc32(repr((name, labels)).encode())
        self._rng = random.Random(seed)

    def observe(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
            if len(self._reservoir) < self._cap:
                self._reservoir.append(value)
            else:
                # randrange(count) for count > 0, without its argument
                # checks: the same draw from the same generator.
                j = self._rng._randbelow(self._count)
                if j < self._cap:
                    self._reservoir[j] = value

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile over the reservoir; None when empty."""
        if not 0.0 <= q <= 1.0:
            raise MetricError(f"quantile {q} outside [0, 1]")
        with self._lock:
            sample = sorted(self._reservoir)
        if not sample:
            return None
        idx = min(int(q * len(sample)), len(sample) - 1)
        return sample[idx]

    def snapshot(self) -> dict:
        with self._lock:
            stats = {"count": self._count, "sum": self._sum,
                     "min": self._min, "max": self._max}
        stats.update({f"p{int(q * 100)}": self.quantile(q)
                      for q in self.QUANTILES})
        return stats

    def sample_lines(self) -> list[str]:
        lines = []
        for q in self.QUANTILES:
            v = self.quantile(q)
            if v is None:
                continue
            lines.append(
                f"{self.name}"
                f"{_render_labels(self.labels, (('quantile', str(q)),))} "
                f"{_render_value(v)}")
        lines.append(f"{self.name}_count{_render_labels(self.labels)} "
                     f"{_render_value(self.count)}")
        lines.append(f"{self.name}_sum{_render_labels(self.labels)} "
                     f"{_render_value(self.sum)}")
        return lines

    def to_dict(self) -> dict:
        return {"kind": self.kind, "labels": dict(self.labels),
                **self.snapshot()}


class _NullMetric:
    """The shared do-nothing metric the helpers hand out while telemetry
    is off: accepts every mutation of every kind, records nothing."""

    kind = "null"
    name = "null"
    labels: LabelItems = ()
    value = 0
    count = 0
    sum = 0.0

    def inc(self, amount: float = 1) -> None:
        pass

    def dec(self, amount: float = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def age_s(self) -> None:
        return None

    def quantile(self, q: float) -> None:
        return None

    def snapshot(self) -> dict:
        return {}

    def to_dict(self) -> dict:
        return {"kind": self.kind, "labels": {}, "value": 0}


NULL_METRIC = _NullMetric()


# Prometheus TYPE keyword per metric kind (histograms render as summaries:
# the reservoir gives quantiles, not fixed buckets).
_PROM_TYPE = {"counter": "counter", "gauge": "gauge",
              "histogram": "summary"}


class Registry:
    """Get-or-create metric store + the span log + the Prometheus
    exporter."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, LabelItems], _Metric] = {}
        self._spans = collections.deque(maxlen=SPAN_LOG_SIZE)
        # The hot path's lookups by call-site spelling (kind, name, the
        # labels as given), in front of the canonical key; read without
        # the lock (a dict read is atomic), filled on a miss.
        self._by_call: dict[tuple, _Metric] = {}
        self._span_hists: dict[str, Histogram] = {}

    def _get(self, cls, name: str, help: str, labels: dict, **kwargs):
        try:
            call = (cls, name, tuple(labels.items()))
            m = self._by_call.get(call)
        except TypeError:           # an unhashable label value
            call = m = None
        if m is not None:
            if help and not m.help:
                m.help = help
            return m
        m = self._get_canonical(cls, name, help, labels, **kwargs)
        if call is not None:
            self._by_call[call] = m
        return m

    def _get_canonical(self, cls, name: str, help: str, labels: dict,
                       **kwargs):
        key = (name, _label_items(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=key[1], **kwargs)
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

    def histogram(self, name: str, help: str = "",
                  reservoir_size: int | None = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         reservoir_size=reservoir_size)

    def record_span(self, span) -> None:
        """Files a finished span: kept in the bounded log and mirrored as
        a ``span_seconds`` summary labeled by span name."""
        self._spans.append(span)
        hist = self._span_hists.get(span.name)
        if hist is None:
            hist = self._span_hists[span.name] = self.histogram(
                "span_seconds", help="wall-clock seconds per telemetry span",
                span=span.name)
        hist.observe(span.duration_s)

    def spans(self, name: str | None = None) -> list:
        out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

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
