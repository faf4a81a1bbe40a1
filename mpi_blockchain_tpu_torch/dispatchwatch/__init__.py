"""dispatchwatch: the compile census.

The port's copy of the reference's ``dispatchwatch``. Every other lens
watches the execution of device programs; this one watches their
creation. The reference feeds its census from JAX's compile-duration
listener. The port compiles other things, and feeds the census from the
work it really does:

* each ``nvcc`` build of ``ops/csrc/sha256d_sweep.cu``
  (``ops.sha256_cuda.build``: site ``ops.sha256_cuda``, stage ``nvcc``);
  a build that finds the library up to date runs no compiler and records
  nothing;
* each load of the built library (the same site, stage ``load``);
* the first use of each k-block program of the fused miner
  (``FusedMiner._fn(k)``: site ``fused``, stage ``program``), under
  ``compile_scope(site="fused")``, with ``note_cache(site="fused", ...)``
  reporting the size of its cache.

``nvcc`` and ``program`` stages are compiles (``COMPILE_STAGES``): they
advance the per-site census, ``compiles_total{site}``,
``compile_ms{site}`` and a bounded event ring; other stages only count
per site. The invariant a healthy steady-state run keeps is ``compiles ==
cache_entries`` per site: every compile bought a cache entry that is used
from then on. ``recompiles()`` prices the violation, the
``recompile_storm`` chainwatch rule watches the census grow after warmup,
and ``compile_snapshot()`` is what incident bundles carry (``{}`` while
off or when nothing was seen). Standard library only.
"""
from __future__ import annotations

import threading
from collections import deque

from ..telemetry.registry import telemetry_disabled

#: Stages that created a program: they advance the census and the
#: recompile signal. Other stages (a library ``load``) ride along as
#: per-site stage counts.
COMPILE_STAGES = ("nvcc", "program")

#: Site label for compiles recorded outside any ``compile_scope``.
UNSCOPED_SITE = "unscoped"

#: Bounded compile-event ring (same order as the skew-span ring).
COMPILE_RING_SIZE = 1024
#: Newest compile events a snapshot carries.
COMPILE_TAIL_N = 64

_lock = threading.Lock()
_sites: dict[str, dict] = {}
_events: deque = deque(maxlen=COMPILE_RING_SIZE)
_tls = threading.local()    # per-thread compile_scope site stack


def _new_site() -> dict:
    return {"compiles": 0, "compile_ms": 0.0, "cache_entries": 0,
            "stages": {}}


def current_site() -> str:
    """The innermost live ``compile_scope`` site on this thread,
    ``UNSCOPED_SITE`` outside any scope."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else UNSCOPED_SITE


def record_compile(*, site: str, stage: str = "program",
                   duration_s: float = 0.0) -> None:
    """One observed program-creation stage at ``site`` (keyword-only). A
    stage in ``COMPILE_STAGES`` advances the census, the ring,
    ``compiles_total{site}`` and ``compile_ms{site}``; other stages only
    count per site."""
    if telemetry_disabled():
        return
    from ..meshprof.spans import wall_now

    site = str(site)
    ms = duration_s * 1000.0
    compiled = stage in COMPILE_STAGES
    with _lock:
        st = _sites.setdefault(site, _new_site())
        st["stages"][stage] = st["stages"].get(stage, 0) + 1
        if compiled:
            st["compiles"] += 1
            st["compile_ms"] += ms
            _events.append({"t": wall_now(), "site": site,
                            "ms": round(ms, 3), "stage": stage})
    if compiled:
        from ..telemetry import counter, histogram

        counter("compiles_total",
                help="programs compiled (nvcc builds, k-block programs), "
                     "by site", site=site).inc()
        histogram("compile_ms", help="wall time per compiled program",
                  site=site).observe(ms)


class compile_scope:
    """``with compile_scope(site="fused"): <first use of a program>``: the
    one compile-attribution idiom (``site=`` is keyword-only). Stamps the
    site that ``current_site()`` gives on this thread while the scope is
    live. Records nothing under ``MPIBT_TELEMETRY_OFF``."""

    __slots__ = ("site", "_armed")

    def __init__(self, *, site: str):
        self.site = str(site)
        self._armed = not telemetry_disabled()

    def __enter__(self):
        if not self._armed:
            return self
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.site)
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._armed:
            return False
        stack = getattr(_tls, "stack", None)
        if stack:
            stack.pop()
        return False


def note_cache(*, site: str, entries: int) -> None:
    """Per-site cache census (``site=`` keyword-only): a seam that caches
    compiled programs calls this when its cache changes size, so the
    census can price ``compiles - cache_entries`` per site. A flag check
    under ``MPIBT_TELEMETRY_OFF``."""
    if telemetry_disabled():
        return
    n = int(entries)
    with _lock:
        _sites.setdefault(str(site), _new_site())["cache_entries"] = n
    from ..telemetry import gauge

    gauge("trace_cache_entries",
          help="cached compiled programs, by site", site=site).set(n)


def compile_census() -> dict:
    """{site: {compiles, compile_ms, cache_entries, stages}} copies,
    sorted by site: the recompile-storm rule's sample and the bundle
    overlay. ``{}`` under the kill switch or when nothing was seen."""
    if telemetry_disabled():
        return {}
    with _lock:
        return {site: {**st, "compile_ms": round(st["compile_ms"], 3),
                       "stages": dict(st["stages"])}
                for site, st in sorted(_sites.items())}


def compile_events_tail(n: int = COMPILE_TAIL_N) -> list[dict]:
    """Copies of the newest ``n`` compile events."""
    if telemetry_disabled():
        return []
    with _lock:
        recs = list(_events)[-n:] if n is not None else list(_events)
    return [dict(r) for r in recs]


def recompiles(census: dict | None = None) -> int:
    """Compiles the census cannot account for with a cache entry, summed
    over sites: 0 on a healthy steady-state run. A site that never
    reported a cache prices every compile past the first."""
    if census is None:
        census = compile_census()
    total = 0
    for st in census.values():
        have = int(st.get("cache_entries", 0)) or 1
        total += max(0, int(st.get("compiles", 0)) - have)
    return total


def compile_snapshot() -> dict:
    """What incident bundles carry: the per-site census and the newest
    compile events; ``{}`` while off or when nothing was seen."""
    if telemetry_disabled():
        return {}
    sites = compile_census()
    events = compile_events_tail()
    if not sites and not events:
        return {}
    return {"sites": sites, "events": events}


def clear_compiles() -> None:
    """Resets the census and the event ring (test isolation)."""
    with _lock:
        _sites.clear()
        _events.clear()
