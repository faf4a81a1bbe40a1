"""Per-device memory telemetry: watermarks at dispatch edges.

The port's copy of the reference's ``meshprof/memory.py``.
``sample_memory()`` is called from the pipeline profiler's dispatch
boundary and throttled to at most one real sample per
``SAMPLE_INTERVAL_S``, so a hot mining loop pays a clock read, not a
device query. ``device_memory_stats()`` reads PyTorch's caching allocator
(``torch.cuda.memory_stats``) and the card's capacity (its properties'
``total_memory``) where the reference reads the JAX device's
``memory_stats()``. ``torch.cuda.mem_get_info`` is not used: it is a
query of the driver on every sample, where the card's capacity does not
change and is read once from its cached properties. The hard contract: it never initializes CUDA in a
process that has not already done so (``torch.cuda.is_initialized()``),
and never imports torch itself (it looks torch up in ``sys.modules``).
A process that has not touched the card samples ``{}``.

Keys, as the reference names them: ``bytes_in_use`` (the allocator's
allocated bytes now), ``peak_bytes_in_use`` (their peak), ``bytes_limit``
(the card's total memory) and ``num_allocs`` (allocations so far). For
each device the peak observed ``bytes_in_use`` is kept across samples,
because the interesting precursor of running out is the high-water mark
between reads. ``memory_snapshot()`` is the bundle/rule projection and
samples first, so a fresh process is never empty-handed.
"""
from __future__ import annotations

import sys
import threading
import time

from ..telemetry.registry import telemetry_disabled

#: Minimum seconds between real device queries from the hot path.
SAMPLE_INTERVAL_S = 0.5

#: ``torch.cuda.memory_stats`` keys under the reference's names.
_STAT_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
              "peak_bytes_in_use": "allocated_bytes.all.peak",
              "num_allocs": "allocation.all.allocated"}

_lock = threading.Lock()
_last_sample = 0.0
_watermarks: dict[str, dict] = {}


def device_memory_stats() -> dict:
    """{device: stats} for every CUDA device whose allocator holds or held
    memory. Empty when torch was never imported, when CUDA is not
    initialized in this process (reading a card would initialize it), or
    when no allocation was ever made."""
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    if cuda is None or not cuda.is_initialized():
        return {}
    out: dict[str, dict] = {}
    for index in range(cuda.device_count()):
        stats = cuda.memory_stats(index)
        picked = {k: int(stats[key]) for k, key in _STAT_KEYS.items()
                  if isinstance(stats.get(key), (int, float))}
        if not picked.get("peak_bytes_in_use") and \
                not stats.get("reserved_bytes.all.current"):
            continue        # nothing was ever allocated on this device
        picked["bytes_limit"] = int(
            cuda.get_device_properties(index).total_memory)
        out[f"cuda:{index}"] = picked
    return out


def sample_memory(*, force: bool = False) -> dict:
    """Throttled watermark update from the dispatch hot path. Returns the
    current watermark map (callers wanting a copy use
    ``memory_snapshot``)."""
    global _last_sample
    if telemetry_disabled():
        return {}
    now = time.monotonic()
    if not force and now - _last_sample < SAMPLE_INTERVAL_S:
        return _watermarks          # the common case, without the lock
    with _lock:
        if not force and now - _last_sample < SAMPLE_INTERVAL_S:
            return _watermarks
        _last_sample = now
    stats = device_memory_stats()
    if not stats:
        return _watermarks
    with _lock:
        for dev, cur in stats.items():
            mark = _watermarks.setdefault(dev, {})
            for k, v in cur.items():
                if k in ("bytes_in_use", "peak_bytes_in_use"):
                    mark[k] = max(mark.get(k, 0), v)
                else:
                    mark[k] = v
            mark["last_bytes_in_use"] = cur.get("bytes_in_use",
                                                mark.get("last_bytes_in_use",
                                                         0))
    return _watermarks


def memory_snapshot() -> dict:
    """Copy of the per-device watermarks (samples first, so a new process
    reports at once). ``{}`` where CUDA was never initialized."""
    if telemetry_disabled():
        return {}
    sample_memory(force=True)
    with _lock:
        return {dev: dict(mark) for dev, mark in sorted(_watermarks.items())}


def clear_memory() -> None:
    """Resets the watermarks and the throttle (test isolation)."""
    global _last_sample
    with _lock:
        _watermarks.clear()
        _last_sample = 0.0
