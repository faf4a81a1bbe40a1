"""Roofline position and span-split attribution for perf findings.

The port's copy of the reference's ``perfwatch/attribution.py``. A
regression report answers two questions beyond "the number fell":

1. **How far from the card's ceiling is the measured rate?** The
   reference prices its sweep rate against a TPU's vector-unit peak. The
   port prices it against the sweep's own bound on the card, the one
   ``bench_lib.sweep_bound_ms`` and ``chip_smoke.py`` phase 4 use: the
   least time a call of ``nonces_per_call`` nonces can take, from the
   compiled loop's ALU-only instructions and the source's adds
   (``ops.sha256_cuda.bound_sm_clocks_per_nonce``) over the card's SMs at
   their maximum clock. A card ``sweep`` payload carries it as
   ``bound_ms`` (``bench_lib.bench_cuda``), so ``utilization`` needs no
   constant of its own.

2. **Which layer ate the time?** The spans split a run into device
   dispatch (``backend.cuda.dispatch``, ``fused.dispatch``), host tail
   (``backend.cuda.host_tail``, ``backend.cpu.search``, ``miner.append``)
   and device init (``bench.device_init``); ``attribute_spans`` folds the
   ``span_seconds`` summaries into those buckets and names the dominant
   one. ``attribute_pipeline`` (host and device overlap) and
   ``memory_axis`` (device byte watermarks) are the other two axes.
"""
from __future__ import annotations

from ..parallel.mesh import NONCE_SPACE


def nonces_per_call(payload: dict) -> int:
    """Nonces one call of a ``bench_cuda`` sweep payload swept: n_miners x
    2^batch_pow2, clipped at 2^32 as the bench clips its calls."""
    return min(int(payload.get("n_miners", 1)) << int(payload["batch_pow2"]),
               NONCE_SPACE)


def utilization(measured_hashes_per_s: float, bound_ms: float,
                nonces: int, kernel_ms: float | None = None) -> dict:
    """The roofline position of a measured sweep rate on the card: the
    rate over the bound's rate for calls of ``nonces`` nonces that take at
    least ``bound_ms`` each. With ``kernel_ms``, the median card time of
    one such call, also the bound over it (the kernel alone, without the
    host's share of the wall)."""
    out = {
        "measured_mhs": measured_hashes_per_s / 1e6,
        "bound_ms": bound_ms,
        "nonces_per_call": nonces,
        "bound_mhs": round(nonces / bound_ms * 1e3 / 1e6, 1),
        "bound_utilization_pct": round(
            100 * measured_hashes_per_s * bound_ms / 1e3 / nonces, 2),
    }
    if kernel_ms:
        out["kernel_ms"] = kernel_ms
        out["kernel_bound_pct"] = round(100 * bound_ms / kernel_ms, 2)
    return out


def payload_utilization(payload: dict) -> dict | None:
    """``utilization`` of a ``sweep`` payload that carries its bound (a
    card record); None for one that does not (a CPU run, or a record of
    the reference's)."""
    bound_ms = payload.get("bound_ms")
    if not bound_ms or "batch_pow2" not in payload:
        return None
    return utilization(float(payload["hashes_per_sec_per_chip"]),
                       float(bound_ms), nonces_per_call(payload),
                       payload.get("kernel_ms"))


# ---- span-split attribution ----------------------------------------------

# span name -> bucket. Unlisted spans fold into "other" (they still
# count toward the total so fractions stay honest).
SPAN_BUCKETS = {
    "backend.cuda.dispatch": "device",
    "fused.dispatch": "device",
    "backend.cuda.host_tail": "host",
    "backend.cpu.search": "host",
    "miner.append": "host",
    "bench.device_init": "init",
}


def attribute_spans(registry=None) -> dict:
    """Folds the ``span_seconds`` summaries of a registry into
    device / host / init / other buckets.

    Returns {"buckets": {bucket: {"seconds", "fraction", "spans"}},
    "total_s", "dominant"}: ``device``-dominant means the kernel itself
    (check the roofline), ``init`` means the build and device start grew,
    ``host`` means the append and read-back tail. An empty registry gives
    dominant None.
    """
    from ..telemetry import default_registry

    reg = registry if registry is not None else default_registry()
    buckets: dict[str, dict] = {}
    total = 0.0
    for m in reg.metrics():
        if m.name != "span_seconds" or m.kind != "histogram":
            continue
        labels = dict(m.labels)
        span_name = labels.get("span", "")
        bucket = SPAN_BUCKETS.get(span_name, "other")
        b = buckets.setdefault(bucket, {"seconds": 0.0, "spans": {}})
        b["seconds"] += m.sum
        b["spans"][span_name] = round(m.sum, 6)
        total += m.sum
    for b in buckets.values():
        b["fraction"] = round(b["seconds"] / total, 4) if total else 0.0
        b["seconds"] = round(b["seconds"], 6)
    dominant = (max(buckets, key=lambda k: buckets[k]["seconds"])
                if buckets else None)
    return {"buckets": buckets, "total_s": round(total, 6),
            "dominant": dominant}


# ---- dispatch pipeline attribution ---------------------------------------


def attribute_pipeline(records: list[dict] | None = None) -> dict:
    """Whether host and device time overlapped: the dispatch profiler's
    ``meshwatch.pipeline.pipeline_report`` (per-rank stage totals,
    ``overlap_s``, ``bubble_fraction``) over ``records``, or over this
    process's profiler when None."""
    from ..meshwatch.pipeline import pipeline_report

    return pipeline_report(records)


# ---- device-memory attribution -------------------------------------------


def memory_axis(shards: list[dict] | None = None) -> dict:
    """Per-device byte watermarks (``meshprof.memory``), folded mesh-wide
    from ``--mesh-obs`` shards when given, else this process's snapshot.
    No device reported gives an empty axis with a zero peak, never an
    invented device."""
    devices: dict[str, dict] = {}
    if shards is not None:
        for s in shards:
            mem = s.get("memory")
            if not isinstance(mem, dict):
                continue
            rank = s.get("rank")
            for dev, mark in mem.items():
                if isinstance(mark, dict):
                    devices[f"r{rank}/{dev}"] = dict(mark)
    else:
        from ..meshprof.memory import memory_snapshot

        devices = memory_snapshot()
    peak = max((m.get("peak_bytes_in_use", m.get("bytes_in_use", 0))
                for m in devices.values()), default=0)
    return {"devices": dict(sorted(devices.items())),
            "device_count": len(devices),
            "peak_bytes_in_use": int(peak)}
