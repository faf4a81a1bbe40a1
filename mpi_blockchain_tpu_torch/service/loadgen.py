"""Seeded load generator for the serve bench/smoke.

The port's copy of the reference's ``service/loadgen.py``.

The request SET is a pure function of the seed (crc32 over packed
``(seed, i)``: no global RNG, no wall clock in any decision), so two same-seed runs submit byte-identical
payloads with identical fees in identical order. What the SERVER does
with them (which concurrent worker lands first, which tx gets evicted)
is the system under test; the generator only promises its side is
deterministic and that every response is accounted: accepted,
duplicate, typed shed, lost receipt (an empty 200 — the ``partial``
fault's signature, resolved later via ``tx_status``), or transport
error. ``untyped_sheds`` counts non-2xx responses WITHOUT a
``shed_reason`` — the smoke pins it at zero.

The report doubles as the ``serve`` bench payload: sustained
``requests_per_sec``, ``p99_latency_ms``, ``shed_fraction`` and the
pool's high-water ``mempool_depth_max`` land in PERF_HISTORY.jsonl
under the SECTION_BOUNDS p99 budget.
"""
from __future__ import annotations

import json
import queue
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib


def requests_for_seed(seed: int, n: int) -> list[dict]:
    """The deterministic request schedule: ``n`` submits with
    crc32-derived fees (1..1000) and per-seed unique payloads."""
    out = []
    for i in range(n):
        h = zlib.crc32(struct.pack("<II", seed & 0xFFFFFFFF, i))
        out.append({"payload": f"tx-{seed & 0xFFFFFFFF:08x}-{i:04d}",
                    "fee": 1 + h % 1000})
    return out


def _post_submit(base_url: str, req: dict, timeout_s: float) -> dict:
    """One submit roundtrip -> {"outcome", "latency_s", ...detail}."""
    body = json.dumps(req).encode()
    http_req = urllib.request.Request(
        base_url.rstrip("/") + "/submit", data=body,
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(http_req, timeout=timeout_s) as resp:
            raw = resp.read().decode()
            code = resp.status
    except urllib.error.HTTPError as e:
        raw = e.read().decode()
        code = e.code
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        return {"outcome": "error", "latency_s": time.monotonic() - t0,
                "detail": str(e)}
    latency = time.monotonic() - t0
    if not raw.strip():
        # the partial-fault signature: admitted, receipt lost.
        return {"outcome": "receipt_lost", "latency_s": latency,
                "code": code}
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError:
        return {"outcome": "error", "latency_s": latency, "code": code,
                "detail": "unparseable body"}
    if code == 200 and doc.get("result") in ("accepted", "duplicate"):
        return {"outcome": doc["result"], "latency_s": latency,
                "txid": doc.get("txid")}
    reason = doc.get("shed_reason")
    if reason:
        return {"outcome": "shed", "latency_s": latency, "code": code,
                "shed_reason": reason, "txid": doc.get("txid")}
    return {"outcome": "untyped", "latency_s": latency, "code": code,
            "detail": doc}


def p99_ms(latencies_s: list[float]) -> float:
    if not latencies_s:
        return 0.0
    ordered = sorted(latencies_s)
    idx = min(len(ordered) - 1, max(0, int(0.99 * len(ordered))))
    return round(ordered[idx] * 1e3, 3)


def run_load(base_url: str, seed: int, n: int, workers: int = 2,
             timeout_s: float = 10.0,
             mempool_probe=None) -> dict:
    """Drives the seeded schedule through ``workers`` concurrent
    submitters and returns the accounting report. ``mempool_probe``
    (optional callable -> int) is sampled after every response for the
    high-water depth."""
    schedule = requests_for_seed(seed, n)
    work: queue.Queue = queue.Queue()
    for req in schedule:
        work.put(req)
    results: list[dict] = []
    results_lock = threading.Lock()
    depth_max = [0]

    def _worker():
        while True:
            try:
                req = work.get_nowait()
            except queue.Empty:
                return
            res = _post_submit(base_url, req, timeout_s)
            res["fee"] = req["fee"]
            res["payload"] = req["payload"]
            with results_lock:
                results.append(res)
                if mempool_probe is not None:
                    depth_max[0] = max(depth_max[0], int(mempool_probe()))

    t0 = time.monotonic()
    threads = [threading.Thread(target=_worker,
                                name=f"loadgen-{i}", daemon=True)
               for i in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s * max(1, n))
    wall_s = max(time.monotonic() - t0, 1e-9)

    by_outcome: dict[str, int] = {}
    shed_reasons: dict[str, int] = {}
    latencies = []
    accepted_txids = []
    for res in results:
        by_outcome[res["outcome"]] = by_outcome.get(res["outcome"], 0) + 1
        latencies.append(res["latency_s"])
        if res["outcome"] == "shed":
            r = res["shed_reason"]
            shed_reasons[r] = shed_reasons.get(r, 0) + 1
        if res["outcome"] in ("accepted", "duplicate") and res.get("txid"):
            accepted_txids.append(res["txid"])
    shed = by_outcome.get("shed", 0)
    lost_payloads = sorted(r["payload"] for r in results
                           if r["outcome"] == "receipt_lost")
    return {
        "receipt_lost_payloads": lost_payloads,
        "requests": len(results),
        "wall_s": round(wall_s, 4),
        "requests_per_sec": round(len(results) / wall_s, 2),
        "p99_latency_ms": p99_ms(latencies),
        "max_latency_ms": round(max(latencies, default=0.0) * 1e3, 3),
        "by_outcome": by_outcome,
        "shed_reasons": shed_reasons,
        "shed_fraction": round(shed / max(1, len(results)), 4),
        "untyped_sheds": by_outcome.get("untyped", 0),
        "errors": by_outcome.get("error", 0),
        "receipt_lost": by_outcome.get("receipt_lost", 0),
        "accepted_txids": accepted_txids,
        "mempool_depth_max": depth_max[0],
        "seed": seed,
    }
