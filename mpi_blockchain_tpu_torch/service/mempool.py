"""Bounded fee-ordered mempool: two lazy heaps + a txid index.

The port's copy of the reference's ``service/mempool.py``; the txid
is the port's C++ core's double SHA-256 of the payload.

The admission contract is the whole design:

* **bounded** — at most ``cap`` (``MPIBT_MEMPOOL_CAP``, default 512)
  PENDING transactions ever exist. A submit against a full pool either
  displaces the cheapest pending tx (strictly lower fee than the
  newcomer — the eviction is itself an ordered, observable outcome:
  status ``evicted``, counted) or is shed with the typed reason
  ``mempool_full``. Never an unbounded queue.
* **fee-ordered** — template building drains by ``(-fee, seq)``: highest
  fee first, admission order breaking ties, so two same-seed load runs
  produce the same template sequence (no wall-clock in the order key).
* **status-queryable** — every admitted txid stays answerable through
  ``status()`` after it resolves (included / evicted / expired), in a
  bounded resolved ring (``4*cap`` + change), so "accepted then lost"
  is structurally impossible to hide: the serve smoke queries every
  accepted txid back.

Deadlines are enforced here, at ``take()`` — the only gate between the
pool and the miner — so expired work is dropped BEFORE it reaches a
template, never clawed back after (a tx already embedded in a dispatched
template stays mined; ``mark_included`` then records the truth even if
the deadline lapsed while the block was in flight).

Locking: one mutex, short critical sections, no I/O under it; heap
entries are lazily invalidated by status so eviction and expiry never
rebuild a heap.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time

from ..core import sha256d
from ..telemetry import counter
from ..telemetry.events import env_number

#: Pending-capacity knob; 0 is legal (every submit sheds — the
#: admission-control test fixture).
ENV_CAP = "MPIBT_MEMPOOL_CAP"
DEFAULT_CAP = 512

PENDING = "pending"
INCLUDED = "included"
EVICTED = "evicted"
EXPIRED = "expired"


def txid_of(payload: bytes) -> str:
    """Transaction identity = double-SHA256 of the raw payload bytes —
    the same digest discipline as the chain itself."""
    return sha256d(payload).hex()


@dataclasses.dataclass
class TxRecord:
    """One transaction's life in the pool. ``payload`` stays server-side;
    ``public()`` is the wire shape every endpoint returns."""
    txid: str
    payload: bytes
    fee: int
    seq: int
    submitted_at: float
    deadline_at: float | None
    status: str = PENDING
    height: int | None = None    # set on inclusion
    reason: str | None = None    # eviction/expiry detail

    def public(self) -> dict:
        out = {"txid": self.txid, "fee": self.fee,
               "size": len(self.payload), "status": self.status}
        if self.height is not None:
            out["height"] = self.height
        if self.reason is not None:
            out["reason"] = self.reason
        return out


class Mempool:
    """The bounded fee-ordered pool. All methods are thread-safe."""

    def __init__(self, cap: int | None = None,
                 clock=time.monotonic):
        self.cap = int(cap if cap is not None
                       else env_number(ENV_CAP, DEFAULT_CAP, cast=int,
                                       minimum=0))
        self._clock = clock
        self._lock = threading.Lock()
        self._index: dict[str, TxRecord] = {}
        self._take_heap: list = []   # (-fee, seq, txid): template order
        self._evict_heap: list = []  # (fee, seq, txid): cheapest first
        self._resolved: list[str] = []   # FIFO forget ring
        self._seq = 0
        self._pending = 0
        self.submitted_total = 0
        self.included_total = 0
        self.evicted_total = 0
        self.expired_total = 0
        self.depth_max = 0

    # ---- admission -------------------------------------------------------

    def submit(self, payload: bytes, fee: int,
               deadline_s: float | None = None,
               now: float | None = None) -> tuple[str, TxRecord | None]:
        """Admission decision: ``("accepted", rec)``,
        ``("duplicate", rec)`` (same txid already known — idempotent,
        not double-counted), or ``("shed", None)`` when the pool is full
        and the newcomer's fee does not beat the cheapest pending tx."""
        now = self._clock() if now is None else now
        tid = txid_of(payload)
        with self._lock:
            known = self._index.get(tid)
            if known is not None:
                return "duplicate", known
            if self._pending >= self.cap:
                victim = self._cheapest_locked()
                if victim is None or victim.fee >= fee:
                    counter("service_mempool_shed_total").inc()
                    return "shed", None
                self._resolve_locked(victim, EVICTED,
                                     reason="displaced by higher fee")
                self.evicted_total += 1
                counter("service_mempool_evicted_total").inc()
            rec = TxRecord(
                txid=tid, payload=bytes(payload), fee=int(fee),
                seq=self._seq, submitted_at=now,
                deadline_at=(None if deadline_s is None
                             else now + float(deadline_s)))
            self._seq += 1
            self._index[tid] = rec
            heapq.heappush(self._take_heap, (-rec.fee, rec.seq, tid))
            heapq.heappush(self._evict_heap, (rec.fee, rec.seq, tid))
            self._pending += 1
            self.submitted_total += 1
            self.depth_max = max(self.depth_max, self._pending)
            counter("service_mempool_admitted_total").inc()
            return "accepted", rec

    # ---- template drain --------------------------------------------------

    def take(self, limit: int, now: float | None = None) -> list[TxRecord]:
        """Up to ``limit`` pending txs in fee order for the NEXT
        template. Expired work is dropped here — before it can reach
        the miner — and never after: takes do not change status, so a
        tx rides every rebuilt template until included or expired."""
        now = self._clock() if now is None else now
        with self._lock:
            picked: list[TxRecord] = []
            requeue: list = []
            while self._take_heap and len(picked) < limit:
                entry = heapq.heappop(self._take_heap)
                rec = self._index.get(entry[2])
                if rec is None or rec.status != PENDING:
                    continue         # lazily invalidated heap entry
                if rec.deadline_at is not None and now >= rec.deadline_at:
                    self._resolve_locked(rec, EXPIRED, reason="deadline")
                    self.expired_total += 1
                    counter("service_deadline_expired_total").inc()
                    continue
                picked.append(rec)
                requeue.append(entry)
            for entry in requeue:    # still pending: future takes see them
                heapq.heappush(self._take_heap, entry)
            return picked

    def mark_included(self, txids, height: int) -> int:
        """Records the chain's truth after a block lands: every listed
        pending (or even already-expired — the chain wins) tx becomes
        ``included`` at ``height``."""
        n = 0
        with self._lock:
            for tid in txids:
                rec = self._index.get(tid)
                if rec is None or rec.status == INCLUDED:
                    continue
                if rec.status == PENDING:
                    self._pending -= 1
                    self._forget_locked(tid)
                rec.status, rec.height, rec.reason = INCLUDED, height, None
                self.included_total += 1
                n += 1
            if n:
                counter("service_mempool_included_total").inc(n)
        return n

    # ---- queries ---------------------------------------------------------

    def status(self, txid: str) -> TxRecord | None:
        with self._lock:
            return self._index.get(txid)

    def depth(self) -> int:
        with self._lock:
            return self._pending

    def snapshot(self) -> dict:
        """The bounded observability view (healthz / shards / incident
        bundles): depth + lifetime totals + the pending fee range."""
        with self._lock:
            fees = [r.fee for r in self._index.values()
                    if r.status == PENDING]
            return {
                "depth": self._pending,
                "cap": self.cap,
                "depth_max": self.depth_max,
                "submitted_total": self.submitted_total,
                "included_total": self.included_total,
                "evicted_total": self.evicted_total,
                "expired_total": self.expired_total,
                "fee_min": min(fees) if fees else None,
                "fee_max": max(fees) if fees else None,
            }

    # ---- internals (lock held) -------------------------------------------

    def _cheapest_locked(self) -> TxRecord | None:
        while self._evict_heap:
            fee, seq, tid = self._evict_heap[0]
            rec = self._index.get(tid)
            if rec is not None and rec.status == PENDING:
                return rec
            heapq.heappop(self._evict_heap)
        return None

    def _resolve_locked(self, rec: TxRecord, status: str,
                        reason: str) -> None:
        rec.status, rec.reason = status, reason
        self._pending -= 1
        self._forget_locked(rec.txid)

    def _forget_locked(self, txid: str) -> None:
        """Resolved records stay queryable in a bounded FIFO ring; the
        oldest fall out once the ring outgrows 4*cap (+ a floor so a
        cap-0 pool still answers recent statuses)."""
        self._resolved.append(txid)
        keep = max(4 * self.cap, 64)
        while len(self._resolved) > keep:
            old = self._resolved.pop(0)
            rec = self._index.get(old)
            if rec is not None and rec.status != PENDING:
                self._index.pop(old, None)
