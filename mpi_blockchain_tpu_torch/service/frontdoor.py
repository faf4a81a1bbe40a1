"""The overload-safe template-service front door.

The port's copy of the reference's ``service/frontdoor.py``.

Three cooperating pieces, each independently testable:

* ``TemplateFeed`` — turns the mempool into per-height payload
  templates through the miner's ``payload_for`` seam. Rebuilds run
  OFF the mine loop (HTTP handler threads after an accepted submit,
  plus the block-mined hook) and swap the current template atomically;
  the pipelined driver's block-boundary re-validation
  (``Miner._speculation_valid``) then discards any speculation built on
  the stale template exactly like a re-stripe. An idle feed (no pending
  txs) reproduces ``config.payload`` byte-for-byte, so a serviceless
  mine and a quiet served mine build identical chains.
* ``ServiceState`` — the admission-control brain: queue-depth and
  miner-heartbeat gates, per-request deadlines
  (``MPIBT_SERVICE_DEADLINE``), the ``service.submit`` fault site under
  the service retry budget, typed shed accounting
  (``service_shed_total{reason}``), and the degradation stamp
  (``ResilientBackend`` step-downs, and open ``stale_rank`` incidents in
  the incident table, mark responses ``degraded`` while reads keep
  serving).
* ``ServiceServer`` — the HTTP skin: perfwatch's hardened
  ``MetricsServer`` lifecycle (daemon serve thread, idempotent close,
  ``_send`` that survives vanished clients) plus ``POST /submit`` and
  ``GET /tx_status`` / ``/chain`` / ``/template`` on top of the
  inherited ``/metrics`` / ``/healthz`` / ``/events``.

Every failure mode has a typed answer: sheds carry a ``shed_reason``,
injected hangs are bounded by ``FaultTimeout`` and the retry budget
(the door answers late, never never), and a lost receipt (``partial``
fault) is recoverable through ``tx_status`` — the serve smoke's
accepted-then-lost conservation check leans on exactly that.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.parse
import zlib

from ..perfwatch.server import MetricsServer, _Handler
from ..resilience import RetryExhausted, injection
from ..resilience.policy import call_with_retry
from ..telemetry import counter, default_registry, heartbeat_snapshot
from ..telemetry.events import emit_event, env_number
from .mempool import Mempool, txid_of

#: Per-request deadline budget (seconds): admission must finish inside
#: it or the work is dropped BEFORE it reaches the miner; each admitted
#: tx also carries it as the template-entry deadline.
ENV_DEADLINE = "MPIBT_SERVICE_DEADLINE"
DEFAULT_DEADLINE_S = 5.0
#: Miner-heartbeat age (seconds) past which the door answers 503: a
#: wedged miner must shed, not queue unboundedly.
ENV_STALL = "MPIBT_SERVICE_STALL"
DEFAULT_STALL_S = 30.0
#: Concurrent in-flight submit bound — the queue-depth breach of the
#: admission contract.
ENV_INFLIGHT = "MPIBT_SERVICE_MAX_INFLIGHT"
DEFAULT_INFLIGHT = 32
#: Most txs a single template embeds.
ENV_TEMPLATE_TXS = "MPIBT_TEMPLATE_TXS"
DEFAULT_TEMPLATE_TXS = 16

_MAX_BODY = 1 << 20   # submit bodies past 1 MiB shed typed, never read


def template_payload(config, height: int, txids) -> bytes:
    """The deterministic template encoding: the serviceless base
    payload, then the embedded txids in template order. With no txs it
    IS ``config.payload(height)`` — the byte-identity anchor the serve
    smoke's sequential-oracle comparison builds on."""
    base = f"{config.data_prefix}:{height}"
    if not txids:
        return base.encode()
    return "|".join((base, *txids)).encode()


def _checksum(txids) -> int:
    return zlib.crc32("|".join(txids).encode())


class TemplateFeed:
    """Mempool -> per-height payload templates, rebuilt off the mine
    loop and self-validated at every block boundary."""

    def __init__(self, mempool: Mempool, config, max_txs: int | None = None,
                 clock=time.monotonic):
        self.mempool = mempool
        self.config = config
        self.max_txs = int(max_txs if max_txs is not None
                           else env_number(ENV_TEMPLATE_TXS,
                                           DEFAULT_TEMPLATE_TXS,
                                           cast=int, minimum=1))
        self._clock = clock
        self._lock = threading.Lock()
        self._txids: tuple[str, ...] = ()
        self._check = _checksum(())
        self._prev: tuple[str, ...] = ()
        self._seq = 0
        self.rebuilds_total = 0
        self.rebuild_failures = 0
        self.corrupt_discards = 0
        #: height -> the payload the LAST boundary read returned — by
        #: construction the bytes the mined block embeds (the pipelined
        #: driver re-reads at every boundary and discards stale
        #: speculation), so the serve smoke can replay the exact chain
        #: through a sequential oracle.
        self.history: dict[int, bytes] = {}
        self._txids_at: dict[int, tuple[str, ...]] = {}

    # ---- rebuild (off the mine loop) -------------------------------------

    def rebuild(self) -> bool:
        """Builds a fresh template from the pool under the
        ``service.rebuild`` fault site + service retry budget. On
        budget exhaustion the PREVIOUS template keeps serving —
        degrade, never drop. Returns whether a fresh build landed."""
        def _build():
            fault = injection.check("service.rebuild")
            txs = self.mempool.take(self.max_txs, self._clock())
            txids = tuple(t.txid for t in txs)
            if fault is not None and fault.kind == "partial":
                # only a prefix of the eligible txs makes the template;
                # the rest stay pending — delayed, never lost.
                txids = txids[:len(txids) // 2]
            chk = _checksum(txids)
            if fault is not None and fault.kind == "corrupt":
                # damage the rebuilt template; the boundary
                # self-validation below discards it like a stale
                # speculation and reverts to the last good template.
                chk ^= 0x5A5A
            return txids, chk
        try:
            txids, chk = call_with_retry(_build, site="service.rebuild")
        except RetryExhausted:
            with self._lock:
                self.rebuild_failures += 1
            counter("service_rebuild_failed_total").inc()
            emit_event({"event": "template_rebuild_failed"})
            return False
        with self._lock:
            if (txids, chk) == (self._txids, self._check):
                return True   # unchanged: no seq bump, no restripe churn
            if self._check == _checksum(self._txids):
                self._prev = self._txids    # last KNOWN-GOOD template
            self._txids, self._check = txids, chk
            self._seq += 1
            self.rebuilds_total += 1
        counter("service_template_rebuilds_total").inc()
        return True

    # ---- the miner-facing seam (block boundary) --------------------------

    def payload_for(self, height: int) -> bytes:
        """Bound onto the miner as its ``payload_for`` hook. Validates
        the current template's checksum first — a corrupt rebuild is
        discarded HERE, at the block boundary, before any candidate
        embeds it."""
        damaged = False
        with self._lock:
            if self._check != _checksum(self._txids):
                self._txids = self._prev
                self._check = _checksum(self._prev)
                self._seq += 1
                self.corrupt_discards += 1
                damaged = True
            txids = self._txids
        if damaged:
            counter("service_template_corrupt_total").inc()
            emit_event({"event": "template_corrupt_discarded",
                        "height": height})
        data = template_payload(self.config, height, txids)
        with self._lock:
            self.history[height] = data
            self._txids_at[height] = txids
            if len(self.history) > 256:    # bounded replay window
                drop = min(self.history)
                self.history.pop(drop, None)
                self._txids_at.pop(drop, None)
        return data

    def note_block(self, height: int) -> None:
        """The block-mined hook: record inclusion truth for the txs the
        landed block embeds, then rebuild so the NEXT template drops
        them (the rebuild is what turns any in-flight speculation into
        a restripe discard at its boundary)."""
        with self._lock:
            txids = self._txids_at.get(height, ())
        if txids:
            self.mempool.mark_included(txids, height)
        self.rebuild()

    def current(self) -> tuple[tuple[str, ...], int]:
        with self._lock:
            return self._txids, self._seq

    def stats(self) -> dict:
        with self._lock:
            return {"seq": self._seq, "txs": len(self._txids),
                    "rebuilds": self.rebuilds_total,
                    "failures": self.rebuild_failures,
                    "corrupt_discards": self.corrupt_discards}


class ServiceState:
    """Admission control + typed shedding + degradation stamping over
    one miner. Binds/unbinds the miner's template seam explicitly."""

    def __init__(self, miner, mempool: Mempool | None = None,
                 feed: TemplateFeed | None = None, *,
                 deadline_s: float | None = None,
                 stall_s: float | None = None,
                 max_inflight: int | None = None,
                 clock=time.monotonic):
        self.miner = miner
        self.mempool = mempool if mempool is not None else Mempool()
        self.feed = (feed if feed is not None
                     else TemplateFeed(self.mempool, miner.config))
        self.deadline_s = float(
            deadline_s if deadline_s is not None
            else env_number(ENV_DEADLINE, DEFAULT_DEADLINE_S,
                            cast=float, minimum=0.001))
        self.stall_s = float(
            stall_s if stall_s is not None
            else env_number(ENV_STALL, DEFAULT_STALL_S,
                            cast=float, minimum=0.1))
        self.max_inflight = int(
            max_inflight if max_inflight is not None
            else env_number(ENV_INFLIGHT, DEFAULT_INFLIGHT,
                            cast=int, minimum=0))
        self._clock = clock
        self._started_at = clock()
        self._lock = threading.Lock()
        self._inflight = 0
        self.shed_totals: dict[str, int] = {}
        self._bound = False

    # ---- miner binding ---------------------------------------------------

    def bind(self) -> None:
        """Routes the miner's template seam through the feed and hooks
        block-mined for inclusion marking. Idempotent."""
        if self._bound:
            return
        miner = self.miner
        orig_block_mined = miner._block_mined

        def _block_mined(rec):
            orig_block_mined(rec)
            self.feed.note_block(rec.height)

        miner.payload_for = self.feed.payload_for
        miner._block_mined = _block_mined
        self.feed.rebuild()
        self._bound = True

    def unbind(self) -> None:
        if not self._bound:
            return
        self.miner.__dict__.pop("payload_for", None)
        self.miner.__dict__.pop("_block_mined", None)
        self._bound = False

    # ---- admission -------------------------------------------------------

    def accept_gate(self, now: float | None = None
                    ) -> tuple[bool, str | None]:
        """The backpressure coupling: the door only accepts while the
        miner demonstrably progresses. Heartbeat-age over the stall
        budget (or no heartbeat at all past the starting grace) flips
        the door to 503 ``miner_stalled``."""
        now = self._clock() if now is None else now
        beats = heartbeat_snapshot(default_registry())
        ages = [b["age_s"] for b in beats.values()
                if b.get("age_s") is not None]
        freshest = min(ages) if ages else None
        if freshest is None:
            uptime = now - self._started_at
            if uptime <= self.stall_s:
                return True, None     # starting grace
            return False, "miner_stalled"
        if freshest > self.stall_s:
            return False, "miner_stalled"
        return True, None

    def submit(self, payload: bytes, fee: int,
               deadline_s: float | None = None
               ) -> tuple[int, dict | None]:
        """One admission attempt: ``(http_code, body)``. ``body`` is
        ``None`` only for the ``partial`` fault kind — the tx IS
        admitted but its receipt is lost in flight; the client recovers
        through ``tx_status``."""
        t0 = self._clock()
        with self._lock:
            self._inflight += 1
            over = self._inflight > self.max_inflight
        try:
            if over:
                return self._shed(503, "queue_depth")
            ok, reason = self.accept_gate(t0)
            if not ok:
                return self._shed(503, reason)
            tid = txid_of(payload)
            try:
                fault = call_with_retry(
                    lambda: injection.check("service.submit", txid=tid),
                    site="service.submit")
            except RetryExhausted:
                # raise/hang kinds past the service retry budget: shed
                # typed — the request answers, the tx never entered.
                return self._shed(503, "retry_exhausted", txid=tid)
            if fault is not None and fault.kind == "corrupt":
                # integrity-damaged in flight: reject before the pool.
                return self._shed(400, "corrupt", txid=tid)
            budget = (self.deadline_s if deadline_s is None
                      else float(deadline_s))
            if self._clock() - t0 >= budget:
                # the request burned its deadline inside admission
                # (e.g. an injected hang): drop before the miner.
                return self._shed(503, "deadline", txid=tid)
            outcome, rec = self.mempool.submit(payload, fee,
                                               deadline_s=budget, now=t0)
            if outcome == "shed":
                return self._shed(429, "mempool_full", txid=tid)
            if outcome == "accepted":
                # the async rebuild: handler thread, never the miner's.
                self.feed.rebuild()
            body = dict(rec.public())
            body["result"] = outcome
            body["depth"] = self.mempool.depth()
            if fault is not None and fault.kind == "partial":
                return 200, None
            return 200, body
        finally:
            with self._lock:
                self._inflight -= 1

    def _shed(self, code: int, reason: str,
              txid: str | None = None) -> tuple[int, dict]:
        with self._lock:
            self.shed_totals[reason] = self.shed_totals.get(reason, 0) + 1
        counter("service_shed_total", reason=reason).inc()
        body = {"error": "shed", "shed_reason": reason,
                "retry_after_s": 0.05}
        if txid is not None:
            body["txid"] = txid
        return code, body

    # ---- reads (stay up while degraded) ----------------------------------

    def tx_status(self, txid: str) -> tuple[int, dict]:
        rec = self.mempool.status(txid)
        if rec is None:
            return 404, {"error": "unknown_txid", "txid": txid}
        return 200, rec.public()

    def chain_view(self, n: int = 16) -> dict:
        node = self.miner.node
        h = node.height
        lo = max(0, h - max(1, n) + 1)
        return {"height": h, "tip_hash": node.tip_hash.hex(),
                "blocks": [{"height": i,
                            "hash": node.block_hash(i).hex()}
                           for i in range(lo, h + 1)],
                **self.degraded_info()}

    def template_view(self) -> dict:
        txids, seq = self.feed.current()
        height = self.miner.node.height + 1
        data = template_payload(self.miner.config, height, txids)
        return {"height": height, "template_seq": seq,
                "tx_count": len(txids), "txids": list(txids),
                "payload_size": len(data), **self.degraded_info()}

    def degraded_info(self) -> dict:
        """The degradation stamp: a stepped-down ResilientBackend
        ladder or an open ``stale_rank`` incident (a rank evicted from
        the mesh) marks responses degraded; serving continues."""
        backend = getattr(self.miner, "backend", None)
        steps = list(getattr(backend, "degradations", None) or [])
        info: dict = {"degraded": bool(steps) or
                      bool(getattr(backend, "degraded", False))}
        if steps:
            info["degraded_to"] = steps[-1].get("to")
        from ..chainwatch.incident import open_incidents
        stale = [i for i in open_incidents()
                 if i.get("rule") == "stale_rank"]
        if stale:
            info["degraded"] = True
            info["stale_rank_incidents"] = len(stale)
        return info

    # ---- observability ---------------------------------------------------

    def stats(self) -> dict:
        """The additive ``service`` payload that /healthz carries."""
        ok, reason = self.accept_gate()
        with self._lock:
            shed = dict(self.shed_totals)
            inflight = self._inflight
        gate: dict = {"open": ok}
        if reason is not None:
            gate["reason"] = reason
        return {"mempool": self.mempool.snapshot(),
                "shed_total": shed,
                "accept_gate": gate,
                "inflight": inflight,
                "template": self.feed.stats(),
                "deadline_s": self.deadline_s,
                "degraded": self.degraded_info()["degraded"]}


class _ServiceHandler(_Handler):
    _GETS = ("/chain", "/events", "/healthz", "/metrics", "/template",
             "/tx_status")

    def do_GET(self) -> None:  # noqa: N802 (stdlib signature)
        parsed = urllib.parse.urlparse(self.path)
        state: ServiceState = self.server_ctx.state
        path = parsed.path
        if path == "/tx_status":
            q = urllib.parse.parse_qs(parsed.query)
            tid = (q.get("txid") or [""])[0]
            if not tid:
                self._json(400, {"error": "bad_request",
                                 "detail": "txid query param required"})
                return
            code, body = state.tx_status(tid)
            self._json(code, body)
        elif path == "/chain":
            q = urllib.parse.parse_qs(parsed.query)
            try:
                n = max(1, int((q.get("n") or ["16"])[0]))
            except ValueError:
                n = 16
            self._json(200, state.chain_view(n))
        elif path == "/template":
            self._json(200, state.template_view())
        elif path in ("/metrics", "/healthz", "/events"):
            super().do_GET()
        else:
            self._json(404, {"error": f"unknown path {path!r}",
                             "endpoints": list(self._GETS)})

    def do_POST(self) -> None:  # noqa: N802 (stdlib signature)
        parsed = urllib.parse.urlparse(self.path)
        state: ServiceState = self.server_ctx.state
        if parsed.path != "/submit":
            self._json(404, {"error": f"unknown path {parsed.path!r}",
                             "endpoints": ["/submit"]})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        if length > _MAX_BODY:
            code, body = state._shed(413, "body_too_large")
            self._json(code, body)
            return
        raw = self.rfile.read(length) if length else b""
        try:
            doc = json.loads(raw.decode() or "{}")
            payload = doc["payload"].encode()
            fee = int(doc["fee"])
        except (json.JSONDecodeError, UnicodeDecodeError, KeyError,
                TypeError, ValueError, AttributeError) as e:
            self._json(400, {"error": "bad_request",
                             "detail": f"{type(e).__name__}: {e}"})
            return
        deadline_s = doc.get("deadline_s")
        try:
            deadline_s = None if deadline_s is None else float(deadline_s)
        except (TypeError, ValueError):
            deadline_s = None
        code, body = state.submit(payload, fee, deadline_s)
        if body is None:
            # partial fault: the receipt is lost in flight — an empty
            # 200 the client must resolve through /tx_status.
            self._send(200, "", "application/json")
            return
        self._json(code, body)

    def _json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload, sort_keys=True) + "\n",
                   "application/json")


class ServiceServer(MetricsServer):
    """The HTTP front door; lifecycle inherited from MetricsServer."""

    handler_cls = _ServiceHandler
    register_active = False   # its own door, not the metrics announce

    def __init__(self, state: ServiceState, port: int = 0,
                 host: str = "127.0.0.1", stall_s: float | None = None):
        super().__init__(port=port, host=host, stall_s=stall_s)
        self.state = state

    def url(self, path: str = "/template") -> str:
        return super().url(path)
