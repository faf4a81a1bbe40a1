"""Live observability endpoint: /metrics, /healthz, /events over HTTP.

The port's copy of the reference's ``perfwatch/server.py``: a
``ThreadingHTTPServer`` on a daemon thread, standard library only, so a
long mine/sim/bench run can be scraped while it runs
(``--serve-metrics PORT`` or ``MPIBT_METRICS_PORT``).

* ``/metrics``: the default registry's Prometheus text, rendered per
  scrape.
* ``/healthz``: JSON liveness and a last-progress-age watchdog over the
  ``*_heartbeat`` gauges (``telemetry.heartbeat_snapshot``). Healthy
  while the freshest heartbeat is younger than the stall budget
  (``MPIBT_HEALTHZ_STALL`` seconds, default 30); ``starting`` while none
  was ever stamped and the budget has not elapsed since the server
  started; 503 otherwise. It carries the armed front door's stats under
  ``service`` (``{}`` without one).
* ``/events``: the event ring's records, redacted (values under
  path/argv/env-like keys masked, long strings truncated), each with its
  ``seq``; ``?n=`` tails the newest n (default 64), ``?since=SEQ``
  returns only newer records, and with a cursor an explicit ``n`` pages
  oldest-first.

``close()`` stops the accept loop and closes the socket; handler threads
are daemonic, so an in-flight scrape cannot hold the process open. The
CLI closes the server in the same ``finally`` that writes
``--metrics-dump``, so every exit path releases the port.
"""
from __future__ import annotations

import http.server
import json
import socket
import threading
import time
import urllib.parse

from ..telemetry import default_registry
from ..telemetry.events import env_number, recent_with_seq

# Default last-progress stall budget (seconds) before /healthz flips
# unhealthy. Generous: a big sweep can hold the host for a few seconds; a
# wedged device init holds it for minutes.
DEFAULT_STALL_S = env_number("MPIBT_HEALTHZ_STALL", 30.0, cast=float,
                             minimum=1e-3)

HEARTBEAT_SUFFIX = "_heartbeat"

# /events redaction: mask values whose key smells like host detail
# (paths, command lines, environment), truncate anything huge.
_REDACT_KEY_PARTS = ("path", "argv", "env", "cmd", "dir", "file", "cwd")
_MAX_VALUE_CHARS = 200


def redact_event(record: dict) -> dict:
    """One event record, safe for an operator-facing endpoint."""
    out: dict = {}
    for k, v in record.items():
        key = str(k).lower()
        if any(part in key for part in _REDACT_KEY_PARTS):
            out[k] = "[redacted]"
            continue
        if isinstance(v, str) and len(v) > _MAX_VALUE_CHARS:
            v = v[:_MAX_VALUE_CHARS] + "...[truncated]"
        out[k] = v
    return out


# Servers started in this process, newest last — the CLI announces the
# bound port from here and tests poll it to find an in-flight server.
_active: list["MetricsServer"] = []
_active_lock = threading.Lock()


def active_server() -> "MetricsServer | None":
    """The most recently started, still-open server in this process."""
    with _active_lock:
        return _active[-1] if _active else None


class MetricsServer:
    """The threaded endpoint. ``port=0`` binds an ephemeral port;
    ``start()`` returns the actual one.

    The lifecycle scaffolding (bind, daemon serve thread, idempotent
    close, ``_send`` hardening) is the one copy other endpoints build
    on: the front door's ``ServiceServer`` subclasses this with its own
    ``handler_cls`` and opts out of the active-server registry
    (``register_active``).
    """

    #: The request handler class; subclasses override with their own
    #: ``_Handler`` subclass to serve different routes.
    handler_cls: type["_Handler"]
    #: Whether start()/close() maintain the process-wide active-server
    #: list (the CLI announce / test-discovery mechanism).
    register_active = True

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 stall_s: float | None = None):
        self.host = host
        self.port = int(port)
        self.stall_s = float(stall_s if stall_s is not None
                             else DEFAULT_STALL_S)
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._started_at: float | None = None

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        outer = self

        class Handler(self.handler_cls):
            server_ctx = outer

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"{type(self).__name__}-{self.port}", daemon=True)
        self._thread.start()
        if self.register_active:
            with _active_lock:
                _active.append(self)
        return self.port

    def close(self) -> None:
        """Stop accepting, close the socket, leave no thread behind.
        Idempotent — every CLI exit path calls this."""
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        with _active_lock:
            if self in _active:
                _active.remove(self)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # ---- endpoint payloads ----------------------------------------------

    def registry(self):
        """The default registry, resolved per request: it can be reset
        under a live server, and scrapes follow the swap."""
        return default_registry()

    def health(self) -> tuple[int, dict]:
        """(http status, payload) for /healthz.

        Healthy while the freshest ``*_heartbeat`` gauge is younger than
        the stall budget; ``starting`` (still 200) while none has ever
        been stamped and the budget has not elapsed since server start;
        503 otherwise — with per-heartbeat detail so the stalled layer
        is named, not guessed.
        """
        from ..service import service_stats
        from ..telemetry import heartbeat_snapshot

        beats = heartbeat_snapshot(self.registry())
        ages = [b["age_s"] for b in beats.values()
                if b["age_s"] is not None]
        freshest = min(ages) if ages else None
        uptime = (time.monotonic() - self._started_at
                  if self._started_at is not None else 0.0)
        if freshest is not None and freshest <= self.stall_s:
            status, code = "ok", 200
        elif freshest is None and uptime <= self.stall_s:
            status, code = "starting", 200
        elif freshest is None:
            status, code = "no-progress", 503
        else:
            status, code = "stalled", 503
        return code, {
            "status": status,
            "healthy": code == 200,
            "stall_threshold_s": self.stall_s,
            "uptime_s": round(uptime, 3),
            "last_progress_age_s": (None if freshest is None
                                    else round(freshest, 3)),
            "heartbeats": beats,
            # Additive: the armed blockserve door's mempool depth, shed
            # totals and accept-gate state ({} while no service runs).
            "service": service_stats(),
        }

    def events_tail(self, n: int | None,
                    since: int | None = None) -> list[dict]:
        """Redacted ring records, each stamped with its cursor seq."""
        return [{**redact_event(r), "seq": s}
                for s, r in recent_with_seq(n=n, since=since)]


class _Handler(http.server.BaseHTTPRequestHandler):
    server_ctx: MetricsServer  # bound by MetricsServer.start

    # Scrapes must not spam the run's stderr.
    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        pass

    def _send(self, code: int, body: str, content_type: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-reply; nothing to salvage

    def do_GET(self) -> None:  # noqa: N802 (stdlib signature)
        parsed = urllib.parse.urlparse(self.path)
        ctx = self.server_ctx
        if parsed.path == "/metrics":
            self._send(200, ctx.registry().render_prometheus(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif parsed.path == "/healthz":
            code, payload = ctx.health()
            self._send(code, json.dumps(payload, sort_keys=True) + "\n",
                       "application/json")
        elif parsed.path == "/events":
            q = urllib.parse.parse_qs(parsed.query)
            since = None
            if "since" in q:
                try:
                    since = max(0, int(q["since"][0]))
                except ValueError:
                    since = None
            # With a cursor, the default is "everything newer" (the
            # whole point of since is not losing records to a tail
            # bound); an explicit n pages oldest-first (lossless —
            # recent_with_seq documents why).
            n: int | None = None if since is not None else 64
            if "n" in q:
                try:
                    n = max(1, int(q["n"][0]))
                except ValueError:
                    pass
            body = "\n".join(json.dumps(r, sort_keys=True, default=str)
                             for r in ctx.events_tail(n, since=since))
            self._send(200, body + ("\n" if body else ""),
                       "application/json")
        else:
            self._send(404, json.dumps({
                "error": f"unknown path {parsed.path!r}",
                "endpoints": ["/metrics", "/healthz", "/events"]}) + "\n",
                "application/json")


# Defined after _Handler exists; subclass servers override this.
MetricsServer.handler_cls = _Handler


def wait_listening(host: str, port: int, timeout_s: float = 5.0) -> bool:
    """Polls until a TCP connect succeeds (test/smoke helper)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((host, port), timeout=0.2):
                return True
        except OSError:
            time.sleep(0.02)
    return False
