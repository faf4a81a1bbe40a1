"""Crash flight recorder: dump telemetry state on abnormal exit.

The port's copy of the reference's ``telemetry/flight_recorder.py``. It
installs a ``sys.excepthook`` and, on an abnormal exit, writes one JSON
artifact holding

* the reason (a formatted traceback or the caller's message),
* the last N events of the JSON-lines ring,
* the per-node causal logs of every registered simulation network,
* a snapshot of the metrics registry and the tail of the span log,
* the process's context (argv, pid, wall time, extra key/values).

Three triggers:

1. **Uncaught exception.** The excepthook dumps, then chains to the
   previous hook (the traceback still prints).
2. **Declared abnormal exit.** A caller that handles its own failure (the
   sim CLI's non-convergence, the bench's device-init watchdog) calls
   ``dump_now(reason)``.
3. **Normal exit.** No artifact: the recorder is evidence on failure, not
   a second metrics exporter.

The reference also has an ``atexit`` hook that dumps the reason given to
its ``mark_abnormal``; nothing in the port declares an exit abnormal that
way (its two callers dump at once), so neither is copied.

``install(path)`` arms it; the ``mine``, ``sim`` and ``bench`` CLIs wire
that to ``--flight-recorder PATH`` (or env ``MPIBT_FLIGHT_RECORDER``).
``uninstall()`` disarms it and restores the previous excepthook.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import threading
import time
import traceback

DEFAULT_LAST_N = 256

#: Per-process ceiling on written artifacts (crash dumps + advisory
#: dump_now calls). A flapping watchdog or a crash during a dump must
#: converge to a bounded set of files, not fill the disk.
DUMP_CAP = 16

_lock = threading.Lock()
_state: dict = {
    "path": None,
    "last_n": DEFAULT_LAST_N,
    "installed": False,
    "prev_excepthook": None,
    "dump_count": 0,   # successful writes this install (cap accounting)
    "dumping": False,  # double-dump guard: a write is in flight
    "reasons": [],     # every dump reason so far, oldest first
    "networks": [],
    "context": {},
}


def install(path=None, last_n: int = DEFAULT_LAST_N) -> pathlib.Path:
    """Arm the recorder. ``path`` defaults to env ``MPIBT_FLIGHT_RECORDER``
    or ``flight_recorder_<pid>.json`` in the CWD. Idempotent (re-install
    just updates path/last_n)."""
    with _lock:
        _state["path"] = pathlib.Path(
            path or os.environ.get("MPIBT_FLIGHT_RECORDER")
            or f"flight_recorder_{os.getpid()}.json")
        _state["last_n"] = max(1, int(last_n))
        _state["dump_count"] = 0
        _state["reasons"] = []
        if not _state["installed"]:
            _state["installed"] = True
            _state["prev_excepthook"] = sys.excepthook
            sys.excepthook = _excepthook
        return _state["path"]


def uninstall() -> None:
    """Disarm (test isolation) and restore the previous excepthook."""
    with _lock:
        if _state["installed"] and _state["prev_excepthook"] is not None:
            sys.excepthook = _state["prev_excepthook"]
        _state.update(installed=False, prev_excepthook=None, path=None,
                      dump_count=0, dumping=False, reasons=[], networks=[],
                      context={})


def installed() -> bool:
    with _lock:
        return _state["installed"]


def register_network(net) -> None:
    """Attach a simulation network (anything with ``causal_logs()``) so
    its per-node causal logs land in the dump."""
    with _lock:
        if net not in _state["networks"]:
            _state["networks"].append(net)


def register_context(**kv) -> None:
    """Attach static context (config, seed, ...) to future dumps."""
    with _lock:
        _state["context"].update(kv)


def dump_now(reason: str) -> pathlib.Path | None:
    """Write the artifact immediately (no-op unless installed). Used by
    watchdogs that fire while the process is still alive — the artifact
    must exist BEFORE a parent kills us. A later crash dump OVERWRITES
    this one (carrying its reason in ``prior_reasons``): the
    most-specific failure wins, an early advisory dump never masks it."""
    return _dump(reason)


def snapshot(reason: str, tb: str | None = None,
             last_n: int | None = None) -> dict:
    """The evidence body: event-ring tail, causal logs, registry
    snapshot, span tail, process context; the crash path (``_dump``)
    writes exactly this dict. ``last_n`` defaults to the installed tail
    bound (or ``DEFAULT_LAST_N`` uninstalled)."""
    # Late imports: the recorder must be importable before telemetry is
    # fully initialized, and must never fail a crash path on an import.
    from .events import recent_events
    from .registry import default_registry

    with _lock:
        if last_n is None:
            last_n = _state["last_n"]
        networks = list(_state["networks"])
        context = dict(_state["context"])
    reg = default_registry()
    causal: dict = {}
    for i, net in enumerate(networks):
        # First network keeps flat node keys (the common case's stable
        # schema); later ones are prefixed so two registered sims can
        # never silently overwrite each other's logs.
        prefix = "" if i == 0 else f"net{i}:"
        try:
            for log in net.causal_logs():
                causal[f"{prefix}{log.node_id}"] = log.events()[-last_n:]
        except Exception as e:  # a half-built network must not mask the crash
            causal.setdefault("_error", str(e))
    return {
        "artifact": "flight_recorder",
        "reason": reason,
        "traceback": tb,
        "wall_time": time.time(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "context": context,
        "events": recent_events(last_n),
        "causal": causal,
        "metrics": reg.snapshot(),
        "spans": [s.to_dict() for s in reg.spans()[-last_n:]],
    }


def _dump(reason: str, tb: str | None = None) -> pathlib.Path | None:
    """Write the artifact, recording superseded reasons in
    ``prior_reasons`` so an advisory dump can never swallow a real crash.

    Two bounds keep a misbehaving trigger from writing unbounded
    artifacts: a concurrent dump already in flight skips (the
    double-dump guard), and after ``DUMP_CAP`` successful writes this
    process stops dumping entirely."""
    with _lock:
        if not _state["installed"]:
            return None
        if _state["dumping"]:
            return None
        if _state["dump_count"] >= DUMP_CAP:
            return None
        _state["dumping"] = True
        prior = list(_state["reasons"])
        path = _state["path"]
    try:
        payload = snapshot(reason, tb)
        payload["prior_reasons"] = prior
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(payload, sort_keys=True, default=str))
        tmp.replace(path)
    except Exception as e:
        # The recorder must never turn one failure into two, and a
        # failed write does not count against the cap.
        print(f"flight-recorder dump failed: {e}", file=sys.stderr)
        return None
    finally:
        with _lock:
            _state["dumping"] = False
    with _lock:
        _state["reasons"].append(reason)
        _state["dump_count"] += 1
    return path


def _excepthook(exc_type, exc, tb) -> None:
    _dump(f"uncaught {exc_type.__name__}: {exc}",
          tb="".join(traceback.format_exception(exc_type, exc, tb)))
    prev = _state["prev_excepthook"] or sys.__excepthook__
    prev(exc_type, exc, tb)

