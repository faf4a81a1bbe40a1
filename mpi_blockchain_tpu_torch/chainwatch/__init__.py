"""chainwatch: the live, in-process watchdog.

The port's copy of the reference's ``chainwatch``: streaming anomaly rules
(``rules.py``) evaluated on a cadence the run already pays for, and a
non-fatal incident path (``incident.py``) that signals, records and
bundles evidence while the run keeps mining. ``--incident-dir DIR`` (or
``MPIBT_INCIDENT_DIR``) on ``mine``, ``bench``, ``sim`` and ``serve`` arms
it with bundles written into DIR.

The two evaluation cadences (never a new thread on the hot path): the
per-block ``blocktrace.observe_block_metrics`` call of both miner drivers
and the fused miner's batch observe, throttled inside ``evaluate`` to at
most one full rule sweep per ``MPIBT_CHAINWATCH_INTERVAL`` seconds (the
overhead audit, ``blocktrace/overhead.py``, prices the same call); and the
meshwatch shard flusher's tick (``--mesh-obs``), off the mining thread,
which forces a full sweep. ``--mesh-obs`` alone arms the rules, without
bundles. ``python -m mpi_blockchain_tpu_torch.chainwatch smoke`` drives
both sides of the contract over a 4-rank world.

Under ``MPIBT_TELEMETRY_OFF`` (or uninstalled) ``evaluate`` is a flag
check and nothing else: no rule state, no events, no files.
"""
from __future__ import annotations

import threading
import time

from ..telemetry.events import env_number
from ..telemetry.registry import telemetry_disabled
from .incident import (BUNDLE_KEYS, build_bundle, bundle_dir,
                       close_incident, emit_incident, incident_count,
                       notify_mesh, open_incidents)
from .rules import SEVERITIES, Rule, default_rules

__all__ = [
    "BUNDLE_KEYS", "SEVERITIES", "Rule", "build_bundle", "bundle_dir",
    "close_incident", "default_rules", "emit_incident", "evaluate",
    "incident_count", "install", "installed", "notify_eviction",
    "notify_mesh", "open_incidents", "uninstall",
]

_lock = threading.Lock()
_armed = False
_rules: list[Rule] = []
_last_sweep = 0.0
_interval = 0.25


def install(incident_dir=None) -> list[Rule]:
    """Arm the watchdog: fresh rule instances + (optionally) an
    incident-bundle directory. Without a directory the rules still run
    and incidents still signal (event + counter + open table) — only
    the evidence bundles are skipped. Idempotent: re-install rebinds
    the directory and resets rule state."""
    from . import incident as _incident

    global _armed, _last_sweep, _interval
    with _lock:
        _rules.clear()
        _rules.extend(default_rules())
        _armed = True
        _last_sweep = 0.0
        # Read once, when armed (like the rules' own knobs): the
        # throttled path of every block is then two flag checks and a
        # clock read.
        _interval = env_number("MPIBT_CHAINWATCH_INTERVAL", 0.25,
                               cast=float, minimum=0)
    _incident.reset()
    _incident.configure(incident_dir)
    return list(_rules)


def uninstall() -> None:
    """Disarm and drop all state (test isolation / CLI teardown)."""
    from . import incident as _incident

    global _armed
    with _lock:
        _armed = False
        _rules.clear()
    _incident.reset()


def installed() -> bool:
    return _armed


def evaluate(height: int | None = None, source: str = "",
             force: bool = False) -> list[dict]:
    """One watchdog step: sample every rule, fire debounced incidents.
    ``MPIBT_CHAINWATCH_INTERVAL`` is read when the watchdog is armed.

    The two leading checks ARE the hot-path cost: disarmed or
    telemetry-off processes pay two reads and return. Armed, a
    monotonic-clock throttle bounds full sweeps to one per
    ``MPIBT_CHAINWATCH_INTERVAL`` seconds (``force=True`` — tests and
    the flush cadence — bypasses it). Returns the incidents fired by
    this step, empty almost always."""
    global _last_sweep
    if not _armed or telemetry_disabled():
        return []
    now = time.monotonic()
    if not force and now - _last_sweep < _interval:
        return []
    with _lock:
        if not _armed:
            return []
        _last_sweep = now
        rules = list(_rules)
    ctx = {"height": height, "source": source, "now": now}
    fired: list[dict] = []
    for rule in rules:
        was_open = rule.open
        try:
            detail = rule.evaluate(ctx)
        except Exception:
            # A broken detector must never hurt the run it watches (the
            # reference's one sanctioned swallow point).
            continue
        if detail is not None:
            heights = (height,) if height is not None else ()
            fired.append(emit_incident(rule=rule.name,
                                       severity=rule.severity,
                                       detail=detail, heights=heights,
                                       source=source))
        elif was_open and not rule.open:
            close_incident(rule.name)
    return fired


def notify_eviction(rank: int, reason: str, height: int = 0,
                    live=None) -> dict | None:
    """The eviction seam of the elastic mesh (``ElasticWorld.evict``):
    an eviction is a definitive membership loss, so it fires the
    ``stale_rank`` incident at once (no debounce wait on the next
    cadence) and records the surviving membership for bundles. No-op
    while disarmed or off."""
    if not _armed or telemetry_disabled():
        return None
    membership = {"live": list(live) if live is not None else [],
                  "evicted": [int(rank)], "reason": str(reason)}
    notify_mesh(membership)
    for rule in _rules:
        if rule.name == "stale_rank":
            if rule.open:
                return None     # episode already open: one incident
            rule.open = True
            rule.fired_total += 1
    return emit_incident(rule="stale_rank", severity="critical",
                         detail={"last_event": "mesh_shrunk",
                                 "rank": int(rank),
                                 "reason": str(reason)},
                         heights=(height,) if height else (),
                         source="eviction")
