"""The process-global fault-injection arming point.

One armed ``FaultPlan`` at a time; every instrumented layer calls
``check(site)`` on each dispatch or I/O attempt. Unarmed, the check is one
attribute read. Armed, each site keeps a call counter (reset at arm time,
so runs replay) and a matching fault either

* raises here (``raise``: ``FaultInjected``; ``hang``: a real
  ``time.sleep(seconds)``, then ``FaultTimeout``), or
* is returned to the hook, which applies the site-specific damage
  (``corrupt`` / ``partial`` mean one thing to a search result and another
  to a checkpoint write).

Every fired fault is counted (``faults_injected_total{site,kind}``) and
emitted as a ``fault_injected`` event. This module imports only the
standard library and the port's telemetry, so ``core/build.py`` can hook
``native.load`` through it.
"""
from __future__ import annotations

import threading
import time

from . import FaultInjected, FaultPlanError, FaultTimeout
from .faultplan import FaultPlan, FaultSpec

_lock = threading.Lock()
_plan: FaultPlan | None = None
_counts: dict[str, int] = {}
_fired: dict[int, int] = {}   # fault index in plan -> times fired


def arm(plan: FaultPlan) -> None:
    """Arms ``plan`` process-wide and resets every site's call counter:
    arming is the reproducibility epoch."""
    global _plan
    with _lock:
        _plan = plan
        _counts.clear()
        _fired.clear()


def disarm(strict: bool = False) -> None:
    """Disarms. With ``strict=True`` and a strict plan, raises
    ``FaultPlanError`` if any fault never fired (the run ended without
    exercising the injected scenario)."""
    global _plan
    with _lock:
        plan, fired = _plan, dict(_fired)
        _plan = None
        _counts.clear()
        _fired.clear()
    if strict and plan is not None and plan.strict:
        unfired = [i for i in range(len(plan.faults)) if i not in fired]
        if unfired:
            specs = ", ".join(
                f"#{i} {plan.faults[i].site}/{plan.faults[i].kind}"
                f"@{plan.faults[i].call}" for i in unfired)
            raise FaultPlanError(
                f"fault plan not exhausted: fault(s) {specs} never fired "
                f"(the run ended before reaching their call index)")


def active() -> bool:
    return _plan is not None


def armed_plan() -> FaultPlan | None:
    return _plan


def call_counts() -> dict[str, int]:
    """Per-site call counters since arming."""
    with _lock:
        return dict(_counts)


def check(site: str, **ctx) -> FaultSpec | None:
    """The hook every instrumented layer calls once per attempt.

    Returns None (no plan, no match), raises (``raise`` / ``hang``), or
    returns the matching ``FaultSpec`` for the hook to apply (``corrupt`` /
    ``partial``). ``ctx`` lands in the ``fault_injected`` event.
    """
    plan = _plan
    if plan is None:
        return None
    with _lock:
        index = _counts.get(site, 0)
        _counts[site] = index + 1
        matched = plan.match_all(site, index)
        # Apply the first matching fault, but credit every overlapping
        # window as fired: strict exhaustion counts shadowed specs.
        for i, _ in matched:
            _fired[i] = _fired.get(i, 0) + 1
        fault = matched[0][1] if matched else None
    if fault is None:
        return None
    _record(site, fault, index, ctx)
    if fault.kind == "raise":
        raise FaultInjected(site, "raise", fault.message)
    if fault.kind == "hang":
        # A real sleep, not a mock: the heartbeat goes stale for
        # `seconds`, as a real wedge would leave it.
        time.sleep(fault.seconds)
        raise FaultTimeout(site, "hang",
                           fault.message or f"simulated hang at {site} "
                           f"exceeded its {fault.seconds}s watchdog")
    return fault


def _record(site: str, fault: FaultSpec, index: int, ctx: dict) -> None:
    from ..telemetry import counter
    from ..telemetry.events import emit_event

    counter("faults_injected_total",
            help="injected faults fired, by site and kind",
            site=site, kind=fault.kind).inc()
    emit_event({"event": "fault_injected", "site": site,
                "kind": fault.kind, "call": index, **ctx})
