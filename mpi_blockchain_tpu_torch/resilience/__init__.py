"""Resilience of the port: deterministic fault injection, retry and
step-down dispatch, and the exceptions they share.

The port's copy of the reference's ``resilience`` package:

* **faultplan** -- a seeded, byte-reproducible fault-plan spec
  (``FaultPlan``): which injection site, which call index, which fault
  kind (``raise`` / ``hang`` / ``corrupt`` / ``partial``). Armed with
  ``mine --fault-plan PATH|seed:N`` (or ``MPIBT_FAULT_PLAN``), so a failure
  replays exactly.
* **injection** -- the process-global arming point. Hooks in the CUDA and
  CPU backends, the native-library load (``core/build.py``) and checkpoint
  I/O (``utils/checkpoint.py``) call ``injection.check(site)``.
* **policy** -- capped exponential backoff with deterministic jitter,
  per-layer budgets, and ``RetryExhausted`` as the one loud give-up signal
  (CLI rc 2).
* **dispatch** -- ``ResilientBackend``: the ladder ``cuda:<kernel>`` →
  ``cuda:torch`` → ``cpu``. Every winner is re-validated on the host, a
  rung whose retries run out steps down loudly (event, counter, gauge,
  ``"degraded": true`` in the summary, a warning on stderr), and
  ``search_async`` puts the sweep on the card at once and finishes it when
  its result is asked for.

The one departure from the reference: a hand-written kernel that fails to
build or launch, or whose read-back reports a CUDA error, raises
``config.KernelError``, which, like ``ConfigError``, is never retried and
never stepped over; and a hand-written kernel's rung steps down only for
a fault that a plan injected (any other failure that outlasts its
retries raises ``KernelError``). The rungs below it step down as the
reference's do. Crash-safe checkpoints live in
``utils/checkpoint.py``; ``python -m mpi_blockchain_tpu_torch.resilience
smoke`` drives kill-and-resume and the step-down through the CLI.
Standard library only.
"""
from __future__ import annotations

from ..config import ConfigError


class FaultInjected(RuntimeError):
    """An injected fault fired (kind ``raise``, or site-specific damage
    that surfaces as an exception). Carries the site and kind."""

    def __init__(self, site: str, kind: str, message: str = ""):
        self.site = site
        self.kind = kind
        super().__init__(message or f"injected fault at {site} ({kind})")


class FaultTimeout(FaultInjected):
    """A simulated hang exceeded its watchdog budget (kind ``hang``)."""


class FaultPlanError(ConfigError):
    """Invalid or unexhausted fault plan (CLI rc 3): unparseable spec,
    unknown site or kind, or, under ``strict``, faults that never fired."""


class RetryExhausted(RuntimeError):
    """A policy-wrapped call failed on every attempt and every ladder rung
    below it (CLI rc 2). ``last`` keeps the final cause."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        self.site = site
        self.attempts = attempts
        self.last = last
        super().__init__(f"{site}: exhausted {attempts} attempt(s); "
                         f"last error: {type(last).__name__}: {last}")


from .faultplan import FaultPlan, FaultSpec  # noqa: E402,F401
from .policy import RetryPolicy, call_with_retry, policy_for  # noqa: E402,F401
