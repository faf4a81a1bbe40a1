"""Retry, timeout and backoff policy: capped exponential backoff with
deterministic jitter, per-layer budgets, one loud give-up signal.

* **Deterministic.** Jitter derives from (site, attempt, seed) through
  crc32, so a replayed fault plan replays the recovery timeline too.
* **Budgeted per layer.** ``policy_for(site)`` carries the per-layer
  table; ``MPIBT_MAX_RETRIES`` caps the attempts of every site.
* **Selective.** ``ConfigError``, ``KernelError`` (a hand-written kernel
  that failed to build or launch) and KeyboardInterrupt/SystemExit are
  never retried: none of them heals with backoff, and retrying would bury
  the CLI's clean error.

The per-site table keeps the reference's entries for layers the port has
not ported yet (distributed init, the mesh rebuild, the front door), so
``policy_for`` gives the reference's budget for every site name.
``call_with_retry`` is the one place dispatch and checkpoint I/O
exceptions are caught and retried.
"""
from __future__ import annotations

import dataclasses
import struct
import time
import zlib

from ..config import ConfigError, KernelError
from . import RetryExhausted

#: Operator cap on attempts for every site (env; min 1 attempt).
_ENV_MAX_ATTEMPTS = "MPIBT_MAX_RETRIES"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic, seeded jitter."""
    max_attempts: int = 3        # total tries (first call included)
    base_backoff_s: float = 0.01
    max_backoff_s: float = 0.25
    seed: int = 0

    def backoff_s(self, site: str, attempt: int) -> float:
        """Sleep before retry #attempt (0-based): capped exponential,
        jittered into [cap/2, cap) by crc32(site, attempt, seed)."""
        cap = min(self.base_backoff_s * (2 ** attempt), self.max_backoff_s)
        key = site.encode() + struct.pack("<Ii", attempt, self.seed)
        frac = zlib.crc32(key) % 1024 / 1024.0
        return cap * (0.5 + 0.5 * frac)


#: Per-layer budgets, the reference's. Dispatch failures are cheap to retry
#: and cheap to step down from; checkpoint I/O retries cover transient file
#: system errors only (integrity failures are CheckpointError, a
#: ConfigError: never retried).
_PER_SITE: dict[str, RetryPolicy] = {
    "dispatch": RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                            max_backoff_s=0.25),
    "distributed.init": RetryPolicy(max_attempts=4, base_backoff_s=0.25,
                                    max_backoff_s=2.0),
    "checkpoint.write": RetryPolicy(max_attempts=2, base_backoff_s=0.02,
                                    max_backoff_s=0.1),
    "checkpoint.read": RetryPolicy(max_attempts=2, base_backoff_s=0.02,
                                   max_backoff_s=0.1),
    "mesh.rebuild": RetryPolicy(max_attempts=2, base_backoff_s=0.05,
                                max_backoff_s=0.5),
    "service": RetryPolicy(max_attempts=2, base_backoff_s=0.005,
                           max_backoff_s=0.02),
}
_DEFAULT = RetryPolicy()


def policy_for(site: str, seed: int = 0) -> RetryPolicy:
    """The per-layer budget for a site; dotted sites fall back to their
    layer prefix (``dispatch.cuda:cuda`` -> ``dispatch``)."""
    from ..telemetry.events import env_number

    base = _PER_SITE.get(site) or _PER_SITE.get(site.split(".", 1)[0],
                                                _DEFAULT)
    cap = env_number(_ENV_MAX_ATTEMPTS, None, cast=int, minimum=1)
    attempts = (base.max_attempts if cap is None
                else min(base.max_attempts, cap))
    if attempts == base.max_attempts and seed == base.seed:
        return base
    return dataclasses.replace(base, max_attempts=attempts, seed=seed)


NO_RETRY = (ConfigError, KernelError, KeyboardInterrupt, SystemExit)


def call_with_retry(fn, *, site: str, policy: RetryPolicy | None = None,
                    sleep=time.sleep):
    """Calls ``fn()`` under the site's retry budget.

    Transient failures sleep the deterministic backoff and retry; the
    final failure raises ``RetryExhausted`` (chaining the cause).
    ``NO_RETRY`` exceptions propagate at once.
    """
    from ..telemetry import counter
    from ..telemetry.events import emit_event

    policy = policy if policy is not None else policy_for(site)
    last: BaseException | None = None
    for attempt in range(max(1, policy.max_attempts)):
        try:
            return fn()
        except NO_RETRY:
            raise
        except Exception as e:
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            counter("retries_total",
                    help="policy-layer retries after a transient failure",
                    site=site).inc()
            emit_event({"event": "retry", "site": site,
                        "attempt": attempt + 1,
                        "of": policy.max_attempts,
                        "error": f"{type(e).__name__}: {e}"})
            sleep(policy.backoff_s(site, attempt))
    raise RetryExhausted(site, max(1, policy.max_attempts), last) from last
