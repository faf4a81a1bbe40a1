"""ResilientBackend: retry-wrapped dispatch and the step-down ladder.

A run whose device dispatch keeps failing steps down a ladder of rungs
that all keep the same lowest-nonce contract, so a degraded chain is
byte-identical to the one the failed rung would have mined:

    cuda:<kernel>  ->  cuda:torch  ->  cpu

``cuda:cuda`` is the hand-written sweep kernel, ``cuda:torch`` its plain
PyTorch version on the same device (about 16 s per 2^24 nonces on an H100,
so a d24 run there crawls), ``cpu`` the C++ sweep. Each step-down is loud:
a ``backend_degraded`` event, the ``backend_degradations_total`` counter,
the ``backend_degraded`` gauge, and in the CLI ``"degraded": true`` and a
warning on stderr.

Trust boundary: a backend result is never taken on faith. Every returned
winner is re-validated on the host (its double SHA-256 recomputed, held
against the difficulty and the reported digest), so a corrupt result
surfaces as a retryable ``CorruptResult`` instead of reaching the C++
node.

What never steps down: ``ConfigError`` (a misconfiguration) and
``KernelError`` (a hand-written kernel that failed to build or launch, or
a CUDA error at its read-back). Both propagate at once, with no retry, so
a missing ``nvcc`` or a faulting kernel fails the run (CLI rc 2) instead
of becoming a quiet run on a slower rung. A rung that runs a hand-written
kernel (``MinerBackend.hand_written_kernel``) steps down only for a fault
that a plan injected: any other failure that outlasts its retries, such
as a winner that fails re-validation with no fault behind it, is the
kernel's and raises ``KernelError``. The rungs below step down on what the
reference steps down on: injected faults, winners that fail re-validation
and other failures that retries do not heal.
"""
from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
from typing import Callable

from .. import core
from ..backend import FaultedResult, MinerBackend, SearchResult
from ..config import ConfigError, KernelError
from ..telemetry import counter, gauge
from ..telemetry.events import emit_event
from . import FaultInjected, RetryExhausted
from .policy import RetryPolicy, call_with_retry, policy_for


class CorruptResult(RuntimeError):
    """A backend returned a winner that fails host-side re-validation.
    ``injected`` is true when a fault plan damaged the result."""

    def __init__(self, message: str, injected: bool = False):
        super().__init__(message)
        self.injected = injected


def _injected(error: BaseException | None) -> bool:
    """Whether a failure is one a fault plan caused."""
    return isinstance(error, FaultInjected) or \
        (isinstance(error, CorruptResult) and error.injected)


Rung = tuple[str, Callable[[], MinerBackend]]

#: Sleep between two polls of a dispatch's completion while a deadline
#: bounds the wait; None polls again at once, with no sleep. On the card
#: the blocking read-back spins in the driver, and a poll that sleeps
#: between queries cost host time a block: 1.1 ms more in sleeps of 20 us,
#: 0.55 ms more with ``time.sleep(0)`` (``tools/dispatch_variants.py``;
#: PERF.md). So the shipped poll spins, as the read-back does.
POLL_S: float | None = None


def _wait_ready(finish, deadline: float | None) -> None:
    """Waits, until ``deadline`` (``time.monotonic()``), for the work in
    flight behind a started search: a finish that carries ``wait`` (the
    C++ sweep on its backend's search thread) is waited on; one that
    carries only ``ready`` (a sweep on the card) is polled; one that
    carries neither (the plain version) has nothing in flight. Raises
    ``concurrent.futures.TimeoutError`` when the deadline passes first;
    with no deadline, the finish's own read-back waits."""
    ready = getattr(finish, "ready", None)
    if ready is None or deadline is None:
        return
    wait = getattr(finish, "wait", None)
    if wait is not None:
        if not wait(max(0.0, deadline - time.monotonic())):
            raise concurrent.futures.TimeoutError(
                "the dispatch's search did not complete in time")
        return
    while not _query(ready):
        if time.monotonic() >= deadline:
            raise concurrent.futures.TimeoutError(
                "the dispatch's device work did not complete in time")
        if POLL_S is not None:
            # Off unless a measurement sets it (tools/dispatch_variants.py);
            # the wait it paces is bounded by the consume's deadline.
            time.sleep(POLL_S)  # chainlint: disable=HOT001


def _query(ready) -> bool:
    try:
        return ready()
    except Exception:
        # A failed query: the finish's read-back reports the failure.
        return True


def ladder_from_config(config, group=None,
                       cpu_ranks: int | None = None) -> list[Rung]:
    """The step-down ladder a MinerConfig implies, top rung first:
    ``cuda:<kernel>`` (the kernel ``config.kernel`` resolves to on the
    device) → ``cuda:torch`` → ``cpu``. ``cuda:torch`` is left out when the
    kernel already resolves to ``torch``; a cpu config has the single
    ``cpu`` rung (retry only). Factories are lazy: a lower rung is built
    only when the ladder steps down onto it. The device is resolved here,
    once, to an explicit ``cuda:<index>`` (or raises ``ConfigError`` with
    no card), so every rung uses the same one whatever thread builds it.

    The cuda rungs split each round over ``config.n_miners`` miners, in
    ``group`` when one is given; the ``cpu`` rung runs that many C++ ranks
    in this process, as the reference's does, or ``cpu_ranks`` when given
    (``SimNode`` runs each group as one rank). In a world of processes a
    retry or a step-down on one rank is not seen by the others, so the
    ranks' collectives can fall out of step; the reference has the same
    exposure. The elastic mesh (``mine --elastic``) runs its ranks as
    processes with no collective between them, and, like the
    reference's, does not make a gloo world elastic."""
    from ..backend import get_backend

    n_ranks = config.n_miners if cpu_ranks is None else cpu_ranks

    def cpu_factory():
        return get_backend("cpu", n_ranks=n_ranks,
                           batch_size=config.batch_size)

    if config.backend == "cpu":
        return [("cpu", cpu_factory)]

    from ..backend.cuda import resolve_device
    from ..ops import resolve_kernel

    device = resolve_device(config.device)
    kernel = resolve_kernel(config.kernel, device)

    def cuda_factory(kernel):
        return lambda: get_backend("cuda",
                                   batch_pow2=config.effective_batch_pow2,
                                   kernel=kernel, device=device,
                                   n_miners=config.n_miners, group=group)

    rungs: list[Rung] = [(f"cuda:{kernel}", cuda_factory(kernel))]
    if kernel != "torch":
        rungs.append(("cuda:torch", cuda_factory("torch")))
    rungs.append(("cpu", cpu_factory))
    return rungs


class ResilientBackend(MinerBackend):
    """Wraps a ladder of backends behind the MinerBackend contract.

    The top rung is built eagerly, so its construction errors
    (``ConfigError``, ``KernelError`` from a kernel that does not build)
    surface where the raw backend's did. ``name`` and ``active_backend``
    reflect the active rung, so summaries report what actually mined.
    """

    def __init__(self, rungs: list[Rung],
                 policy: RetryPolicy | None = None, seed: int = 0):
        if not rungs:
            raise ConfigError("step-down ladder needs at least one rung")
        self._rungs = list(rungs)
        self._i = 0
        self._backend = rungs[0][1]()
        self._policy = policy
        self._seed = seed
        self.degradations: list[dict] = []
        # Single flight: every launch and every resolve runs under this
        # lock, so the ladder state (_i, _backend) is stepped by one search
        # at a time: a speculative dispatch that exhausts its rung steps
        # down exactly once, and the next search runs on the surviving
        # rung.
        self._lock = threading.RLock()
        self._pending: collections.deque[_Dispatch] = collections.deque()

    @property
    def name(self) -> str:          # type: ignore[override]
        return self._backend.name

    @property
    def rung(self) -> str:
        return self._rungs[self._i][0]

    @property
    def degraded(self) -> bool:
        return self._i > 0

    @property
    def active_backend(self) -> MinerBackend:
        return self._backend

    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0,
               max_count: int = 1 << 32) -> SearchResult:
        args = (header80, difficulty_bits, start_nonce, max_count)
        with self._lock:
            return self._resolve(None, args)

    def search_async(self, header80: bytes, difficulty_bits: int,
                     start_nonce: int = 0,
                     max_count: int = 1 << 32
                     ) -> "concurrent.futures.Future":
        """Starts the search on the active rung (``launch``: with the CUDA
        kernel the sweep is on the device when this returns, on the C++
        rung on the backend's search thread) and returns a future that the
        thread asking for its result finishes: the read-back,
        re-validation, retries and step-down.

        Dispatches finish in issue order (asking for a later one finishes
        the earlier ones first) and under the one lock, so a dispatch
        retries or steps down to the end before the next one resolves,
        every later dispatch inherits the rung it landed on, and one
        started on a rung since stepped down from is searched again on the
        new one. No worker thread around the rung: the caller validates
        and appends on the host while the search runs, and nothing but
        the read-back sits between a winner and the next launch. The
        reference hands the whole search to a worker thread; on the card
        that form, and one that only read back on a worker, cost more in
        thread handoffs and contention for the interpreter lock than the
        overlap gained (PERF.md, chip_smoke phase 6 a)."""
        args = (header80, difficulty_bits, start_nonce, max_count)
        with self._lock:
            while self._pending and self._pending[0].cancelled():
                self._pending.popleft()
            dispatch = _Dispatch(self, self._launch(args), args)
            self._pending.append(dispatch)
            return dispatch

    def _finish_through(self, dispatch: "_Dispatch",
                        timeout: float | None = None) -> None:
        """Finishes pending dispatches in issue order until ``dispatch``
        is done (cancelled ones are dropped). With a ``timeout``, a
        dispatch whose sweep is still on the card when it runs out stays
        pending and ``concurrent.futures.TimeoutError`` is raised; the
        read-back, re-validation and retries of a completed sweep are not
        bounded. The wait for the head's work to complete runs outside
        the lock, so an issue or a search on another thread does not queue
        behind a sweep on the card; the head is then resolved under the
        lock, unless another thread finished it meanwhile."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if dispatch.done() or not self._pending:
                    return
                head = self._pending[0]
                in_flight = not head.cancelled() and \
                    head.launched[0] == self._i
            if in_flight:
                _wait_ready(head.launched[1], deadline)
            with self._lock:
                if not self._pending or self._pending[0] is not head:
                    continue
                self._pending.popleft()
                if not head.set_running_or_notify_cancel():
                    continue
                try:
                    head.set_result(self._resolve(head.launched, head.args,
                                                  head))
                except Exception as e:   # delivered through the future
                    head.set_exception(e)

    def _launch(self, args: tuple) -> tuple:
        """Starts a search on the active rung: (rung index, the function
        that finishes it, or the exception that starting raised, which
        counts as the first attempt's failure)."""
        try:
            return self._i, self._backend.launch(*args), None
        except Exception as e:
            return self._i, None, e

    def _resolve(self, launched: tuple, args: tuple,
                 dispatch: "_Dispatch | None" = None) -> SearchResult:
        """Finishes a started search under the retry budget of its rung,
        stepping down when the budget runs out. The started attempt is the
        first; a retry, or a search started on a rung since stepped down
        from, runs in full on the active rung. A ``dispatch`` whose result
        is the started attempt's is marked ``from_launch``."""
        with self._lock:
            while True:
                label = self.rung

                def attempt() -> SearchResult:
                    nonlocal launched
                    started, launched = launched, None
                    if started is not None and started[0] == self._i:
                        _, finish, error = started
                        if error is not None:
                            raise error
                        res = self._checked(args, finish())
                        if dispatch is not None:
                            dispatch.from_launch = True
                        return res
                    return self._checked(args, self._backend.search(*args))

                try:
                    return call_with_retry(
                        attempt, site=f"dispatch.{label}",
                        policy=(self._policy if self._policy is not None
                                else policy_for("dispatch",
                                                seed=self._seed)))
                except RetryExhausted as e:
                    if self._backend.hand_written_kernel and \
                            not _injected(e.last):
                        raise KernelError(
                            f"{label}: the kernel's search failed with no "
                            f"injected fault behind it, so the run does not "
                            f"step down: {e}") from e
                    if not self._step_down(e):
                        raise

    def _checked(self, args: tuple, res: SearchResult) -> SearchResult:
        """Re-validates a returned winner on the host."""
        header80, difficulty_bits = args[0], args[1]
        if res.nonce is not None:
            digest = core.header_hash(core.set_nonce(header80, res.nonce))
            if core.leading_zero_bits(digest) < difficulty_bits or \
                    (res.hash is not None and res.hash != digest):
                counter("corrupt_results_total",
                        help="backend winners that failed host-side "
                             "re-validation", backend=self._backend.name
                        ).inc()
                raise CorruptResult(
                    f"{self.rung}: nonce {res.nonce} fails re-validation "
                    f"(difficulty {difficulty_bits})",
                    injected=isinstance(res, FaultedResult))
        return res

    def _step_down(self, err: RetryExhausted) -> bool:
        """Advances to the next constructible rung; False when the ladder
        is exhausted (the caller re-raises: CLI rc 2)."""
        while self._i + 1 < len(self._rungs):
            old = self.rung
            self._i += 1
            label, factory = self._rungs[self._i]
            try:
                self._backend = factory()
            except KernelError:
                raise
            except Exception as e:
                # A rung that cannot be built is skipped loudly; the
                # ladder keeps walking down.
                emit_event({"event": "backend_rung_unavailable",
                            "rung": label,
                            "error": f"{type(e).__name__}: {e}"})
                continue
            record = {"event": "backend_degraded", "from": old,
                      "to": label, "rung_index": self._i,
                      "error": str(err)}
            self.degradations.append(record)
            counter("backend_degradations_total",
                    help="ladder step-downs after exhausted retries").inc()
            gauge("backend_degraded",
                  help="active ladder rung index "
                       "(0 = requested backend)").set(self._i)
            emit_event(record)
            return True
        return False


class _Dispatch(concurrent.futures.Future):
    """A search started by ``ResilientBackend.search_async``. It completes
    when its result (or exception) is asked for, on the asking thread. The
    ``timeout`` of those calls bounds the wait for the sweep on the card
    (polled through the finish's ``ready``), so a wedged sweep raises
    ``TimeoutError`` instead of hanging the read-back. Cancelling it
    before then drops it (the started sweep runs out on the device
    unread). ``sweep`` is the started sweep on the card (the
    ``LaunchedSweep``, with its time there), or None; ``opened``, for a
    search in a world of processes on the card, when its first slice was
    launched, or None; ``from_launch`` says the result is the started
    search's, not a retry's."""

    def __init__(self, backend: ResilientBackend, launched: tuple,
                 args: tuple):
        super().__init__()
        self.backend, self.launched, self.args = backend, launched, args
        self.sweep = getattr(launched[1], "sweep", None)
        self.opened = getattr(launched[1], "opened", None)
        self.from_launch = False

    def result(self, timeout=None):
        self.backend._finish_through(self, timeout)
        return super().result(timeout)

    def exception(self, timeout=None):
        self.backend._finish_through(self, timeout)
        return super().exception(timeout)
