"""The miner_backend plugin boundary of the port.

Every backend implements the same deterministic contract: return the
LOWEST nonce in [start_nonce, start_nonce + count) whose double-SHA-256
header hash has >= difficulty_bits leading zero bits. Lowest-nonce, not
first-found, is what makes every backend mine identical chains.

``backend_from_config`` wraps the backend in the resilience layer's
``ResilientBackend`` (``resilience/dispatch.py``) unless asked for the raw
rung.
"""
from __future__ import annotations

import abc
import concurrent.futures
import dataclasses
import functools
from typing import Callable

from ..config import ConfigError


@dataclasses.dataclass(frozen=True)
class SearchResult:
    nonce: int | None        # lowest qualifying nonce, or None
    hash: bytes | None       # 32-byte sha256d digest of the winning header
    hashes_tried: int        # nonces evaluated, in the reference's accounting


def sync_search_future(search_fn, header80: bytes, difficulty_bits: int,
                       start_nonce: int = 0,
                       max_count: int = 1 << 32
                       ) -> "concurrent.futures.Future":
    """Runs ``search_fn`` inline and returns an already-completed future:
    the synchronous form of the ``search_async`` seam. Exceptions travel
    through the future, as a real dispatch's would."""
    f: concurrent.futures.Future = concurrent.futures.Future()
    try:
        f.set_result(search_fn(header80, difficulty_bits,
                               start_nonce=start_nonce,
                               max_count=max_count))
    except BaseException as e:   # delivered to the consumer, not lost
        f.set_exception(e)
    return f


@dataclasses.dataclass(frozen=True)
class FaultedResult(SearchResult):
    """A search result that an injected ``corrupt`` or ``partial`` fault
    damaged (``_faulted_result``), so the resilience layer can tell it
    from a wrong answer of the search itself."""


class MinerBackend(abc.ABC):
    """Abstract nonce-search engine behind the plugin boundary."""

    name: str = "abstract"
    #: True when the search runs a hand-written kernel, whose failures the
    #: resilience layer never hands to a lower rung unless a fault plan
    #: caused them.
    hand_written_kernel: bool = False

    @abc.abstractmethod
    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0,
               max_count: int = 1 << 32) -> SearchResult:
        """Finds the lowest qualifying nonce in the given range."""

    def launch(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = 1 << 32
               ) -> Callable[[], SearchResult]:
        """Starts a search and returns the function that finishes it (and
        returns what ``search`` would). A backend whose work runs on a
        device puts it there before returning; this default leaves all of
        it to the returned function."""
        return functools.partial(self.search, header80, difficulty_bits,
                                 start_nonce=start_nonce,
                                 max_count=max_count)

    def search_async(self, header80: bytes, difficulty_bits: int,
                     start_nonce: int = 0,
                     max_count: int = 1 << 32
                     ) -> "concurrent.futures.Future":
        """Future-returning dispatch, the seam the pipelined miner drives.
        The future resolves to exactly what ``search`` returns; errors
        arrive through the future. This default is the synchronous
        one-deep form."""
        return sync_search_future(self.search, header80, difficulty_bits,
                                  start_nonce=start_nonce,
                                  max_count=max_count)


_REGISTRY: dict[str, type[MinerBackend]] = {}


def register(name: str):
    def deco(cls: type[MinerBackend]):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_backend(name: str, **kwargs) -> MinerBackend:
    """Instantiates a registered backend: get_backend("cpu"|"cuda", ...)."""
    if name not in _REGISTRY:
        if name == "cpu":
            from . import cpu  # noqa: F401
        elif name == "cuda":
            from . import cuda  # noqa: F401
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ConfigError(f"unknown miner_backend {name!r}; "
                          f"known: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


def backend_from_config(config, resilient: bool = True) -> MinerBackend:
    """The one place a MinerConfig becomes a backend instance (shared by
    ``Miner`` and ``FusedMiner``'s rollover search).

    By default the instance is wrapped in the resilience layer's
    ``ResilientBackend``: retry with backoff around every dispatch,
    host-side re-validation of every winner, a ``search_async`` that
    launches at once and reads back when asked, and the step-down ladder
    (``cuda:<kernel>`` → ``cuda:torch`` → ``cpu``) on repeated failure of
    what may step down.
    ``resilient=False`` returns the raw top rung (equivalence tests and
    measurements of one backend).
    """
    if config.backend != "cpu" and config.n_miners != 1:
        raise ConfigError(
            f"the cuda backend mines on one device; n_miners="
            f"{config.n_miners} needs multi-GPU winner-select, which is "
            f"not ported yet")
    if resilient:
        from ..resilience.dispatch import ResilientBackend, \
            ladder_from_config
        return ResilientBackend(ladder_from_config(config))
    if config.backend == "cpu":
        return get_backend("cpu", n_ranks=config.n_miners,
                           batch_size=config.batch_size)
    return get_backend("cuda", batch_pow2=config.effective_batch_pow2,
                       kernel=config.kernel, device=config.device)


def _faulted_result(fault, res: SearchResult,
                    start_nonce: int) -> SearchResult:
    """Applies a dispatch-site ``corrupt`` / ``partial`` fault to a search
    result (shared by the cpu and cuda hooks):

    * ``corrupt``: the result lies. A found winner keeps its nonce but
      reports a damaged digest; an empty sweep fabricates a bogus winner.
      Either way host-side re-validation (``ResilientBackend``) must catch
      it: corruption is injected detectably wrong.
    * ``partial``: the result is truncated. Any winner is suppressed and
      only half the sweep is credited, the lost-result fault.

    A damaged result is a ``FaultedResult``.
    """
    if fault.kind == "partial":
        return FaultedResult(None, None, max(0, res.hashes_tried // 2))
    if fault.kind == "corrupt":
        if res.nonce is not None:
            bad = (bytes(b ^ 0xFF for b in res.hash) if res.hash
                   else b"\xff" * 32)
            return FaultedResult(res.nonce, bad, res.hashes_tried)
        return FaultedResult(start_nonce & 0xFFFFFFFF, b"\x00" * 32,
                             res.hashes_tried)
    return res
