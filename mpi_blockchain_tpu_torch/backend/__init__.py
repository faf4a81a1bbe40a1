"""The miner_backend plugin boundary of the port.

Every backend implements the same deterministic contract: return the
LOWEST nonce in [start_nonce, start_nonce + count) whose double-SHA-256
header hash has >= difficulty_bits leading zero bits. Lowest-nonce, not
first-found, is what makes every backend mine identical chains.

Difference from the reference: ``backend_from_config`` returns the raw
backend. The reference wraps it in a ``ResilientBackend`` ladder (retry,
host re-validation, step-down from the device kernel to slower rungs) with
fault-injection sites; that ladder waits for a later slice of the port,
because on this path stepping down would hide a kernel failure.
"""
from __future__ import annotations

import abc
import concurrent.futures
import dataclasses

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


class MinerBackend(abc.ABC):
    """Abstract nonce-search engine behind the plugin boundary."""

    name: str = "abstract"

    @abc.abstractmethod
    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0,
               max_count: int = 1 << 32) -> SearchResult:
        """Finds the lowest qualifying nonce in the given range."""

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


def backend_from_config(config) -> MinerBackend:
    """The one place a MinerConfig becomes a backend instance."""
    if config.backend == "cpu":
        return get_backend("cpu", n_ranks=config.n_miners,
                           batch_size=config.batch_size)
    if config.n_miners != 1:
        raise ConfigError(
            f"the cuda backend mines on one device; n_miners="
            f"{config.n_miners} needs multi-GPU winner-select, which is "
            f"not ported yet")
    return get_backend("cuda", batch_pow2=config.effective_batch_pow2,
                       kernel=config.kernel, device=config.device)
