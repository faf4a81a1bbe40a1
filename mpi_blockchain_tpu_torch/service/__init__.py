"""The blockserve front door of the port: the overload-safe mempool and
template service.

The port's copy of the reference's ``service`` package. Users submit
fee-carrying transactions over HTTP; a bounded fee-ordered mempool
(``mempool.Mempool``) feeds per-height templates through the miner's
``payload_for`` seam (``frontdoor.TemplateFeed``); the door
(``frontdoor.ServiceState`` + ``ServiceServer``) sheds typed under
overload, bounds every request with a deadline, backpressures on the
miner's heartbeat age, and stamps degradation instead of going dark.

``install_service`` binds a miner and starts the door; ``service_stats()``
is the additive ``service`` payload that ``/healthz`` carries (``{}``
while no service is armed). The serve smoke is ``python -m
mpi_blockchain_tpu_torch.service smoke`` (``__main__``).
"""
from __future__ import annotations

import threading

from .frontdoor import (ServiceServer, ServiceState, TemplateFeed,
                        template_payload)
from .mempool import Mempool, TxRecord, txid_of

__all__ = ["Mempool", "ServiceServer", "ServiceState", "TemplateFeed",
           "TxRecord", "active_service", "install_service",
           "service_stats", "template_payload", "txid_of",
           "uninstall_service"]

_lock = threading.Lock()
_active: list[ServiceState] = []


def install_service(miner, port: int = 0, host: str = "127.0.0.1",
                    **state_kw) -> ServiceState:
    """Binds ``miner``'s template seam, starts the HTTP door, and arms
    the process-wide stats surface. Returns the state with its
    ``server`` attached (``state.server.port`` is the bound port)."""
    state = ServiceState(miner, **state_kw)
    state.bind()
    server = ServiceServer(state, port=port, host=host)
    server.start()
    state.server = server
    with _lock:
        _active.append(state)
    return state


def uninstall_service(state: ServiceState) -> None:
    """Stops the door, unbinds the miner, disarms stats. Idempotent."""
    with _lock:
        if state in _active:
            _active.remove(state)
    server = getattr(state, "server", None)
    if server is not None:
        server.close()
    state.unbind()


def active_service() -> ServiceState | None:
    with _lock:
        return _active[-1] if _active else None


def service_stats() -> dict:
    """The additive ``service`` observability key: the armed service's
    ``stats()``, or ``{}`` when none is armed (the shape healthz /
    shards / bundles carry in a serviceless process)."""
    state = active_service()
    if state is None:
        return {}
    return state.stats()
