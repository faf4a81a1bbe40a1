"""A world of miner processes: the port's multi-process launch.

The reference scales past one machine by launching more ranks
(``mpirun -np N``), each joining one ``jax.distributed`` world. Here each
process joins one ``torch.distributed`` world over gloo
(``init_distributed``) and mines as one miner on its card,
``cuda:<rank % device_count>``; the round's winner-select runs on the host
(``parallel.mesh.winner_select``). Nothing tells a process about a
cluster: the caller gives the coordinator's address, the world size and
the rank.
"""
from __future__ import annotations

import os
import sys

#: Whether this process joined a world (``init_distributed`` succeeded).
_joined = False


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Joins the gloo world at ``coordinator`` (``host:port``) as rank
    ``process_id`` of ``num_processes`` (call once per process). Callers
    that want a slow peer survivable wrap this in
    ``resilience.policy.call_with_retry(site="distributed.init")``, as the
    CLI does."""
    import torch.distributed as dist

    from ..config import ConfigError
    from ..resilience import injection

    if num_processes is None or process_id is None:
        raise ConfigError("--coordinator needs --num-processes and "
                          "--process-id")
    if not 0 <= process_id < num_processes:
        raise ConfigError(f"--process-id {process_id} out of range for "
                          f"{num_processes} process(es)")
    injection.check("distributed.init", coordinator=str(coordinator))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    global _joined
    _joined = True
    # The rank stamp: every rank-labeled metric, block trace frame and
    # pipeline record this process makes from here on carries it.
    from ..telemetry import set_mesh_rank
    set_mesh_rank(process_id)


def shutdown_distributed() -> None:
    """Leaves the world joined by ``init_distributed`` (a no-op when none
    was joined)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def exit_process(rc: int) -> None:
    """Ends a command-line process with ``rc``. A process that joined a
    world ends without the C++ runtime's teardown: under load, PyTorch's
    teardown after a gloo world sometimes aborts the process (SIGABRT,
    "terminate called without an active exception", with no Python frame
    left) after all of its work is done and printed. Python's streams are
    flushed first."""
    if not _joined:
        sys.exit(rc)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def world_info() -> dict:
    """Process and topology facts (the reference's rank/size
    introspection). Each process is one miner on one device, so the world
    holds as many devices as processes."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    return {"process_index": dist.get_rank() if joined else 0,
            "process_count": count,
            "local_devices": 1,
            "global_devices": count}
