"""The fused world: one process a rank, one card a rank, winner-select
over gloo (``mine --fused --coordinator``).

Rank 0 is the process that runs the cell. It picks a free port on
127.0.0.1, starts ranks 1..n-1 (``python -m benchmark.rank``), and every
rank joins the gloo world (the program's ``init_distributed``), takes
``cuda:<rank>`` and mines with ``FusedMiner(..., group=)``. Each span's
go-ahead is rank 0's, broadcast; at the end every rank hands its chain,
its memory peak and its traced busy time to rank 0 (``finish``).

Rank 0 watches the others: one that exits with an error, or a world
that runs ``HANG_S`` past its window, ends the run with no result, and
``close`` waits for each and kills any that outlive it. A rank whose
parent is gone ends itself.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

from . import devtrace, spec
from .mining import SingleDriver

JOIN_TIMEOUT_S = 60.0
#: A world still running this long after its window was due to end has
#: hung (a rank that never joins, a collective that never returns).
HANG_S = 240.0
HOST = "127.0.0.1"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def rank_argv(ctx, rank: int) -> list[str]:
    return [sys.executable, "-m", "benchmark.rank",
            "--workload", ctx.cell.name, "--seed", str(ctx.seed),
            "--seconds", str(ctx.seconds), "--trace", str(int(ctx.trace)),
            "--rank", str(rank), "--port", str(ctx.port),
            "--device", ctx.device, "--here", str(ctx.cell.here)]


def launch(argv: list[str]) -> subprocess.Popen:
    return subprocess.Popen(argv, cwd=spec.ROOT, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL)


def _slim(rank):
    """What rank 0 needs of another rank: its chain, memory and busy
    time, not its blocks or trace events."""
    trace = rank.trace
    if trace is not None:
        trace = devtrace.Trace(trace.window_s, trace.busy_s, [], [])
    return dataclasses.replace(rank, blocks=[], trace=trace,
                               trace_blocks=[], skew=[], logged=[])


class World(SingleDriver):
    def __init__(self, ctx):
        self.n = int(ctx.cell.config["devices"])
        self.procs: list = []
        self._done = threading.Event()
        if ctx.rank == 0:
            ctx.port = free_port()
            start = ctx.launch or launch
            self.procs = [start(rank_argv(ctx, r)) for r in range(1, self.n)]
            deadline = time.monotonic() + ctx.seconds + HANG_S
            threading.Thread(target=self._watch, args=(deadline,),
                             daemon=True).start()
        else:
            threading.Thread(target=self._orphaned, args=(os.getppid(),),
                             daemon=True).start()
        try:
            self._join(ctx)
        except BaseException:
            self._done.set()
            self._kill()
            raise

    def _join(self, ctx) -> None:
        import torch.distributed as dist
        from mpi_blockchain_tpu_torch.models.fused import FusedMiner
        from mpi_blockchain_tpu_torch.parallel.distributed import \
            init_distributed

        super().__init__(ctx)
        self.rank = int(ctx.rank)
        init_distributed(f"{HOST}:{ctx.port}", self.n, self.rank)
        self.group = dist.group.WORLD
        self.k = int(ctx.cell.traffic["blocks_per_call"])
        self.miner = FusedMiner(self.config(n_miners=self.n),
                                blocks_per_call=self.k,
                                group=self.group, log_fn=self.log)
        self.span_blocks = ctx.blocks_for("span_nonces_pow2", self.k)
        self.trace_blocks = ctx.blocks_for("trace_nonces_pow2", self.k)

    def _watch(self, deadline: float) -> None:
        while not self._done.wait(0.5):
            failed = [f"rank {i} exited with {p.poll()}"
                      for i, p in enumerate(self.procs, start=1)
                      if p.poll() not in (None, 0)]
            if time.monotonic() > deadline:
                failed.append(f"the world ran past its window by "
                              f"{HANG_S:.0f} s")
            if failed:
                print(f"benchmark: {'; '.join(failed)}; no result",
                      file=sys.stderr, flush=True)
                self._kill()
                os._exit(3)

    @staticmethod
    def _orphaned(parent: int) -> None:
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(4)

    def warmup(self) -> None:
        self.miner.warmup()
        self.mine(self.k)

    def agree(self, go: bool) -> bool:
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(go)], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.group)
        return bool(t.item())

    def finish(self, rank) -> list:
        import torch.distributed as dist

        ranks = [None] * self.n if self.rank == 0 else None
        dist.gather_object(rank if self.rank == 0 else _slim(rank), ranks,
                           dst=0, group=self.group)
        return ranks if self.rank == 0 else []

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self) -> None:
        from mpi_blockchain_tpu_torch.parallel.distributed import \
            shutdown_distributed

        self._done.set()
        try:
            shutdown_distributed()
        finally:
            deadline = time.monotonic() + JOIN_TIMEOUT_S
            for p in self.procs:
                try:
                    p.wait(max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    pass
            self._kill()


def make(ctx):
    return World(ctx)
