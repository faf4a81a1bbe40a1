"""Profiling hooks: the port's copy of the reference's
``utils/profiling.py``.

Wraps ``torch.profiler`` so a mining run can capture a trace of the card's
kernels beside the host:

    with trace_mining("/tmp/trace"):
        miner.mine_chain(10)

On exit the capture is written into the logdir as one Chrome trace a
process (``<host>_<pid>.<ns>.pt.trace.json``, through
``torch.profiler.tensorboard_trace_handler``), which ui.perfetto.dev opens,
as does ``tensorboard --logdir`` with its PyTorch profiler plugin. It
records the CPU and, where a card is there, CUDA activity: the kernels the
port's library launches run in the process's primary context, so CUPTI
records them by name (``sha256d_sweep_kernel``, ``block_step_kernel``)
although no PyTorch op launched them. While the capture records, every
host span (``miner.sweep``, ``fused.dispatch``, ``backend.cuda.dispatch``,
...) enters ``torch.profiler.record_function`` (``telemetry/spans.py``),
so the host timeline nests beside the kernels in the same trace.

The capture's window is padded on the card (``padded_window``):
``torch.profiler`` keeps a device event only where its conversion of the
card's clock to the host's puts the event inside the window, and on a
loaded host that conversion is off by milliseconds, so a kernel launched
in the first milliseconds of a capture can fall before its start and be
dropped. ``python -m mpi_blockchain_tpu_torch.tools.profile_window``
measures both the drop and the pad.

The logdir is created if missing. ``create_perfetto_link`` keeps the
reference's signature; the port serves no link, and prints the path of
each trace written on stderr instead. The reference's warned no-op for a
missing ``jax.profiler`` has no counterpart: ``torch.profiler`` is part of
torch.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

#: How long the card's capture window stays open, drained, before its body
#: and after it: far above the few milliseconds by which the profiler's
#: conversion of the card's clock was seen to be off on a loaded host.
WINDOW_PAD_S = 0.05


@contextlib.contextmanager
def padded_window():
    """Inside a running ``torch.profiler`` capture with CUDA activity: the
    card drained and WINDOW_PAD_S waited before the body, and again after
    it, so that no device event of the body lies near the window's edges,
    where the profiler drops the events its clock conversion puts
    outside."""
    import torch

    torch.cuda.synchronize()
    time.sleep(WINDOW_PAD_S)
    yield
    torch.cuda.synchronize()
    time.sleep(WINDOW_PAD_S)


@contextlib.contextmanager
def trace_mining(logdir: str, create_perfetto_link: bool = False):
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    window = contextlib.nullcontext()
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        window = padded_window()
    write = tensorboard_trace_handler(logdir)

    def on_trace_ready(prof) -> None:
        before = set(os.listdir(logdir))
        write(prof)
        if create_perfetto_link:
            for name in sorted(set(os.listdir(logdir)) - before):
                print(f"trace_mining: {os.path.join(logdir, name)} (open "
                      f"it in ui.perfetto.dev)", file=sys.stderr)

    with profile(activities=activities, on_trace_ready=on_trace_ready), \
            window:
        yield
