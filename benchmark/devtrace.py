"""The traced sub-window: a ``torch.profiler`` capture of one span of
mining, reduced to device intervals.

``capture(body, device)`` runs ``body`` inside a capture of the CPU and,
on a card, its CUDA activity. The card is drained and ``PAD_S`` waited
before the body and after it, so that no device event of the body lies
near the capture's edges, where the profiler's conversion of the card's
clock to the host's can drop it. The window is the body's host span (an
annotation of its own), which ends once the card has finished the body's
work. The trace is exported to a temporary file, read and deleted.

``Trace`` keeps what the readers need: each device operation (kernel,
copy, set) with its interval, clipped to the window; their union
(``busy_s``); and the host annotations (the program's spans, which enter
``record_function`` while a profiler records) that name the gaps.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time

PAD_S = 0.05
WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list          # (name, start_s, end_s) of each device op in window
    gaps: list         # (host activity, seconds) of each idle gap

    def seconds(self, *fragments: str) -> float:
        """Device seconds of the ops whose name holds any fragment."""
        return sum(e - s for n, s, e in self.ops
                   if any(f in n for f in fragments))

    def count(self, *fragments: str) -> int:
        return sum(1 for n, _, _ in self.ops
                   if any(f in n for f in fragments))

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the idle time by what
        the host was doing, each at most ``top`` entries."""
        by_op: dict[str, float] = {}
        for n, s, e in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        by_gap: dict[str, float] = {}
        for n, g in self.gaps:
            by_gap[n] = by_gap.get(n, 0.0) + g
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in order],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short_name(name: str) -> str:
    """A device op's name without its return type, namespace and
    arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name).strip()[:120]


def reduce(events: list) -> Trace:
    """A chrome trace's events reduced to the window's device ops, their
    union and the idle gaps named by the host's innermost annotation."""
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t > s:
            ops.append((short_name(e.get("name", "?")), s, t))
    ops.sort(key=lambda o: o[1])
    busy, gaps, end = 0.0, [], w0
    for _, s, t in ops:
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps.append((end, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    named = []
    for s, t in gaps:
        mid = (s + t) / 2
        name = "none"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        named.append((name, (t - s) * 1e-6))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                 ops=[(n, s * 1e-6, t * 1e-6) for n, s, t in ops],
                 gaps=named)


def capture(body, device):
    """Runs ``body()`` in a padded capture; returns (its value, Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)

    def drain() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    with profile(activities=activities) as prof:
        drain()
        time.sleep(PAD_S)
        with record_function(WINDOW):
            out = body()
            drain()
        time.sleep(PAD_S)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return out, reduce(events)
