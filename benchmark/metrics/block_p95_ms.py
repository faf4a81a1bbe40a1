"""95th percentile, over every block appended in the window, of the time
from its parent's append to its own (host clock, ms): the wait between
confirmations on the per-block path. Nearest rank."""
import math


def read(run):
    if not run.blocks:
        return None
    times = [run.t_parent] + [b.t for b in run.blocks]
    gaps = sorted(b - a for a, b in zip(times, times[1:]))
    return gaps[math.ceil(0.95 * len(gaps)) - 1] * 1e3
