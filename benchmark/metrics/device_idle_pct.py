"""Share of the traced sub-window in which no kernel, copy or set runs on
the card: one minus the union of the device intervals in the profiler's
trace over the window (%)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
