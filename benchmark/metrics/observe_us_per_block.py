"""The program's ``blocktrace.observe`` span seconds in the window (the
live critical-path observation after each block, or after each span of
fused calls, and the chainwatch cadence it drives) over the window's
blocks (microseconds)."""


def read(run):
    count, seconds = run.spans.get("blocktrace.observe", (0, 0.0))
    if not count or not run.blocks:
        return None
    return seconds / len(run.blocks) * 1e6
