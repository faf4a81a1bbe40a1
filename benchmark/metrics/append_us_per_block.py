"""The program's ``miner.append`` span seconds in the window (the C++
node's validation and append) over the window's blocks (microseconds)."""


def read(run):
    count, seconds = run.spans.get("miner.append", (0, 0.0))
    if not count or not run.blocks:
        return None
    return seconds / len(run.blocks) * 1e6
