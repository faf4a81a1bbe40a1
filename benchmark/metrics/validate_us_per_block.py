"""The program's ``fused.validate`` span seconds in the window (the fused
driver's validation of each call's blocks: the candidate, the nonce, the
C++ append inside it and the ``block_mined`` record) over the window's
blocks (microseconds)."""


def read(run):
    count, seconds = run.spans.get("fused.validate", (0, 0.0))
    if not count or not run.blocks:
        return None
    return seconds / len(run.blocks) * 1e6
