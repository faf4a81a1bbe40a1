"""Nonces the appended chain needs, over the whole window (host clock):
the sum over every block appended in the window of its winner + 1, and
2^32 for each empty extra-nonce space before it. Overshoot and discarded
speculative sweeps are not counted: they are waste."""


def read(run):
    if not run.blocks or run.window_s <= 0:
        return None
    return sum(b.needed for b in run.blocks) / run.window_s
