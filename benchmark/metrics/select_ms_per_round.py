"""Rank 0's ``mesh.sweep`` skew spans in the window, the mean over its
rounds (ms): a round's wait for its own slice on the card and the gloo
winner-select over the ranks."""


def read(run):
    if not run.skew:
        return None
    return sum(run.skew) / len(run.skew) * 1e3
