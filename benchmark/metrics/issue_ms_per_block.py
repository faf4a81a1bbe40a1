"""The program's ``miner.issue`` span seconds in the window (the per-block
driver's issue of each sweep: its pipeline record, the candidate, the
resilient backend's ``search_async`` and ``backend.cuda.dispatch`` inside
it) over the window's blocks (ms)."""


def read(run):
    count, seconds = run.spans.get("miner.issue", (0, 0.0))
    if not count or not run.blocks:
        return None
    return seconds / len(run.blocks) * 1e3
