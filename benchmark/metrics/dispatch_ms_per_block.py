"""The program's ``backend.cuda.dispatch`` span seconds in the window
(the host's launch of each sweep: midstate, extension, launch) over the
window's blocks (ms)."""


def read(run):
    count, seconds = run.spans.get("backend.cuda.dispatch", (0, 0.0))
    if not count or not run.blocks:
        return None
    return seconds / len(run.blocks) * 1e3
