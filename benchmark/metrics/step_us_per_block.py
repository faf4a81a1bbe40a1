"""Device time of the fused loop's step kernels (``block_step_kernel``)
and symbol copies (the device-to-device copy of each block's extended
midstate into the sweep's constant), over the traced sub-window's blocks
(microseconds)."""


def read(run):
    t = run.trace
    if t is None or not run.trace_blocks or not t.count("block_step_kernel"):
        return None
    return t.seconds("block_step_kernel", "Memcpy DtoD") \
        / len(run.trace_blocks) * 1e6
