"""Seconds from the process's start to the first timed block: imports,
the CUDA context, the program's libraries built or loaded, the warm-up
(host clock)."""


def read(run):
    return run.setup_s
