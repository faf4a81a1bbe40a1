"""Utilities of the port: crash-safe chain checkpoints (``checkpoint``),
the JSON-lines logging helpers (``logging``) and the profiler capture of a
mining run (``profiling``)."""
