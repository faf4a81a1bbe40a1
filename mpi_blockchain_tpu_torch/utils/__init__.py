"""Utilities of the port: crash-safe chain checkpoints (``checkpoint``)
and the JSON-lines logging helpers (``logging``)."""
