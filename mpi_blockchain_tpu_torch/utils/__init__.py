"""Utilities of the port: crash-safe chain checkpoints (``checkpoint``)."""
