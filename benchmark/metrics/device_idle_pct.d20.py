"""``device_idle_pct`` for the host-paced fused-d20 cell, read the same
way (``device_idle_pct.py``): a name of its own, so that its spread sets no
bound of the d24 cells."""
from benchmark import spec

read = spec.load_module(spec.metric_file("device_idle_pct")).read
