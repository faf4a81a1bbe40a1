"""``validate_us_per_block`` for the host-paced fused-d20 cell, read the
same way (``validate_us_per_block.py``): a name of its own, so that its
spread sets no bound of the d24 cells."""
from benchmark import spec

read = spec.load_module(spec.metric_file("validate_us_per_block")).read
