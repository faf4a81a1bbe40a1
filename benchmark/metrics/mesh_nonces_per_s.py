"""``nonces_per_s`` of a world of ranks, from rank 0's chain: the nonces
the appended chain needs over the whole window (host clock). A metric of
its own, so that the spread of the world's rounds, paced by gloo
crossings between processes, sets no bound of the one-card cells."""
from benchmark import spec

read = spec.load_module(spec.metric_file("nonces_per_s")).read
