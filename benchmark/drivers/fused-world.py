"""``FusedMiner(..., group=)`` in a world of processes, one rank a card
(``mine --fused --coordinator``); see ``benchmark/world.py``."""
from benchmark.world import make  # noqa: F401
