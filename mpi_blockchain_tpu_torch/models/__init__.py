"""Miner drivers: the Miner loop over the sweep backends; chain state
stays in the C++ core."""
from .miner import BlockRecord, Miner  # noqa: F401
