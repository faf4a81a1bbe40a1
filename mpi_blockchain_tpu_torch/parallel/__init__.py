"""Winner-select for more than one miner: the nonce-space split and its
collectives.

The port's counterpart of the reference's ``parallel`` package. The
reference's first-finder ``MPI_Bcast`` and height allreduce became psum /
pmin collectives inside a sharded XLA program there; here they are
``torch.distributed`` all-reduces over gloo on the host (``mesh``), in a
world of processes that ``distributed`` joins.
"""
from .mesh import (NONCE_SPACE, sharded_local_base,  # noqa: F401
                   stripe_windows, winner_select)
