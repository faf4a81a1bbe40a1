"""``python -m benchmark --workload W --seed S --seconds X --trace 0|1``:
one run of one cell (``harness``)."""
from mpi_blockchain_tpu_torch.parallel.distributed import exit_process

from .harness import main

exit_process(main())
