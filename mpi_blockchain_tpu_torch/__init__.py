"""mpi_blockchain_tpu_torch: the PyTorch/CUDA port of the miner.

The same proof-of-work chain as the JAX package ``mpi_blockchain_tpu``
(the reference), mined on an NVIDIA H100 through a hand-written CUDA
double-SHA-256 sweep kernel. The port imports nothing of the reference
package; the C++ chain core is a verbatim copy, so chains are
bit-identical across the two.

Layout:
  core/      C++ chain core (sha256, Block, Chain, Node) via ctypes
  ops/       the sweep: plain PyTorch version and the CUDA kernel
  backend/   miner_backend plugin boundary: {cpu, cuda}
  models/    the Miner driver (sequential and pipelined)
  convert.py state carried over from the reference (ext words, chains)
  cli.py     python -m mpi_blockchain_tpu_torch mine|verify|info
"""

__version__ = "0.1.0"

from .config import PRESETS, MinerConfig  # noqa: F401
