"""mpi_blockchain_tpu_torch: the PyTorch/CUDA port of the miner.

The same proof-of-work chain as the JAX package ``mpi_blockchain_tpu``
(the reference), mined on an NVIDIA H100 through a hand-written CUDA
double-SHA-256 sweep kernel. The port imports nothing of the reference
package; the C++ chain core is a verbatim copy, so chains are
bit-identical across the two.

Layout:
  core/        C++ chain core (sha256, Block, Chain, Node) via ctypes
  ops/         the sweep: plain PyTorch version and the CUDA kernel
  backend/     miner_backend plugin boundary: {cpu, cuda}
  models/      the Miner driver (sequential and pipelined), the fused miner
  parallel/    winner-select of more than one miner, the gloo world
  resilience/  retries, the step-down ladder, fault injection
  telemetry/   metrics, spans, events, causal logs, the flight recorder
  blocktrace/  per-block trace frames, the critical path, the overhead audit
  meshwatch/   the dispatch pipeline profiler (bubble and overlap)
  meshprof/    collective skew spans, device memory watermarks
  dispatchwatch/  the compile census (nvcc builds, k-block programs)
  chainwatch/  the live watchdog: anomaly rules, incidents, bundles
  service/     the blockserve front door (HTTP, mempool, template feed)
  perfwatch/   /metrics, /healthz, /events; history and the detector
  utils/       sealed checkpoints
  simulation.py  the adversarial multi-group bus (BASELINE config 5)
  sim/         the vectorized scenario engine and its adversaries (numpy)
  bench_lib.py sweep rate, chain wall and scenario-engine measurements
  convert.py   state carried over from the reference (ext words, chains)
  cli.py       python -m mpi_blockchain_tpu_torch mine|bench|verify|sim|info
"""

__version__ = "0.1.0"

from .config import PRESETS, MinerConfig  # noqa: F401
