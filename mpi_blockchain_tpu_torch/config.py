"""Configuration for mining runs on the PyTorch/CUDA port.

The port's own copy of the reference configuration: one dataclass, the
extra-nonce rollover rule, and the named presets with the same names and
numbers (``backend="cuda"`` where the reference says ``"tpu"``).
"""
from __future__ import annotations

import dataclasses

BACKENDS = ("cpu", "cuda")
KERNELS = ("auto", "torch", "cuda")
DEVICES = ("cuda", "cpu")


class ConfigError(ValueError):
    """Invalid configuration (bad kernel, device or batch, no card where
    one is required, a chain file that does not load, ...). The CLI turns
    exactly this class into a clean JSON error line; other exceptions keep
    their tracebacks."""


class KernelError(RuntimeError):
    """A native library failed to build, or a hand-written kernel failed to
    launch (no ``nvcc``, a compiler error, a CUDA error code). Like
    ``ConfigError`` it is never retried and never stepped over by the
    resilience ladder: a kernel that fails must fail the run loudly (CLI
    rc 2), not hand it to a slower rung."""


def extend_payload(data: bytes, extra_nonce: int) -> bytes:
    """The nonce-exhaustion rollover rule shared by every mining driver.

    When the full 2^32 nonce space of a candidate holds no qualifying
    hash, the search moves to a fresh space by varying the payload:

        extra_nonce == 0  ->  data unchanged
        extra_nonce == k  ->  data + b":xk"

    Drivers try extra_nonce = 0, 1, 2, ... in order and accept the lowest
    qualifying nonce of the first space that holds one, so the winner is a
    pure function of (tip, payload, difficulty).
    """
    if extra_nonce == 0:
        return data
    return data + b":x%d" % extra_nonce


# After this many consecutive empty 2^32 spaces the drivers raise instead
# of looping forever; only an unsatisfiable difficulty (>= ~48 bits) gets
# there.
MAX_EXTRA_NONCE = 1 << 16


@dataclasses.dataclass(frozen=True)
class MinerConfig:
    difficulty_bits: int = 16
    n_blocks: int = 10
    batch_pow2: int | str = 20    # log2(nonces per sweep round), or "auto"
    n_miners: int = 1             # CPU ranks (backend "cpu"); 1 on "cuda"
    backend: str = "cuda"         # {"cpu", "cuda"}
    kernel: str = "auto"          # sweep kernel: {"auto", "torch", "cuda"}
    device: str = "cuda"          # torch device of the "cuda" backend
    data_prefix: str = "block"    # payload = f"{data_prefix}:{height}"

    def __post_init__(self):
        if self.batch_pow2 != "auto" and not (
                isinstance(self.batch_pow2, int)
                and 0 <= self.batch_pow2 <= 32):
            raise ConfigError(
                f"batch_pow2 must be an int in [0, 32] or 'auto', "
                f"got {self.batch_pow2!r}")
        for field, value, allowed in (("backend", self.backend, BACKENDS),
                                      ("kernel", self.kernel, KERNELS),
                                      ("device", self.device, DEVICES)):
            if value not in allowed:
                raise ConfigError(f"{field} must be one of {allowed}, "
                                  f"got {value!r}")

    @property
    def effective_batch_pow2(self) -> int:
        """batch_pow2 with "auto" resolved: about one expected winner per
        round (2^difficulty), clamped to [13, 24]. The round size never
        moves the lowest-qualifying-nonce winner; it only sets the
        ``hashes_tried`` accounting."""
        if self.batch_pow2 == "auto":
            return min(max(self.difficulty_bits, 13), 24)
        return self.batch_pow2

    @property
    def batch_size(self) -> int:
        return 1 << self.effective_batch_pow2

    def payload(self, height: int, extra_nonce: int = 0) -> bytes:
        return extend_payload(f"{self.data_prefix}:{height}".encode(),
                              extra_nonce)


PRESETS: dict[str, MinerConfig] = {
    # 1: single-rank CPU mine: 10 blocks, difficulty=16, fixed genesis
    "cpu-single": MinerConfig(difficulty_bits=16, n_blocks=10, n_miners=1,
                              backend="cpu"),
    # 2: 4 CPU ranks, difficulty=20
    "cpu-np4": MinerConfig(difficulty_bits=20, n_blocks=10, n_miners=4,
                           backend="cpu"),
    # 3: one card, hand-written sweep kernel, nonce-batch=2^20, difficulty=20
    "tpu-single": MinerConfig(difficulty_bits=20, n_blocks=10, batch_pow2=20,
                              n_miners=1, backend="cuda", kernel="cuda"),
    # 4: data-parallel nonce-space split over 8 devices, difficulty=24
    "tpu-mesh8": MinerConfig(difficulty_bits=24, n_blocks=1000, batch_pow2=20,
                             n_miners=8, backend="cuda"),
    # 5: adversarial: 2 competing miner groups + longest-chain reorg
    "adversarial": MinerConfig(difficulty_bits=16, n_blocks=20, n_miners=2,
                               backend="cuda"),
}
