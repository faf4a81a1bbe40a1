"""Height-scheduled difficulty retargeting — the ONE rule, shared by the
C++ core and the vectorized simulation.

Timestamps in the frozen 80-byte header are structural (``timestamp ==
height``), so the only retarget rule every validator can agree on from
header bytes alone is a pure function of height:

    expected_bits(h) = min(base_bits + step_bits * (h // interval),
                           max_bits)                    for h >= 1
    expected_bits(0) = base_bits                        (genesis)

``interval == 0`` disables retargeting. The same closed form lives in
``chaincore::Chain::expected_bits`` (core/src/chain.cpp) — the C++ side
enforces it in ``valid_child`` on EVERY adoption path (submit, receive,
adopt_suffix), and this Python mirror lets the vectorized engine and the
SimNode pre-checks compute the schedule without a chain handle. The
equivalence is pinned by a test (tests/test_sim_adversarial.py).

Why a schedule and not a solve-rate feedback loop: with deterministic
structural timestamps there is no per-block time signal in the header, so
a rate-responsive rule could not be re-validated by a peer from the chain
bytes alone — it would break the "retarget rule validated on sync
adoption, not just locally" requirement. The schedule still
makes long-horizon scenarios meaningful: difficulty ramps as the chain
grows, so the block-production rate falls over a 10k-step run exactly as
a hardening network's would.
"""
from __future__ import annotations

import dataclasses

from ..config import ConfigError


@dataclasses.dataclass(frozen=True)
class RetargetRule:
    """The height schedule: +``step_bits`` difficulty every ``interval``
    blocks, clamped to ``max_bits`` (0 = uncapped at 255)."""
    interval: int
    step_bits: int = 1
    max_bits: int = 0

    def __post_init__(self):
        if self.interval < 0:
            raise ConfigError(f"retarget interval must be >= 0, "
                              f"got {self.interval}")
        if self.step_bits < 0:
            raise ConfigError(f"retarget step_bits must be >= 0, "
                              f"got {self.step_bits}")
        if self.max_bits < 0:
            raise ConfigError(f"retarget max_bits must be >= 0, "
                              f"got {self.max_bits}")

    def expected_bits(self, base_bits: int, height: int) -> int:
        """Bits a block at ``height`` must carry on a ``base_bits`` chain
        — the Python mirror of ``Chain::expected_bits``."""
        if self.interval == 0 or height == 0:
            return base_bits
        bits = base_bits + self.step_bits * (height // self.interval)
        cap = self.max_bits if self.max_bits else 255
        return min(bits, max(cap, base_bits))

    def apply(self, node) -> None:
        """Arms a ``core.Node`` with this rule (must still be at genesis)."""
        if self.interval and not node.set_retarget(
                self.interval, self.step_bits, self.max_bits):
            raise ConfigError(
                "cannot arm retargeting on a chain that already has "
                f"blocks (height {node.height})")

    @classmethod
    def parse(cls, spec: str) -> "RetargetRule":
        """CLI form ``INTERVAL[:STEP[:MAX]]`` (e.g. ``2000:1:20``)."""
        parts = spec.split(":")
        if not 1 <= len(parts) <= 3:
            raise ConfigError(f"--retarget wants INTERVAL[:STEP[:MAX]], "
                              f"got {spec!r}")
        try:
            nums = [int(p) for p in parts]
        except ValueError:
            raise ConfigError(f"--retarget wants integers, "
                              f"got {spec!r}") from None
        return cls(interval=nums[0],
                   step_bits=nums[1] if len(nums) > 1 else 1,
                   max_bits=nums[2] if len(nums) > 2 else 0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
