"""Scenario objects for the network-scale adversarial simulation.

Everything stochastic in a scenario — message latency, seeded drops,
partition membership, node churn, and every adversary decision — draws
from ONE seed through counter-based generators (crc32 for scalar
decisions, numpy Philox for per-step vectors), never from global RNG
state or the wall clock, in the whole ``sim`` package. A scenario value
therefore IS the run:
two executions of the same ``Scenario`` produce byte-identical causal
dumps, churn and attacks included.

Fault-composition precedence (the ``seeded_drop``/``drop_fn``
composition contract, asserted by tests/test_sim_adversarial.py):

1. **churn** — a delivery to (or from) a node that is down at the
   delivery step is LOST: the node is not there to retransmit to, and
   real gossip does not queue for dead peers. Checked first.
2. **partition** — a delivery crossing an active partition boundary is
   DEFERRED to the partition's heal step (real networks retransmit;
   the reference's collective world never loses a broadcast), exactly
   like the legacy ``Network.partitioned_until`` semantics.
3. **drop** — only a delivery that survived churn and partition is
   subject to the seeded random drop schedule, and a dropped delivery
   is LOST.

All three are evaluated at the DELIVERY step (matching the legacy bus,
whose ``_blocked`` runs when a message comes due), keyed by the single
scenario seed — so adding churn or a partition never perturbs the drop
schedule's draws for unrelated (step, sender, receiver) triples.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from ..config import ConfigError
from .retarget import RetargetRule

#: blocked() verdicts, in precedence order (index = priority).
LOST_CHURN = "churn"        # receiver (or sender) down: delivery lost
DEFER_PARTITION = "partition"   # deferred to the partition heal step
LOST_DROP = "drop"          # seeded random loss


class ScenarioRng:
    """Counter-based randomness for one scenario seed.

    ``draw(tag, *key, mod)`` is a stateless crc32 draw (the
    ``seeded_drop`` idiom): the same (seed, tag, key) always yields the
    same value, regardless of call order — churn cannot shift the drop
    schedule. ``vector(tag, *key, n)`` is a Philox-keyed uniform [0,1)
    vector for per-step batched draws (mining lottery, latency), equally
    order-independent because the Philox counter is derived from the
    key, not from stream position.
    """

    _TAGS = ("drop", "latency", "mine", "churn", "adversary", "partition")

    def __init__(self, seed: int):
        self.seed = int(seed)

    def draw(self, tag: str, *key: int, mod: int) -> int:
        tag_id = zlib.crc32(tag.encode())
        packed = struct.pack(f"<qI{len(key)}q", self.seed, tag_id, *key)
        return zlib.crc32(packed) % mod

    def uniform(self, tag: str, *key: int) -> float:
        """One crc32 draw scaled to [0, 1)."""
        return self.draw(tag, *key, mod=1 << 30) / float(1 << 30)

    def vector(self, tag: str, a: int, b: int, n: int) -> np.ndarray:
        """Uniform [0,1) vector of length n, keyed by (seed, tag, a, b).

        (seed, tag) and (a, b) go into the Philox KEY, not its counter:
        the counter is the intra-stream block index that advances as
        values are drawn, so two streams whose start counters differ by
        one would be the same sequence shifted by one block — distinct
        keys are what Philox guarantees independence for.
        """
        tag_id = zlib.crc32(tag.encode())
        key = np.array([
            (self.seed & 0xFFFFFFFF) << 32 | tag_id,
            (a & 0xFFFFFFFF) << 32 | (b & 0xFFFFFFFF),
        ], dtype=np.uint64)
        return np.random.Generator(np.random.Philox(key=key)).random(n)


@dataclasses.dataclass(frozen=True)
class LatencySpec:
    """Per-(announcement, receiver) delivery delay distribution, in sim
    steps. ``fixed`` always takes ``min_steps``; ``uniform`` draws from
    [min_steps, max_steps] inclusive."""
    kind: str = "fixed"           # "fixed" | "uniform"
    min_steps: int = 1
    max_steps: int = 1

    def __post_init__(self):
        if self.kind not in ("fixed", "uniform"):
            raise ConfigError(f"latency kind must be fixed|uniform, "
                              f"got {self.kind!r}")
        if self.min_steps < 0 or self.max_steps < self.min_steps:
            raise ConfigError(f"latency wants 0 <= min <= max, got "
                              f"[{self.min_steps}, {self.max_steps}]")

    def delays(self, rng: ScenarioRng, step: int, announce_seq: int,
               n: int) -> np.ndarray:
        """Integer delay per receiver index (vectorized, seeded)."""
        if self.kind == "fixed" or self.min_steps == self.max_steps:
            return np.full(n, self.min_steps, dtype=np.int64)
        u = rng.vector("latency", step, announce_seq, n)
        span = self.max_steps - self.min_steps + 1
        return self.min_steps + (u * span).astype(np.int64)

    @classmethod
    def parse(cls, spec: str) -> "LatencySpec":
        """CLI form ``N`` (fixed) or ``LO-HI`` (uniform)."""
        if "-" in spec:
            lo, _, hi = spec.partition("-")
            try:
                return cls("uniform", int(lo), int(hi))
            except ValueError:
                raise ConfigError(f"--latency wants N or LO-HI, "
                                  f"got {spec!r}") from None
        try:
            n = int(spec)
        except ValueError:
            raise ConfigError(f"--latency wants N or LO-HI, "
                              f"got {spec!r}") from None
        return cls("fixed", n, n)


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """A first-class partition: from ``start`` (inclusive) to ``until``
    (exclusive) the node set splits into ``groups`` contiguous groups
    (node i in group ``i * groups // n_nodes``) and announcements do not
    cross group boundaries — they defer to the heal step ``until``."""
    start: int
    until: int
    groups: int = 2

    def __post_init__(self):
        if self.until <= self.start:
            raise ConfigError(f"partition window wants start < until, "
                              f"got [{self.start}, {self.until})")
        if self.groups < 2:
            raise ConfigError(f"partition wants >= 2 groups, "
                              f"got {self.groups}")

    def active(self, step: int) -> bool:
        return self.start <= step < self.until

    def group_of(self, node: int, n_nodes: int) -> int:
        return node * self.groups // n_nodes

    def groups_vec(self, n_nodes: int) -> np.ndarray:
        return (np.arange(n_nodes, dtype=np.int64)
                * self.groups) // n_nodes


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One membership change. Kinds: ``crash`` (down for ``down_steps``,
    then restart with chain intact — the crash-restart/checkpoint-recovery
    shape), ``leave`` (down until a later ``join``), ``join``
    (restart a down node, chain intact, syncs via the normal protocol)."""
    step: int
    node: int
    kind: str
    down_steps: int = 0

    def __post_init__(self):
        if self.kind not in ("crash", "leave", "join"):
            raise ConfigError(f"churn kind must be crash|leave|join, "
                              f"got {self.kind!r}")
        if self.kind == "crash" and self.down_steps <= 0:
            raise ConfigError("churn crash wants down_steps >= 1")


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """The scenario's membership timeline, as a fixed event list — the
    same shape as a ``FaultPlan``: a pure value, derivable from a seed
    via crc32 with no global RNG (``from_seed`` mirrors
    ``FaultPlan.from_seed``), so a churned run replays byte-identically."""
    events: tuple[ChurnEvent, ...] = ()

    @classmethod
    def from_seed(cls, seed: int, n_nodes: int, steps: int,
                  n_events: int) -> "ChurnSchedule":
        rng = ScenarioRng(seed)
        events = []
        for i in range(n_events):
            step = 1 + rng.draw("churn", i, 0, mod=max(1, steps - 1))
            node = rng.draw("churn", i, 1, mod=n_nodes)
            down = 5 + rng.draw("churn", i, 2, mod=max(1, steps // 10))
            events.append(ChurnEvent(step=step, node=node, kind="crash",
                                     down_steps=down))
        return cls(events=tuple(events))

    def by_step(self, steps: int) -> dict[int, list[ChurnEvent]]:
        """Events indexed by step, crash restarts expanded into joins."""
        out: dict[int, list[ChurnEvent]] = {}
        for e in self.events:
            out.setdefault(e.step, []).append(e)
            if e.kind == "crash":
                up = e.step + e.down_steps
                if up < steps:
                    out.setdefault(up, []).append(
                        ChurnEvent(step=up, node=e.node, kind="join"))
        return out


@dataclasses.dataclass(frozen=True)
class AdversarySpec:
    """One adversary strategy instance: ``kind`` selects the class in
    ``sim.strategies``, ``node`` is the attacker's id. ``victim`` is
    eclipse's target; ``start``/``until`` bound windowed attacks;
    ``hashrate`` multiplies the attacker's per-step mining power
    (selfish mining is only interesting with a non-trivial share);
    ``every`` paces repeated attacks (flood)."""
    kind: str                     # "selfish" | "eclipse" | "flood"
    node: int
    victim: int = -1
    start: int = 0
    until: int = 0                # 0 = open-ended
    hashrate: int = 1
    every: int = 25

    def __post_init__(self):
        if self.kind not in ("selfish", "eclipse", "flood"):
            raise ConfigError(f"adversary kind must be selfish|eclipse|"
                              f"flood, got {self.kind!r}")
        if self.node < 0:
            # A negative id would numpy-wrap onto a DIFFERENT node.
            raise ConfigError(f"adversary node id must be >= 0, "
                              f"got {self.node}")
        if self.victim < -1:
            raise ConfigError(f"adversary victim must be a node id or "
                              f"-1 (none/seeded), got {self.victim}")
        if self.kind == "eclipse":
            if self.victim < 0:
                raise ConfigError("eclipse wants a victim node id")
            if self.victim == self.node:
                raise ConfigError("eclipse victim must differ from the "
                                  "attacker")
        if self.until and self.until <= self.start:
            raise ConfigError(f"adversary window wants start < until "
                              f"(or until=0 for open-ended), got "
                              f"[{self.start}, {self.until})")
        if self.start < 0:
            raise ConfigError("adversary start must be >= 0")
        if self.hashrate < 1:
            raise ConfigError("adversary hashrate multiplier must be >= 1")
        if self.every < 1:
            raise ConfigError("adversary every must be >= 1")

    @classmethod
    def parse(cls, spec: str) -> "AdversarySpec":
        """CLI form ``kind:key=value[,key=value...]``, e.g.
        ``selfish:node=1,hashrate=8`` or ``eclipse:node=2,victim=5,
        start=50,until=120`` or ``flood:node=3,every=20``."""
        kind, _, rest = spec.partition(":")
        kwargs: dict = {}
        if rest:
            for pair in rest.split(","):
                key, eq, value = pair.partition("=")
                if not eq:
                    raise ConfigError(f"--strategy wants key=value pairs, "
                                      f"got {pair!r} in {spec!r}")
                try:
                    kwargs[key.strip()] = int(value)
                except ValueError:
                    raise ConfigError(f"--strategy {key} wants an integer, "
                                      f"got {value!r}") from None
        kwargs.setdefault("node", 0)
        try:
            return cls(kind=kind.strip(), **kwargs)
        except TypeError as e:
            raise ConfigError(f"bad --strategy {spec!r}: {e}") from None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One complete adversarial run, as a pure value (JSON-able via
    ``to_dict``). See the module docstring for the churn > partition >
    drop composition precedence ``blocked()`` implements."""
    n_nodes: int
    steps: int
    seed: int = 0
    difficulty_bits: int = 16
    # Expected hashes a node tries per step: P(block) per node per step
    # = hashes_per_step / 2^bits — the vectorized engine's abstract
    # stand-in for a backend sweep.
    hashes_per_step: int = 32
    retarget: RetargetRule | None = None
    latency: LatencySpec = LatencySpec()
    drop_rate_pct: int = 0
    partitions: tuple[PartitionWindow, ...] = ()
    churn: ChurnSchedule = ChurnSchedule()
    adversaries: tuple[AdversarySpec, ...] = ()
    # Per-delivery causal events (deliver/drop/defer). None = auto:
    # recorded for small worlds, summarized into counters at scale
    # (a 1000-node dump would be ~1e6 deliver events otherwise).
    record_deliveries: bool | None = None
    max_sync_suffix: int = 4096   # mirrors simulation.MAX_SYNC_SUFFIX
    # Extra steps (mining included) granted past ``steps`` to reconcile
    # — the vectorized form of the legacy "partition heals, then the
    # network must converge" epilogue. Margin steps are FAULT-FREE: the
    # drop schedule and the adversaries end with the scenario horizon
    # (a selfish miner must release-or-abandon its private fork there),
    # because under per-receiver random loss at 1000 nodes EVERY
    # announcement misses ~drop_rate% of the network, so strict tip
    # agreement is unreachable while the fault schedule is live.
    # 0 = hard cutoff, converged() reports the instantaneous truth.
    converge_margin: int = 0

    def __post_init__(self):
        if self.n_nodes < 2:
            raise ConfigError(f"scenario wants >= 2 nodes, "
                              f"got {self.n_nodes}")
        if self.steps < 1:
            raise ConfigError("scenario wants >= 1 step")
        if not 0 <= self.drop_rate_pct <= 100:
            raise ConfigError(f"drop_rate_pct must be in [0, 100], "
                              f"got {self.drop_rate_pct}")
        for a in self.adversaries:
            for field in ("node", "victim"):
                v = getattr(a, field)
                if v >= self.n_nodes:
                    raise ConfigError(f"adversary {a.kind} {field}={v} "
                                      f"outside the {self.n_nodes}-node "
                                      f"world")

    def rng(self) -> ScenarioRng:
        return ScenarioRng(self.seed)

    def record_deliveries_effective(self) -> bool:
        if self.record_deliveries is not None:
            return self.record_deliveries
        return self.n_nodes <= 64

    # ---- fault composition (the ONE blocked-decision point) -------------

    def partition_between(self, step: int, sender: int,
                          receiver: int) -> PartitionWindow | None:
        for w in self.partitions:
            if w.active(step) and (w.group_of(sender, self.n_nodes)
                                   != w.group_of(receiver, self.n_nodes)):
                return w
        return None

    def dropped(self, step: int, sender: int, receiver: int) -> bool:
        if not self.drop_rate_pct:
            return False
        rng = self.rng()
        return rng.draw("drop", step, sender, receiver,
                        mod=100) < self.drop_rate_pct

    def blocked(self, step: int, sender: int, receiver: int,
                alive=None) -> str | None:
        """The composed fault decision for one delivery attempt, under
        the documented precedence:

        1. ``"churn"``     — sender or receiver down at ``step`` (lost);
        2. ``"partition"`` — an active window separates them (deferred
           to the window's ``until``);
        3. ``"drop"``      — the seeded drop schedule fires (lost);
        4. ``None``        — delivered.

        ``alive`` is the engine's live-node predicate (node -> bool);
        without one, churn is judged from the static schedule alone.
        """
        if alive is not None:
            if not alive(receiver) or not alive(sender):
                return LOST_CHURN
        if self.partition_between(step, sender, receiver) is not None:
            return DEFER_PARTITION
        if self.dropped(step, sender, receiver):
            return LOST_DROP
        return None

    def drop_fn(self):
        """Legacy ``Network(drop_fn=...)`` adapter: the composed churn +
        drop verdicts as a plain (step, sender, receiver) -> bool (the
        legacy bus realizes partition windows via ``partitioned_until``
        and has no churn, so both non-deferring verdicts read as drops).
        Precedence inside the legacy bus is preserved: its ``_blocked``
        consults ``partitioned_until`` BEFORE this drop_fn, matching
        churn > partition > drop only when churn is empty — pass real
        churn through the vectorized engine instead."""
        def drop(step: int, sender: int, receiver: int) -> bool:
            verdict = self.blocked(step, sender, receiver)
            return verdict in (LOST_CHURN, LOST_DROP)
        return drop

    # ---- serialization ---------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["retarget"] = self.retarget.to_dict() if self.retarget else None
        return d


# ---- named scenario presets (cli: sim --preset <name>) --------------------

SCENARIO_PRESETS: dict[str, Scenario] = {
    # The headline: 1000 nodes, 10k steps, churn, retargeting,
    # a partition, and all three adversary strategies live at once.
    "adversarial-1k": Scenario(
        n_nodes=1000, steps=10_000, seed=0, difficulty_bits=16,
        hashes_per_step=32,
        # interval 600 => the canonical chain crosses ~3 retarget
        # boundaries inside the horizon, so the block rate measurably
        # decays and every post-boundary sync validates mixed-bits
        # suffixes (the "long-horizon scenarios are meaningful" point).
        retarget=RetargetRule(interval=600, step_bits=1, max_bits=20),
        latency=LatencySpec("uniform", 1, 3),
        drop_rate_pct=2,
        partitions=(PartitionWindow(start=2000, until=2400, groups=2),),
        churn=ChurnSchedule.from_seed(seed=0, n_nodes=1000, steps=10_000,
                                      n_events=40),
        adversaries=(
            AdversarySpec(kind="selfish", node=1, hashrate=120),
            AdversarySpec(kind="eclipse", node=2, victim=7,
                          start=4000, until=4500),
            AdversarySpec(kind="flood", node=3, every=50),
        ),
        converge_margin=2000,
    ),
    # The bench section's fixed workload (bench_sim_adversarial):
    # mid-size so two reps cost ~2 s, all three strategies + churn +
    # retargeting live so the steps/sec number prices the full
    # adversarial machinery, not an idle bus.
    "adversarial-bench": Scenario(
        n_nodes=200, steps=1500, seed=11, difficulty_bits=14,
        hashes_per_step=32,
        retarget=RetargetRule(interval=120, step_bits=1, max_bits=17),
        latency=LatencySpec("uniform", 1, 3),
        drop_rate_pct=2,
        partitions=(PartitionWindow(start=300, until=420, groups=2),),
        churn=ChurnSchedule.from_seed(seed=11, n_nodes=200, steps=1500,
                                      n_events=10),
        adversaries=(
            AdversarySpec(kind="selfish", node=1, hashrate=24),
            AdversarySpec(kind="eclipse", node=2, victim=9,
                          start=600, until=750),
            AdversarySpec(kind="flood", node=3, every=40),
        ),
        converge_margin=600,
    ),
    # Small, fast variant with the same moving parts — the test
    # surface.
    "adversarial-smoke": Scenario(
        n_nodes=24, steps=420, seed=7, difficulty_bits=10,
        hashes_per_step=16,
        retarget=RetargetRule(interval=50, step_bits=1, max_bits=12),
        latency=LatencySpec("uniform", 1, 2),
        drop_rate_pct=3,
        partitions=(PartitionWindow(start=80, until=140, groups=2),),
        churn=ChurnSchedule.from_seed(seed=7, n_nodes=24, steps=420,
                                      n_events=4),
        adversaries=(
            AdversarySpec(kind="selfish", node=1, hashrate=8),
            AdversarySpec(kind="eclipse", node=2, victim=5,
                          start=180, until=260),
            AdversarySpec(kind="flood", node=3, every=40),
        ),
        record_deliveries=True,
        converge_margin=400,
    ),
}
