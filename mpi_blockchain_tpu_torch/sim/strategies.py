"""Pluggable adversary strategies for the vectorized scenario engine.

Three real attackers beyond the legacy drop/defer faults, each a small
state machine driven by the engine's step loop:

* **SelfishMiner** — withhold-and-release: mines privately on its own
  tip (its announcements are suppressed, counted in
  ``sim_selfish_blocks_withheld_total``), keeps the lead secret while it
  is >= 2, and releases the whole private chain the moment honest miners
  close the gap to one block — forcing the network to reorg onto the
  attacker's chain and orphan honest work. Falling behind abandons the
  private fork (the engine's normal sync adopts the public chain).
* **Eclipse** — monopolizes a victim's peer set for a window: every
  delivery to the victim not sent by the attacker is blocked (and the
  victim's own announcements reach only the attacker), so the victim
  extends an isolated fork; when the window closes, the first honest
  announcement triggers the standard live-height sync and the victim
  reorgs back — the recovery the byzantine regression tests assert.
* **StaleTipFlood** — spams forged deep suffixes at honest nodes,
  cycling through the three byzantine rejection paths (the
  ``max_sync_suffix`` length budget, broken header linkage, and a
  retarget-schedule bits mismatch). Every attempt must die in
  ``validate_suffix`` with a ``sync_rejected`` causal event and an
  untouched chain; the strategy asserts that — a flood that ever
  *succeeds* is a consensus bug, not an attack outcome.

Determinism contract: strategies draw randomness ONLY
from the engine's seeded ``ScenarioRng`` — no ``random``, no wall clock
— so every attack replays byte-identically under a fixed scenario.

Causal vocabulary for a forensics attack audit (the reference's
``forensics/attack_audit.py``): ``attack_withhold`` / ``attack_release``
/ ``attack_abandon`` on the selfish miner's log, ``attack_eclipse_start``
/ ``attack_eclipse_end`` on the bus log, ``attack_flood`` on the
flooder's log (each flood's rejection lands as the victim's
``sync_rejected``).
"""
from __future__ import annotations

import numpy as np

from ..telemetry import counter
from .scenario import AdversarySpec


class AdversaryStrategy:
    """Hook surface the engine drives. Subclasses override what they
    need; every hook is a no-op by default."""

    name = "adversary"

    def __init__(self, eng, spec: AdversarySpec):
        self.eng = eng
        self.spec = spec
        self.node = spec.node
        eng.hashrate[spec.node] = float(spec.hashrate)

    def on_step_begin(self, eng, step: int) -> None:
        pass

    def on_mined(self, eng, step: int, node: int, block) -> bool:
        """Return False to suppress the broadcast of ``block``."""
        return True

    def filter_delivery(self, eng, step: int, sender: int, block,
                        mask: np.ndarray) -> np.ndarray:
        return mask

    def on_step_end(self, eng, step: int) -> None:
        pass

    def on_horizon_end(self, eng, step: int) -> None:
        """The faulted horizon is over (the converge margin begins):
        wind the attack down so reconciliation can complete."""

    def eclipsing(self) -> int:
        """Victims this strategy currently monopolizes (the engine sums
        these into the ``sim_eclipse_victims`` gauge each step, so
        overlapping windows add up instead of clobbering)."""
        return 0

    def summary(self) -> dict:
        return {}


class SelfishMiner(AdversaryStrategy):
    name = "selfish"

    def __init__(self, eng, spec: AdversarySpec):
        super().__init__(eng, spec)
        self.withheld: list[int] = []     # private block idxs, oldest first
        self.withheld_total = 0
        self.released_total = 0
        self.releases = 0
        self.abandoned_total = 0

    def _public_height(self, eng) -> int:
        mask = eng.alive.copy()
        mask[self.node] = False
        return int(eng.heights[mask].max()) if mask.any() else 0

    def on_mined(self, eng, step: int, node: int, block) -> bool:
        if node != self.node or not eng.fault_phase:
            return True              # margin steps mine honestly
        if self.withheld and block.prev_idx != self.withheld[-1]:
            # The engine adopted the public chain between our last
            # withhold and this find (deliver runs before mine in a
            # step): the old private fork is orphaned. Without this
            # check, tips == the NEW block would mask the abandonment
            # in on_step_end and a later release would re-broadcast
            # dead-fork blocks as if they were a private lead.
            self.abandoned_total += len(self.withheld)
            eng.log(self.node).record("attack_abandon", step=step,
                                      count=len(self.withheld))
            self.withheld = []
        self.withheld.append(block.idx)
        self.withheld_total += 1
        counter("sim_selfish_blocks_withheld_total",
                help="blocks mined and withheld by the selfish miner"
                ).inc()
        eng.log(self.node).record(
            "attack_withhold", step=step, hash=block.key,
            height=block.height,
            lead=int(eng.heights[self.node]) - self._public_height(eng))
        return False

    def on_step_end(self, eng, step: int) -> None:
        if not self.withheld:
            return
        # The engine's normal sync may have adopted the public chain over
        # our private tip (we fell behind): the withheld blocks are
        # orphaned — record the abandonment and reset.
        if int(eng.tips[self.node]) != self.withheld[-1]:
            self.abandoned_total += len(self.withheld)
            eng.log(self.node).record("attack_abandon", step=step,
                                      count=len(self.withheld))
            self.withheld = []
            return
        lead = int(eng.heights[self.node]) - self._public_height(eng)
        if lead > 1:
            return                     # keep the lead secret
        if lead < 1:
            # Public passed us between syncs; dump the fork.
            self.abandoned_total += len(self.withheld)
            eng.log(self.node).record("attack_abandon", step=step,
                                      count=len(self.withheld))
            self.withheld = []
            return
        # lead == 1: honest miners closed the gap — release everything;
        # our chain is strictly longer, so the network must reorg onto it.
        count = len(self.withheld)
        tip = eng.blocks[self.withheld[-1]]
        eng.log(self.node).record("attack_release", step=step, count=count,
                                  tip=tip.key, height=tip.height,
                                  lead=lead)
        counter("sim_selfish_blocks_released_total",
                help="withheld blocks released to force a reorg"
                ).inc(count)
        for idx in self.withheld:
            eng.broadcast(self.node, idx)
        self.released_total += count
        self.releases += 1
        self.withheld = []

    def on_horizon_end(self, eng, step: int) -> None:
        """End of the faulted horizon: a still-secret private fork must
        be played or folded — release it if it is (weakly) ahead, else
        abandon — so the fault-free margin can reconcile one chain."""
        if not self.withheld:
            return
        if int(eng.tips[self.node]) == self.withheld[-1] and \
                int(eng.heights[self.node]) >= self._public_height(eng):
            count = len(self.withheld)
            tip = eng.blocks[self.withheld[-1]]
            eng.log(self.node).record("attack_release", step=step,
                                      count=count, tip=tip.key,
                                      height=tip.height, lead=0)
            counter("sim_selfish_blocks_released_total").inc(count)
            for idx in self.withheld:
                eng.broadcast(self.node, idx)
            self.released_total += count
            self.releases += 1
        else:
            self.abandoned_total += len(self.withheld)
            eng.log(self.node).record("attack_abandon", step=step,
                                      count=len(self.withheld))
        self.withheld = []

    def summary(self) -> dict:
        eng = self.eng
        canonical = eng.chain_miners()
        revenue = canonical.get(self.node, 0)
        total = sum(canonical.values())
        return {
            "node": self.node,
            "hashrate_share": round(
                float(eng.hashrate[self.node])
                / float(eng.hashrate[eng.alive].sum()), 4)
            if eng.alive.any() else 0.0,
            "withheld_total": self.withheld_total,
            "released_total": self.released_total,
            "releases": self.releases,
            "abandoned_total": self.abandoned_total,
            "revenue_blocks": revenue,
            "revenue_share": round(revenue / total, 4) if total else 0.0,
        }


class Eclipse(AdversaryStrategy):
    name = "eclipse"

    def __init__(self, eng, spec: AdversarySpec):
        super().__init__(eng, spec)
        self.victim = spec.victim
        self.blocked_total = 0
        self._started = False
        self._ended = False

    def active(self, step: int) -> bool:
        # The faulted horizon bounds every window: an open-ended
        # (until=0) eclipse still lifts when the converge margin starts.
        return (self.eng.fault_phase and self.spec.start <= step
                and (self.spec.until == 0 or step < self.spec.until))

    def _end(self, eng, step: int) -> None:
        if self._ended or not self._started:
            return
        self._ended = True
        eng.bus_log.record("attack_eclipse_end", step=step,
                           attacker=self.node, victim=self.victim,
                           victim_height=int(eng.heights[self.victim]))

    def on_step_begin(self, eng, step: int) -> None:
        if step == self.spec.start:
            self._started = True
            eng.bus_log.record("attack_eclipse_start", step=step,
                               attacker=self.node, victim=self.victim,
                               until_step=self.spec.until,
                               victim_height=int(eng.heights[self.victim]))
        if self.spec.until and step == self.spec.until:
            self._end(eng, step)

    def eclipsing(self) -> int:
        return 1 if self._started and not self._ended else 0

    def on_horizon_end(self, eng, step: int) -> None:
        # An open-ended window (until=0), or one reaching past the
        # horizon, really ends when the fault phase does — the gauge
        # and the audit's end event must say so.
        self._end(eng, step)

    def filter_delivery(self, eng, step: int, sender: int, block,
                        mask: np.ndarray) -> np.ndarray:
        if not self.active(step):
            return mask
        if sender == self.victim:
            # The victim's announcements reach only the attacker.
            kept = mask.copy()
            kept[:] = False
            kept[self.node] = mask[self.node]
            n_blocked = int(mask.sum()) - int(kept.sum())
            if n_blocked:
                self.blocked_total += n_blocked
                counter("sim_eclipse_blocked_total",
                        help="deliveries blocked by an eclipse "
                             "attacker monopolizing a victim's peers"
                        ).inc(n_blocked)
            return kept
        if sender != self.node and mask[self.victim]:
            mask = mask.copy()
            mask[self.victim] = False
            self.blocked_total += 1
            counter("sim_eclipse_blocked_total",
                    help="deliveries blocked by an eclipse attacker "
                         "monopolizing a victim's peers").inc()
        return mask

    def summary(self) -> dict:
        eng = self.eng
        return {
            "node": self.node,
            "victim": self.victim,
            "window": [self.spec.start, self.spec.until],
            "blocked_total": self.blocked_total,
            "victim_converged": bool(
                eng.tips[self.victim] == eng.canonical_tip().idx),
        }


class _ForgedBlock:
    """A stand-in header the flooder serves: quacks like a LightBlock
    for ``validate_suffix`` but never enters the store."""
    __slots__ = ("key", "prev_key", "height", "bits")

    def __init__(self, key, prev_key, height, bits):
        self.key = key
        self.prev_key = prev_key
        self.height = height
        self.bits = bits


class StaleTipFlood(AdversaryStrategy):
    name = "flood"

    #: rejection paths exercised, in rotation.
    MODES = ("budget", "linkage", "bits")

    def __init__(self, eng, spec: AdversarySpec):
        super().__init__(eng, spec)
        self.attacks = 0
        self.rejected_by_mode = {m: 0 for m in self.MODES}

    def _forged_suffix(self, eng, victim: int, mode: str):
        tip = eng.blocks[int(eng.tips[victim])]
        base_bits = eng.scenario.difficulty_bits
        if mode == "budget":
            # One deep stale suffix past the sync budget: the length
            # gate must fire before any per-header work.
            filler = _ForgedBlock("flood-fill", "flood-fill",
                                  tip.height + 1, base_bits)
            return tip.key, [filler] * (eng.scenario.max_sync_suffix + 1)
        chain, prev = [], tip
        for i in range(3):
            height = tip.height + 1 + i
            bits = eng.rule.expected_bits(base_bits, height)
            if mode == "bits":
                bits = base_bits - 1 if base_bits > 1 else base_bits + 7
            prev_key = prev.key if (mode != "linkage" or i != 1) \
                else "forged-gap"
            blk = _ForgedBlock(f"flood-{self.attacks}-{i}", prev_key,
                               height, bits)
            chain.append(blk)
            prev = blk
        return tip.key, chain

    def on_step_begin(self, eng, step: int) -> None:
        spec = self.spec
        if not eng.fault_phase:
            return
        if step < max(1, spec.start) or (spec.until
                                         and step >= spec.until):
            return
        if (step - max(1, spec.start)) % spec.every != 0:
            return
        if not eng.alive[self.node]:
            return
        victim = spec.victim
        if victim < 0:
            victim = eng.rng.draw("adversary", self.node, step,
                                  mod=eng.n_nodes)
        if victim == self.node or not eng.alive[victim]:
            return                      # deterministic skip this round
        mode = self.MODES[self.attacks % len(self.MODES)]
        self.attacks += 1
        counter("sim_flood_attacks_total",
                help="forged deep-suffix sync attempts launched by the "
                     "stale-tip flooder").inc()
        eng.log(self.node).record("attack_flood", step=step,
                                  victim=victim, mode=mode)
        tip_before = int(eng.tips[victim])
        anchor_key, forged = self._forged_suffix(eng, victim, mode)
        reason = eng.validate_suffix(anchor_key, forged)
        # A forged suffix that VALIDATES would be a consensus hole, not
        # an attack outcome — fail the run loudly rather than absorb it.
        assert reason is not None, (
            f"forged {mode} suffix passed validation: consensus bug")
        eng.reject_sync(victim, self.node, len(forged), reason)
        self.rejected_by_mode[mode] += 1
        assert int(eng.tips[victim]) == tip_before, \
            "flood mutated the victim's chain"

    def summary(self) -> dict:
        return {
            "node": self.node,
            "attacks": self.attacks,
            "rejected_by_mode": dict(self.rejected_by_mode),
        }


_STRATEGIES = {
    "selfish": SelfishMiner,
    "eclipse": Eclipse,
    "flood": StaleTipFlood,
}


def build_strategies(eng) -> tuple[AdversaryStrategy, ...]:
    return tuple(_STRATEGIES[spec.kind](eng, spec)
                 for spec in eng.scenario.adversaries)
