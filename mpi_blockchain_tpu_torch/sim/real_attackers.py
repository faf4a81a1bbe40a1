"""Live-bus attackers for the REAL ``simulation.Network`` / ``SimNode``.

The vectorized engine (``sim.vecnet``) scales attacks to 1000 nodes over
a lightweight chain model; this module aims the same strategies at the
real thing — C++ chains, 80-byte headers, the genuine ``_sync_from``
byzantine bounds — so the sync budget and linkage checks are
exercised by a live attacker on a live bus instead of hand-built
fixtures (the byzantine-bounds regression tests).

* ``FloodingSimNode`` joins a ``Network`` as a normal (non-mining)
  node whose ``node`` facade lies about its height and serves forged
  deep suffixes: every peer that hears its stale-tip announcement runs
  the full receive -> live-height gate -> ``_sync_from`` ->
  ``_validate_suffix`` path and must reject with ``sync_rejected``
  (budget or linkage, by mode), chain untouched.
* ``eclipse_drop_fn`` expresses an eclipse window as a composed drop
  schedule for the legacy bus: during [start, until) the victim hears
  only the attacker (and speaks only to it); afterwards the normal
  longest-chain sync must pull the victim back onto the honest chain.

Determinism: forged bytes come from sha256 over (seed, counter) — no
``os.urandom``, no wall clock.
"""
from __future__ import annotations

import hashlib

from ..simulation import MAX_SYNC_SUFFIX, Network, SimNode

#: Height the lying facade claims: any honest gate "is the peer ahead of
#: me?" must pass, no matter the victim's real height.
CLAIMED_HEIGHT = 1 << 30


def _forged_header(seed: int, i: int) -> bytes:
    """80 deterministic garbage bytes — VALID length, so the size gate
    passes and the linkage/budget gates do the rejecting."""
    d = hashlib.sha256(f"flood|{seed}|{i}".encode()).digest()
    return (d * 3)[:80]


class _LyingNode:
    """Facade over a real ``core.Node``: honest for the flooder's own
    consensus bookkeeping, byzantine on the serve side — inflated
    ``height`` plus forged ``headers_from``/``all_headers``."""

    def __init__(self, real, mode: str, seed: int):
        if mode not in ("budget", "linkage"):
            raise ValueError(f"flood mode must be budget|linkage, "
                             f"got {mode!r}")
        self._real = real
        self.mode = mode
        self.seed = seed
        # The lie is for the SERVE side (peers probing us). The owning
        # FloodingSimNode switches it off around its own consumption so
        # the inherited receive/sync logic sees the real chain.
        self.lying = True

    def __getattr__(self, name):
        return getattr(self._real, name)

    @property
    def height(self) -> int:
        return CLAIMED_HEIGHT if self.lying else self._real.height

    def _forged(self) -> list[bytes]:
        if self.mode == "budget":
            # One header past the sync budget: the length gate must fire
            # before any linkage hashing happens.
            return [_forged_header(self.seed, i)
                    for i in range(MAX_SYNC_SUFFIX + 1)]
        # Unlinked garbage inside the budget: the linkage gate's turf.
        return [_forged_header(self.seed, i) for i in range(3)]

    def headers_from(self, from_height: int) -> list[bytes]:
        return self._forged()

    def all_headers(self) -> list[bytes]:
        return self._forged()


class FloodingSimNode(SimNode):
    """A stale-tip flooder on the live bus. It never mines; it follows
    the honest chain through normal deliveries; and on ``flood()`` it
    broadcasts a forged stale announcement that drags every peer through
    the byzantine sync bounds."""

    def __init__(self, node_id: int, config, mode: str = "budget",
                 seed: int = 0):
        super().__init__(node_id, config)
        self.node = _LyingNode(self.node, mode, seed)
        self.seed = seed
        self.floods = 0

    def mine_step(self, nonce_budget: int):
        return None                     # all malice, no work

    def receive(self, header80: bytes, peer, lamport=None) -> None:
        """Honest consumption despite the lying serve facade: with the
        lie left on, the inherited sync gate would compare the peer's
        height against OUR inflated claim and never sync, wedging the
        flooder on any losing fork. An attacker must track the live tip
        to keep forging stale announcements against it, so the lie is
        switched off for the duration of our own receive."""
        self.node.lying = False
        try:
            super().receive(header80, peer, lamport=lamport)
        finally:
            self.node.lying = True

    def forged_announcement(self) -> bytes:
        # A fresh unknown header each flood: peers must see
        # STALE_OR_FORK (not DUPLICATE) and re-run the gate.
        self.floods += 1
        return _forged_header(self.seed + 7919, self.floods)

    def flood(self, net: Network) -> bytes:
        """Broadcasts one forged stale-tip announcement on the bus.
        Delivery (next ``deliver_due``) makes every honest peer sync
        from us and reject."""
        hdr = self.forged_announcement()
        self.causal.record("attack_flood", step=self.sim_step,
                           mode=self.node.mode, flood=self.floods)
        net.broadcast(self.id, hdr)
        return hdr


def eclipse_drop_fn(victim: int, attacker: int, start: int, until: int,
                    inner=None):
    """An eclipse window as a legacy-bus drop schedule: during
    [start, until) the victim's peer set is monopolized by the attacker
    — deliveries to the victim from anyone else, and from the victim to
    anyone else, are dropped. Outside the window, ``inner`` (e.g.
    ``seeded_drop`` or a ``Scenario.drop_fn()``) decides; composition
    precedence stays churn > partition > drop because the legacy bus
    consults ``partitioned_until`` before any drop_fn."""
    def drop(step: int, sender: int, receiver: int) -> bool:
        if start <= step < until:
            if receiver == victim and sender != attacker:
                return True
            if sender == victim and receiver != attacker:
                return True
        return inner(step, sender, receiver) if inner else False
    return drop
