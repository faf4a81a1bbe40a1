"""Multi-node network simulation and adversarial harness (BASELINE
config 5).

The port's copy of the reference's ``simulation.py``: N miner groups that
mine concurrently, announce the blocks they find and resolve forks by
longest chain, as an in-process simulation of C++ nodes joined by a
message bus with injectable delay, drop and partition faults.

Determinism: the simulation advances in discrete steps. Each step, every
live group mines with a bounded nonce budget; found blocks are enqueued on
the bus with a configurable delivery delay (in steps). Within a step,
deliveries happen before mining, in (send_step, sender_id) order. Given
the same fault schedule, a run is exactly reproducible, and since every
backend returns the lowest qualifying nonce of a range, it is the same run
on every backend: ``sim --backend cuda`` (each group's bounded search is
one launch of the hand-written sweep kernel) steps, forks, reorgs and
logs exactly as the C++ sweep does, and as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import core
from .backend import MinerBackend, backend_from_config
from .config import ConfigError, MinerConfig, extend_payload
from .resilience import injection
from .telemetry import (CausalLog, counter, dump_causal_logs, gauge,
                        heartbeat, histogram)

# Byzantine-sync length budget: the longest adopt suffix a node accepts
# from a peer in one sync. An honest same-difficulty peer can never be
# this far ahead inside one simulation (the bus delivers every step);
# a response past it is a resource-exhaustion attack, not a fork heal.
MAX_SYNC_SUFFIX = 4096

# RecvResult codes as stable event vocabulary for the causal logs.
_RESULT_NAMES = {
    core.RecvResult.APPENDED: "appended",
    core.RecvResult.DUPLICATE: "duplicate",
    core.RecvResult.STALE_OR_FORK: "stale_or_fork",
    core.RecvResult.INVALID: "invalid",
    core.RecvResult.REORGED: "reorged",
    core.RecvResult.IGNORED_SHORTER: "ignored_shorter",
}


def _hdr_info(header80: bytes) -> dict:
    """Block identity fields every causal event carries: short hash,
    short prev hash, and height (timestamps are structural: ts == height)."""
    f = core.HeaderFields.unpack(header80)
    return {"hash": core.header_hash(header80).hex()[:12],
            "prev": f.prev_hash.hex()[:12],
            "height": f.timestamp}


@dataclasses.dataclass
class _Message:
    send_step: int
    deliver_step: int
    sender: int
    header80: bytes
    lamport: int = 0   # the sender's Lamport stamp at broadcast time


@dataclasses.dataclass
class GroupStats:
    blocks_mined: int = 0
    blocks_accepted_from_peers: int = 0   # via direct tip extension (receive)
    blocks_adopted: int = 0               # gained via suffix/chain adoption
    reorgs: int = 0
    reorged_away_blocks: int = 0   # blocks actually rolled back by adoptions
    headers_fetched: int = 0       # sync-protocol transfer accounting

    def conserved_height(self) -> int:
        """Every chain mutation is accounted, so a node's height is exactly
        mined + accepted + adopted - reorged_away (the fuzz invariant)."""
        return (self.blocks_mined + self.blocks_accepted_from_peers
                + self.blocks_adopted - self.reorged_away_blocks)


def locator_heights(tip: int) -> list[int]:
    """Bitcoin-style block locator: the last 10 heights step 1, then
    exponentially widening gaps, always ending at genesis. O(log height)
    entries; the first entry a peer recognizes bounds the common ancestor
    from below, making fork-heal transfer O(suffix), not O(height)."""
    heights, step, h = [], 1, tip
    while h > 0:
        heights.append(h)
        if len(heights) >= 10:
            step *= 2
        h -= step
    heights.append(0)
    return heights


class SimNode:
    """One miner group in the simulation: a C++ Node + backend + progress.

    ``retarget`` (a ``sim.retarget.RetargetRule``) arms the C++ chain's
    height-scheduled difficulty rule: candidates carry the scheduled
    bits (the search targets whatever the candidate demands), and the
    C++ ``valid_child`` enforces the schedule on every adoption path —
    local submits AND synced suffixes — so a peer serving wrong-bits
    headers is rejected exactly like one serving bad PoW.
    """

    def __init__(self, node_id: int, config: MinerConfig,
                 backend: MinerBackend | None = None, retarget=None):
        self.id = node_id
        self.config = config
        self.retarget = retarget
        self.node = core.Node(config.difficulty_bits, node_id)
        if retarget is not None:
            retarget.apply(self.node)
        if backend is None:  # honor the config's plugin choice (cli `sim
            # --backend cuda` runs the card's sweep inside each group);
            # each group is ONE rank, so the cpu pool stays unthreaded
            backend = backend_from_config(config, cpu_ranks=1)
        self.backend = backend
        self.stats = GroupStats()
        # Causal observability: every bus interaction this node takes part
        # in is stamped into its bounded Lamport-clock log (telemetry/
        # causal.py), which --events-dump and the flight recorder export.
        self.causal = CausalLog(node_id)
        # The bus's current step, mirrored in by Network.step() so events
        # recorded inside node methods carry the simulation time too.
        self.sim_step = 0
        # Per-height search position, so a group resumes its sweep across
        # steps instead of restarting at nonce 0 (restarting would let a
        # slower group never finish a block at higher difficulty).
        self._next_nonce = 0
        # Bumped when the 2^32 nonce space is exhausted without a winner:
        # it varies the candidate payload (hence data_hash), opening a
        # fresh search space instead of re-sweeping dead nonces forever.
        self._extra_nonce = 0
        self._tip_at_start = self.node.tip_hash

    def _candidate(self) -> bytes:
        data = f"{self.config.data_prefix}:g{self.id}:" \
               f"{self.node.height + 1}".encode()
        return self.node.make_candidate(
            extend_payload(data, self._extra_nonce))

    def mine_step(self, nonce_budget: int) -> bytes | None:
        """Searches up to nonce_budget nonces; returns a mined header or None.

        The tip moving (own block or peer block adopted) resets the sweep —
        the reference's preemption point: a stale candidate would fail
        prev-hash validation anyway.
        """
        tip = self.node.tip_hash
        if tip != self._tip_at_start:
            self._next_nonce = 0
            self._extra_nonce = 0
            self._tip_at_start = tip
        cand = self._candidate()
        # The candidate's own bits field IS the target: under a retarget
        # rule the C++ make_candidate stamps the scheduled bits for the
        # next height; without one it equals config.difficulty_bits.
        res = self.backend.search(cand, core.HeaderFields.unpack(cand).bits,
                                  start_nonce=self._next_nonce,
                                  max_count=nonce_budget)
        if res.nonce is None:
            self._next_nonce += nonce_budget
            if self._next_nonce >= 1 << 32:
                # Nonce space exhausted at this height: bump the extra
                # nonce so the next candidate carries different payload
                # data (new data_hash => a genuinely fresh search space).
                self._extra_nonce += 1
                self._next_nonce = 0
            return None
        winner = core.set_nonce(cand, res.nonce)
        assert self.node.submit(winner), "own block failed validation"
        self.causal.record("mine", step=self.sim_step, **_hdr_info(winner))
        self.stats.blocks_mined += 1
        self._next_nonce = 0
        self._extra_nonce = 0
        self._tip_at_start = self.node.tip_hash
        return winner

    # ---- sync protocol: "request chain (suffix)" ----------------------

    def find_anchor(self, locator: list[tuple[int, bytes]]) -> int:
        """Serve side: highest locator entry present on OUR chain (O(1)
        each via the C++ hash index). Heights are structural (timestamp ==
        height), so a common block sits at the same height on both chains;
        genesis is always common, so this never fails for same-difficulty
        peers."""
        for height, digest in locator:          # descending heights
            if self.node.find(digest) == height:
                return height
        return 0

    def receive(self, header80: bytes, peer: "SimNode",
                lamport: int | None = None) -> None:
        """Consensus on a peer announcement.

        ``lamport`` is the announcement's causal stamp (from the bus
        message); receipt merges it into this node's clock. Direct calls
        without a stamp (tests, ad-hoc wiring) record a plain local event.
        """
        r = self.node.receive(header80)
        self.causal.record("deliver", merge=lamport, step=self.sim_step,
                           sender=peer.id,
                           result=_RESULT_NAMES.get(r, str(r)),
                           **_hdr_info(header80))
        if r == core.RecvResult.APPENDED:
            self.stats.blocks_accepted_from_peers += 1
        elif r == core.RecvResult.STALE_OR_FORK:
            # Height gate on the peer's LIVE height (one O(1) query — the
            # reference's height-allreduce shape): a peer whose chain is
            # not longer than ours cannot win adoption, so syncing on its
            # stale announcement could only return IGNORED_SHORTER. Old
            # losing-branch announcements flushed at a partition heal
            # would otherwise each trigger a redundant O(suffix) fetch.
            # The ANNOUNCED height must not be the gate: under delivery
            # delay the announcement is stale while the peer's chain has
            # grown, and gating on it can suppress sync forever when the
            # delay exceeds the peer's lead (equal-rate fork livelock).
            if peer.node.height > self.node.height:
                self._sync_from(peer)

    def _sync_from(self, peer: "SimNode") -> None:
        """O(suffix) longest-chain sync: send a block locator, fetch only
        the peer's headers above the common ancestor, adopt the suffix.
        Falls back to a genesis-anchored (full-chain) fetch if the suffix
        unexpectedly fails to validate — the locator guarantees the anchor
        is common, so the fallback is pure defense in depth.

        The peer's response is NOT trusted wholesale: before adoption it
        must pass the byzantine bounds (``_validate_suffix`` — header
        size, header-chain linkage from the anchor, and the
        ``MAX_SYNC_SUFFIX`` length budget), or the sync is rejected with
        a ``sync_rejected`` causal event and the chain stays untouched.
        """
        own_height = self.node.height
        locator = [(h, self.node.block_hash(h))
                   for h in locator_heights(own_height)]
        anchor = peer.find_anchor(locator)
        suffix = peer.node.headers_from(anchor)
        # The sync is a request/response exchange with TWO causal edges:
        # our request reaches the peer (its serve event merges OUR clock),
        # and its response reaches us (our sync event merges the serve
        # stamp) — so a suffix adoption is always causally after the
        # serve, and the serve always after the deliver that triggered it.
        serve = peer.causal.record("serve_headers",
                                   merge=self.causal.clock.time,
                                   step=peer.sim_step,
                                   requester=self.id, anchor=anchor,
                                   count=len(suffix))
        self.causal.record("sync", merge=serve["lamport"],
                           step=self.sim_step, peer=peer.id, anchor=anchor,
                           fetched=len(suffix))
        self.stats.headers_fetched += len(suffix)
        reason = self._validate_suffix(anchor, suffix)
        if reason is not None:
            self._reject_sync(peer, anchor, len(suffix), reason)
            return
        res = self._adopt(anchor, suffix, own_height, peer=peer.id)
        if res == core.RecvResult.INVALID and anchor > 0:
            full = peer.node.all_headers()
            serve = peer.causal.record("serve_headers",
                                       merge=self.causal.clock.time,
                                       step=peer.sim_step,
                                       requester=self.id, anchor=0,
                                       count=len(full))
            self.causal.record("sync", merge=serve["lamport"],
                               step=self.sim_step, peer=peer.id, anchor=0,
                               fetched=len(full))
            self.stats.headers_fetched += len(full)
            reason = self._validate_suffix(0, full)
            if reason is not None:
                self._reject_sync(peer, 0, len(full), reason)
                return
            self._adopt(0, full, own_height, peer=peer.id)

    def _validate_suffix(self, anchor: int,
                         suffix: list[bytes]) -> str | None:
        """Byzantine bounds on a sync response; None when acceptable.

        Linkage is checked Python-side before any C++ adoption work:
        header i's prev_hash must equal the hash of header i-1 (the
        anchor block for i == 0), every header must be exactly 80
        bytes, and the whole response must fit the length budget. A
        forged response therefore costs O(len) hashing to reject and
        can never roll back a single block.
        """
        if len(suffix) > MAX_SYNC_SUFFIX:
            return (f"suffix length {len(suffix)} exceeds the "
                    f"{MAX_SYNC_SUFFIX}-header sync budget")
        prev = self.node.block_hash(anchor)
        for i, header in enumerate(suffix):
            if len(header) != core.HEADER_SIZE:
                return (f"header {i} is {len(header)} bytes, "
                        f"not {core.HEADER_SIZE}")
            fields = core.HeaderFields.unpack(header)
            if fields.prev_hash != prev:
                return f"header-chain linkage broken at offset {i}"
            if self.retarget is not None:
                expected = self.retarget.expected_bits(
                    self.config.difficulty_bits, anchor + 1 + i)
                if fields.bits != expected:
                    # The C++ valid_child would reject this too, but
                    # only after the anchor walk; pre-checking here
                    # gives the rejection a distinct causal reason the
                    # forensics attack audit can count.
                    return (f"retarget bits mismatch at offset {i}: "
                            f"got {fields.bits}, schedule demands "
                            f"{expected}")
            prev = core.header_hash(header)
        return None

    def _reject_sync(self, peer: "SimNode", anchor: int, count: int,
                     reason: str) -> None:
        self.causal.record("sync_rejected", step=self.sim_step,
                           peer=peer.id, anchor=anchor, count=count,
                           reason=reason)
        counter("sim_sync_rejected_total",
                help="peer sync responses rejected by the byzantine "
                     "bounds before adoption").inc()

    def _adopt(self, anchor: int, suffix: list[bytes],
               own_height: int, peer=None) -> int:
        old = [self.node.block_hash(i)
               for i in range(anchor + 1, own_height + 1)]
        old_tip = self.node.tip_hash.hex()[:12]
        res = self.node.adopt_suffix(anchor, suffix)
        if res == core.RecvResult.REORGED:
            rolled_hashes = [d.hex()[:12] for d in old
                             if self.node.find(d) < 0]
            rolled_back = len(rolled_hashes)
            adopted = self.node.height - own_height + rolled_back
            # ``peer`` (who served the adopted suffix) lets a forensics
            # flood audit prove chains-untouched non-vacuously.
            self.causal.record("adopt", step=self.sim_step,
                               peer=peer,
                               old_tip=old_tip,
                               new_tip=self.node.tip_hash.hex()[:12],
                               height=self.node.height, anchor=anchor,
                               adopted=adopted, rolled_back=rolled_back,
                               rolled_back_hashes=rolled_hashes)
            self.stats.blocks_adopted += adopted
            if rolled_back:
                self.stats.reorgs += 1
                self.stats.reorged_away_blocks += rolled_back
                counter("sim_reorgs_total",
                        help="chain reorganizations across all groups"
                        ).inc()
                histogram("sim_reorg_depth",
                          help="blocks rolled back per reorg"
                          ).observe(rolled_back)
        return res


class Network:
    """Message bus with fault injection between SimNodes."""

    def __init__(self, nodes: list[SimNode], delay_steps: int = 0,
                 drop_fn: Callable[[int, int, int], bool] | None = None,
                 partitioned_until: int | None = None):
        """drop_fn(step, sender, receiver) -> True to drop the delivery.

        partitioned_until: until that step, announcements do not cross
        between nodes at all (two isolated miner groups building competing
        chains — the BASELINE config-5 adversary).
        """
        self.nodes = nodes
        self.delay_steps = delay_steps
        self.drop_fn = drop_fn
        self.partitioned_until = partitioned_until
        self.queue: list[_Message] = []
        self.step_count = 0
        # The bus's own causal log: drops and partition-deferrals happen
        # IN the network, not on any node, so they are recorded by a
        # pseudo-node "bus" whose clock merges each message's send stamp.
        self.causal = CausalLog("bus")

    def _blocked(self, step: int, sender: int, receiver: int) -> bool:
        if self.partitioned_until is not None and step < self.partitioned_until:
            return True
        if self.drop_fn is not None and self.drop_fn(step, sender, receiver):
            return True
        return False

    def broadcast(self, sender: int, header80: bytes) -> None:
        counter("sim_messages_sent_total",
                help="block announcements enqueued on the bus").inc()
        deliver_step = self.step_count + self.delay_steps
        rec = self.nodes[sender].causal.record(
            "send", step=self.step_count, deliver_step=deliver_step,
            **_hdr_info(header80))
        self.queue.append(_Message(self.step_count, deliver_step,
                                   sender, header80,
                                   lamport=rec["lamport"]))

    def deliver_due(self, horizon: int = 0) -> None:
        """Delivers messages with deliver_step <= step_count + horizon.

        horizon > 0 is the post-target flush: in-flight announcements may
        be due up to delay_steps in the future, and no further mining steps
        will advance the clock to meet them.
        """
        # Mirror the bus clock into every node so node-side events
        # (deliver/sync/adopt) carry the SAME step as the bus-side
        # drop/defer events of this delivery round — including the
        # post-target flush, which runs after step() incremented the
        # clock past the nodes' last mirrored value.
        for node in self.nodes:
            node.sim_step = self.step_count
        cutoff = self.step_count + horizon
        due = [m for m in self.queue if m.deliver_step <= cutoff]
        self.queue = [m for m in self.queue if m.deliver_step > cutoff]
        due.sort(key=lambda m: (m.send_step, m.sender))
        for m in due:
            sender_node = self.nodes[m.sender]
            for node in self.nodes:
                if node.id == m.sender:
                    continue
                if self._blocked(self.step_count, m.sender, node.id):
                    # Re-queue across a partition: real networks retransmit;
                    # the reference's collective world never loses the
                    # broadcast, so the partition delays rather than
                    # destroys it.
                    if (self.partitioned_until is not None
                            and self.step_count < self.partitioned_until):
                        counter("sim_messages_partition_deferred_total",
                                help="deliveries deferred to the "
                                     "partition heal").inc()
                        self.causal.record(
                            "defer", merge=m.lamport, step=self.step_count,
                            sender=m.sender, receiver=node.id,
                            until_step=self.partitioned_until,
                            **_hdr_info(m.header80))
                        self.queue.append(dataclasses.replace(
                            m, deliver_step=self.partitioned_until))
                    else:
                        counter("sim_messages_dropped_total",
                                help="deliveries lost to the drop "
                                     "schedule").inc()
                        self.causal.record(
                            "drop", merge=m.lamport, step=self.step_count,
                            sender=m.sender, receiver=node.id,
                            **_hdr_info(m.header80))
                    continue
                # Fault-injection hook, per delivery attempt: raise/hang
                # crash the sim step (the flight recorder's home turf);
                # partial loses THIS delivery; corrupt damages the header
                # in flight so consensus must reject it (both recorded on
                # the bus's causal log for the forensics merge).
                header80 = m.header80
                fault = injection.check("sim.deliver", sender=m.sender,
                                        receiver=node.id)
                if fault is not None:
                    self.causal.record(
                        "fault", merge=m.lamport, step=self.step_count,
                        site="sim.deliver", fault=fault.kind,
                        sender=m.sender, receiver=node.id,
                        **_hdr_info(m.header80))
                    if fault.kind == "partial":
                        counter("sim_messages_fault_lost_total",
                                help="deliveries lost to an injected "
                                     "partial fault").inc()
                        continue
                    # corrupt: flip a data_hash byte — same length, so
                    # consensus sees a VALID-shaped but PoW-broken header.
                    header80 = (header80[:40] +
                                bytes([header80[40] ^ 0xFF]) +
                                header80[41:])
                node.receive(header80, sender_node, lamport=m.lamport)
                counter("sim_messages_delivered_total",
                        help="announcements delivered to a peer").inc()

    def step(self, nonce_budget: int = 1 << 16) -> None:
        """One simulation step: deliver, then every group mines a slice."""
        self.deliver_due()   # also mirrors step_count into node.sim_step
        for node in self.nodes:
            mined = node.mine_step(nonce_budget)
            if mined is not None:
                self.broadcast(node.id, mined)
        self.step_count += 1
        self.mirror_stats()
        # Progress heartbeat: /healthz watches the last_set age, so a
        # stalled sim (wedged backend, runaway step) flips unhealthy.
        heartbeat("sim_heartbeat").set(self.step_count)

    def mirror_stats(self) -> None:
        """Mirrors every group's GroupStats (+ height) as labeled gauges
        — the bus's counters see traffic; these see consensus state."""
        for node in self.nodes:
            g = str(node.id)
            for name, value in dataclasses.asdict(node.stats).items():
                gauge(f"sim_group_{name}", group=g).set(value)
            gauge("sim_group_height",
                  help="current chain height per group",
                  group=g).set(node.node.height)

    def run(self, target_height: int, max_steps: int = 10_000,
            nonce_budget: int = 1 << 16) -> int:
        """Steps until every node reaches target_height on ONE chain.

        Mining continues past target_height while tips disagree: an
        equal-height fork (both groups found a block at the same height) can
        only be broken by the next block — the keep-first rule means neither
        side adopts at equal length, exactly like the reference's
        longest-chain world.
        """
        while self.step_count < max_steps:
            self.step(nonce_budget)
            if all(n.node.height >= target_height for n in self.nodes):
                # Flush in-flight announcements (due up to delay_steps
                # ahead of the clock), then check for one chain.
                self.deliver_due(horizon=self.delay_steps)
                # The flush can adopt/reorg after the last step's mirror.
                self.mirror_stats()
                if self.converged():
                    return self.step_count
        err = RuntimeError(f"no convergence in {max_steps} steps")
        # The failed network IS the post-mortem: callers (sim CLI, flight
        # recorder) read .network off the exception to dump causal logs.
        err.network = self
        raise err

    def converged(self) -> bool:
        tips = {n.node.tip_hash for n in self.nodes}
        return len(tips) == 1

    # ---- causal observability export ------------------------------------

    def causal_logs(self) -> list:
        """Every per-node causal log plus the bus's own (drop/defer) log."""
        return [n.causal for n in self.nodes] + [self.causal]

    def dump_causal(self, path, meta: dict | None = None):
        """Write all causal logs as one forensics-ready JSON artifact
        (CLI: ``sim --events-dump PATH``), the same bytes the reference
        writes for the same run."""
        base = {"steps": self.step_count, "converged": self.converged(),
                "n_nodes": len(self.nodes),
                "heights": [n.node.height for n in self.nodes],
                "delay_steps": self.delay_steps,
                "partitioned_until": self.partitioned_until}
        base.update(meta or {})
        return dump_causal_logs(self.causal_logs(), path, meta=base)


def seeded_drop(drop_rate_pct: int, seed: int = 0
                ) -> Callable[[int, int, int], bool]:
    """Deterministic pseudo-random drop_fn: ~drop_rate_pct% of deliveries.

    Keyed by (step, sender, receiver, seed) through crc32, so a run with
    the same faults schedule is exactly reproducible (the simulation's
    determinism contract) with no global RNG state.
    """
    import struct
    import zlib

    def drop(step: int, sender: int, receiver: int) -> bool:
        key = struct.pack("<IIII", step, sender, receiver, seed)
        return zlib.crc32(key) % 100 < drop_rate_pct

    return drop


def run_adversarial(config: MinerConfig | None = None,
                    partition_steps: int = 30, target_height: int = 8,
                    nonce_budget: int = 1 << 8, delay_steps: int = 1,
                    drop_rate_pct: int = 0, seed: int = 0,
                    n_groups: int = 2, retarget=None,
                    on_network: Callable[["Network"], None] | None = None
                    ) -> Network:
    """BASELINE config 5: competing miner groups, then reconciliation.

    n_groups groups mine in a partition (building competing chains with
    different payloads), the partition heals, and longest-chain reorg
    resolution must converge every node onto one chain — optionally under
    delivery delay and seeded random message loss on top of the partition.
    ``retarget`` (a ``sim.retarget.RetargetRule``) arms every group's
    chain with the height-scheduled difficulty rule.
    """
    if n_groups < 2:
        raise ConfigError(f"n_groups must be >= 2, got {n_groups}")
    cfg = config if config is not None else MinerConfig(
        difficulty_bits=8, n_blocks=target_height, backend="cpu")
    nodes = [SimNode(i, cfg, retarget=retarget) for i in range(n_groups)]
    net = Network(nodes, delay_steps=delay_steps,
                  drop_fn=(seeded_drop(drop_rate_pct, seed)
                           if drop_rate_pct else None),
                  partitioned_until=partition_steps)
    if on_network is not None:
        # Hand the network out BEFORE the run: a non-converging run raises
        # out of net.run, and the caller (sim CLI / flight recorder) still
        # needs the causal logs of the failed run.
        on_network(net)
    net.run(target_height, nonce_budget=nonce_budget)
    return net
