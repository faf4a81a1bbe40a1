"""The vectorized network engine: ~1000 nodes x 10k steps in minutes.

Where ``simulation.Network`` drives a handful of ``SimNode``s each owning
a real C++ chain and a real search backend, this engine scales the SAME
consensus protocol shape to network size by making both the mining and
the bus *batched*:

* **Mining** is an abstract lottery: node i finds a block in a step with
  probability ``hashes_per_step * hashrate_i / 2^bits`` — one seeded
  Philox vector draw per step for the whole world, not N backend sweeps.
  Blocks are lightweight records (prev/height/bits/miner/step) in one
  shared append-only store; a node's chain is its tip index plus the
  prev-pointer walk.
* **Delivery** is batched: announcements land in per-step buckets, each
  carrying a numpy receiver mask. Latency draws, drop draws, partition
  membership, and tip-extension appends are all vectorized over the
  receiver axis; only the rare consensus decisions (fork sync, reorg
  adoption) drop to per-group Python — and those are grouped by unique
  receiver tip, so 500 healing nodes cost one validation, not 500.
* **Consensus** mirrors ``SimNode`` exactly: extend-tip appends,
  keep-first at equal height, sync gated on the sender's LIVE height,
  suffix validation (length budget + linkage + retarget bits) BEFORE
  adoption, rejected syncs leave the chain untouched and emit
  ``sync_rejected`` causally + ``sim_sync_rejected_total``.

Fault composition follows ``Scenario.blocked()``'s documented precedence
— churn (lost) > partition (deferred to heal) > drop (lost) — evaluated
at the delivery step, vectorized. Every stochastic draw is keyed by the
scenario seed through counter-based generators (no global RNG, no wall
clock), so two runs of one scenario produce
byte-identical causal dumps, churn, retargeting and attacks included.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..resilience import injection
from ..telemetry import (CausalLog, counter, dump_causal_logs, gauge,
                         heartbeat, histogram)
from .retarget import RetargetRule
from .scenario import (DEFER_PARTITION, LOST_CHURN, LOST_DROP,
                       ChurnEvent, Scenario, ScenarioRng)
from .strategies import build_strategies


class LightBlock:
    """One block in the shared store. ``key`` is the deterministic short
    hash the causal logs and forensics speak; ``idx`` its store index."""
    __slots__ = ("idx", "key", "prev_idx", "prev_key", "height", "bits",
                 "miner", "step")

    def __init__(self, idx, key, prev_idx, prev_key, height, bits, miner,
                 step):
        self.idx = idx
        self.key = key
        self.prev_idx = prev_idx
        self.prev_key = prev_key
        self.height = height
        self.bits = bits
        self.miner = miner
        self.step = step


@dataclasses.dataclass
class _Announce:
    """A broadcast in flight: ``mask`` is the receiver set still owed
    delivery at ``deliver_step`` (partition deferrals re-enqueue the
    blocked sub-mask at the heal step)."""
    seq: int
    send_step: int
    sender: int
    block_idx: int
    lamport: int
    mask: np.ndarray


class VecNetwork:
    """The scenario engine. ``run()`` executes the scenario's steps plus
    a drain phase and returns a JSON-able summary."""

    GENESIS_KEY = "genesis0"

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self.rng: ScenarioRng = scenario.rng()
        n = scenario.n_nodes
        self.n_nodes = n
        self.step_count = 0
        self.record_deliveries = scenario.record_deliveries_effective()
        self.rule: RetargetRule = (scenario.retarget
                                   or RetargetRule(interval=0))
        # Block store: index 0 is genesis for every node.
        genesis = LightBlock(0, self.GENESIS_KEY, -1, "", 0,
                             scenario.difficulty_bits, -1, 0)
        self.blocks: list[LightBlock] = [genesis]
        self._block_index: dict[str, int] = {genesis.key: 0}
        # Vectorized node state.
        self.tips = np.zeros(n, dtype=np.int64)
        self.heights = np.zeros(n, dtype=np.int64)
        self.alive = np.ones(n, dtype=bool)
        self.hashrate = np.ones(n, dtype=np.float64)
        self.blocks_mined = np.zeros(n, dtype=np.int64)
        self.reorgs = np.zeros(n, dtype=np.int64)
        self.reorged_away = np.zeros(n, dtype=np.int64)
        # Delivery buckets: deliver_step -> announcements due then.
        self._buckets: dict[int, list[_Announce]] = {}
        self._announce_seq = 0
        self._churn_by_step = scenario.churn.by_step(scenario.steps)
        # Causal logs: per-node lazily (a 1000-node world where most
        # nodes never hit a consensus event should not allocate 1000
        # rings), plus the bus's own log for drop/defer/churn events.
        self._logs: dict[int, CausalLog] = {}
        self.bus_log = CausalLog("bus")
        self.strategies = build_strategies(self)
        self._sync_rejections = 0
        self._deliveries = 0
        self._drain_steps = 0
        # True during the scenario's faulted horizon; False in the
        # converge margin (fault-free reconciliation — see Scenario).
        self.fault_phase = True

    # ---- causal plumbing -------------------------------------------------

    def log(self, node: int) -> CausalLog:
        lg = self._logs.get(node)
        if lg is None:
            lg = self._logs[node] = CausalLog(node)
        return lg

    def _hdr_info(self, b: LightBlock) -> dict:
        return {"hash": b.key, "prev": b.prev_key, "height": b.height}

    # ---- block store -----------------------------------------------------

    def new_block(self, prev_idx: int, miner: int, step: int,
                  bits: int | None = None) -> LightBlock:
        prev = self.blocks[prev_idx]
        height = prev.height + 1
        if bits is None:
            bits = self.rule.expected_bits(self.scenario.difficulty_bits,
                                           height)
        key = hashlib.sha256(
            f"{prev.key}|{miner}|{height}|{step}|{self.scenario.seed}"
            .encode()).hexdigest()[:12]
        b = LightBlock(len(self.blocks), key, prev_idx, prev.key, height,
                       bits, miner, step)
        self.blocks.append(b)
        self._block_index[key] = b.idx
        return b

    def chain_suffix(self, tip_idx: int, above_height: int
                     ) -> list[LightBlock]:
        """Blocks on tip's chain with height > above_height, ascending."""
        out = []
        b = self.blocks[tip_idx]
        while b.height > above_height:
            out.append(b)
            b = self.blocks[b.prev_idx]
        out.reverse()
        return out

    def common_ancestor_height(self, a_idx: int, b_idx: int) -> int:
        a, b = self.blocks[a_idx], self.blocks[b_idx]
        while a.height > b.height:
            a = self.blocks[a.prev_idx]
        while b.height > a.height:
            b = self.blocks[b.prev_idx]
        while a.idx != b.idx:
            a = self.blocks[a.prev_idx]
            b = self.blocks[b.prev_idx]
        return a.height

    # ---- sync validation (the SimNode._validate_suffix mirror) -----------

    def validate_suffix(self, anchor_key: str, suffix) -> str | None:
        """Byzantine bounds on a sync response; None when acceptable.
        ``suffix`` is a list of LightBlocks (or forged stand-ins with the
        same attributes). Checks, in order: the ``max_sync_suffix``
        length budget, prev-key linkage from the anchor, and the
        retarget schedule on every header's bits — the same three gates
        ``SimNode`` applies to real 80-byte suffixes."""
        if len(suffix) > self.scenario.max_sync_suffix:
            return (f"suffix length {len(suffix)} exceeds the "
                    f"{self.scenario.max_sync_suffix}-header sync budget")
        prev = anchor_key
        for i, b in enumerate(suffix):
            if b.prev_key != prev:
                return f"header-chain linkage broken at offset {i}"
            expected = self.rule.expected_bits(
                self.scenario.difficulty_bits, b.height)
            if b.bits != expected:
                return (f"retarget bits mismatch at offset {i}: "
                        f"got {b.bits}, schedule demands {expected}")
            prev = b.key
        return None

    def reject_sync(self, node: int, peer: int, count: int,
                    reason: str) -> None:
        self.log(node).record("sync_rejected", step=self.step_count,
                              peer=peer, count=count, reason=reason)
        counter("sim_sync_rejected_total",
                help="peer sync responses rejected by the byzantine "
                     "bounds before adoption").inc()
        self._sync_rejections += 1

    # ---- delivery --------------------------------------------------------

    def broadcast(self, sender: int, block_idx: int,
                  mask: np.ndarray | None = None) -> None:
        """Enqueues one announcement; per-receiver latency buckets it."""
        b = self.blocks[block_idx]
        seq = self._announce_seq
        self._announce_seq += 1
        counter("sim_messages_sent_total",
                help="block announcements enqueued on the bus").inc()
        rec = self.log(sender).record("send", step=self.step_count,
                                      **self._hdr_info(b))
        base = np.ones(self.n_nodes, dtype=bool) if mask is None \
            else mask.copy()
        base[sender] = False
        delays = self.scenario.latency.delays(
            self.rng, self.step_count, seq, self.n_nodes)
        for d in np.unique(delays[base]):
            sub = base & (delays == d)
            # Clamped to >= 1: this step's bucket was already popped, so
            # a same-step key would strand the delivery (the legacy bus
            # likewise lands a delay-0 broadcast on the NEXT deliver).
            self._buckets.setdefault(
                self.step_count + max(int(d), 1), []).append(
                _Announce(seq, self.step_count, sender, block_idx,
                          rec["lamport"], sub))

    def _deliver_due(self) -> None:
        # Everything due AT OR BEFORE the clock (not just the exact key):
        # a stale bucket must never strand deliveries past its step.
        due_keys = sorted(k for k in self._buckets
                          if k <= self.step_count)
        if not due_keys:
            return
        due = [ann for k in due_keys for ann in self._buckets.pop(k)]
        due.sort(key=lambda a: (a.send_step, a.sender, a.seq))
        for ann in due:
            self._deliver_one(ann)

    def _deliver_one(self, ann: _Announce) -> None:
        step = self.step_count
        b = self.blocks[ann.block_idx]
        mask = ann.mask
        # Precedence 1 — churn: a receiver (or the sender) down at the
        # delivery step loses the delivery outright.
        if not self.alive[ann.sender]:
            lost = mask.copy()
        else:
            lost = mask & ~self.alive
        n_lost = int(lost.sum())
        if n_lost:
            counter("sim_messages_churn_lost_total",
                    help="deliveries lost to node churn (receiver or "
                         "sender down at the delivery step)").inc(n_lost)
            if self.record_deliveries:
                # Same "drop"/"defer" vocabulary as the legacy bus so the
                # forensics reorg audit explains vec forks too; ``cause``
                # carries which composed fault won.
                for r in np.nonzero(lost)[0]:
                    self.bus_log.record("drop", merge=ann.lamport,
                                        step=step, sender=ann.sender,
                                        receiver=int(r), cause=LOST_CHURN,
                                        **self._hdr_info(b))
            mask = mask & ~lost
        if not self.alive[ann.sender]:
            return
        # Precedence 2 — partition: cross-boundary deliveries defer to
        # the heal step (re-enqueued with the blocked sub-mask).
        for w in self.scenario.partitions:
            if not w.active(step):
                continue
            groups = w.groups_vec(self.n_nodes)
            blocked = mask & (groups != groups[ann.sender])
            n_block = int(blocked.sum())
            if n_block:
                counter("sim_messages_partition_deferred_total",
                        help="deliveries deferred to the partition "
                             "heal").inc(n_block)
                if self.record_deliveries:
                    for r in np.nonzero(blocked)[0]:
                        self.bus_log.record(
                            "defer", merge=ann.lamport, step=step,
                            sender=ann.sender, receiver=int(r),
                            cause=DEFER_PARTITION,
                            until_step=w.until, **self._hdr_info(b))
                self._buckets.setdefault(w.until, []).append(
                    dataclasses.replace(ann, mask=blocked))
                mask = mask & ~blocked
        # Precedence 3 — seeded drop (faulted horizon only; margin
        # steps reconcile fault-free).
        if self.scenario.drop_rate_pct and self.fault_phase:
            u = self.rng.vector("drop", step, ann.seq, self.n_nodes)
            dropped = mask & (u * 100 < self.scenario.drop_rate_pct)
            n_drop = int(dropped.sum())
            if n_drop:
                counter("sim_messages_dropped_total",
                        help="deliveries lost to the drop schedule"
                        ).inc(n_drop)
                if self.record_deliveries:
                    for r in np.nonzero(dropped)[0]:
                        self.bus_log.record("drop", merge=ann.lamport,
                                            step=step, sender=ann.sender,
                                            receiver=int(r),
                                            cause=LOST_DROP,
                                            **self._hdr_info(b))
                mask = mask & ~dropped
        # Adversary interception (eclipse monopolizes a victim's peers).
        for strat in self.strategies:
            mask = strat.filter_delivery(self, step, ann.sender, b, mask)
        if not mask.any():
            return
        self._consume(ann, b, mask)

    def _consume(self, ann: _Announce, b: LightBlock,
                 mask: np.ndarray) -> None:
        """Applies one announcement to its surviving receivers: batched
        tip-extension appends, then grouped fork syncs."""
        step = self.step_count
        n_recv = int(mask.sum())
        self._deliveries += n_recv
        counter("sim_messages_delivered_total",
                help="announcements delivered to a peer").inc(n_recv)
        append = mask & (self.tips == b.prev_idx)
        if append.any():
            idx = np.nonzero(append)[0]
            self.tips[idx] = b.idx
            self.heights[idx] = b.height
            if self.record_deliveries:
                for r in idx:
                    self.log(int(r)).record(
                        "deliver", merge=ann.lamport, step=step,
                        sender=ann.sender, result="appended",
                        **self._hdr_info(b))
        # Keep-first + the live-height sync gate: only receivers whose
        # chain is strictly shorter than the SENDER's current chain can
        # win an adoption (identical to SimNode.receive).
        sender_tip = int(self.tips[ann.sender])
        sender_h = int(self.heights[ann.sender])
        sync = mask & ~append & (self.heights < sender_h)
        if not sync.any():
            return
        # Group the syncing receivers by their current tip: one
        # validation + ancestor walk per distinct fork, applied to the
        # whole group vectorized.
        sync_idx = np.nonzero(sync)[0]
        for tip in np.unique(self.tips[sync_idx]):
            members = sync_idx[self.tips[sync_idx] == tip]
            self._sync_group(ann, [int(m) for m in members], int(tip),
                             sender_tip, sender_h)

    def _sync_group(self, ann: _Announce, members: list[int],
                    tip_idx: int, sender_tip: int, sender_h: int) -> None:
        """The O(suffix) sync for every member sharing ``tip_idx``."""
        step = self.step_count
        anchor_h = self.common_ancestor_height(tip_idx, sender_tip)
        suffix = self.chain_suffix(sender_tip, anchor_h)
        # The anchor block from the RECEIVER's side of the fork (the
        # locator guarantee): linkage is judged against what the
        # receiver already holds, never against the sender's claims.
        anchor = self.blocks[tip_idx]
        while anchor.height > anchor_h:
            anchor = self.blocks[anchor.prev_idx]
        reason = self.validate_suffix(anchor.key, suffix)
        if reason is not None:
            for m in members:
                self.reject_sync(m, ann.sender, len(suffix), reason)
            return
        old_h = int(self.blocks[tip_idx].height)
        rolled_back = old_h - anchor_h
        adopted = sender_h - anchor_h
        old_tip_key = self.blocks[tip_idx].key
        # The rolled-back hash list is O(depth) and duplicated per
        # member: priced into small-world dumps only (the forensics
        # audit degrades gracefully without it).
        extra = ({"rolled_back_hashes":
                  [blk.key for blk in self.chain_suffix(tip_idx,
                                                        anchor_h)]}
                 if self.record_deliveries else {})
        arr = np.array(members, dtype=np.int64)
        self.tips[arr] = sender_tip
        self.heights[arr] = sender_h
        for m in members:
            # ``peer`` (who we adopted from) is what lets the forensics
            # flood audit prove its chains-untouched invariant non-
            # vacuously: an adopt naming a flooder is a breach.
            self.log(m).record("adopt", merge=ann.lamport, step=step,
                               peer=ann.sender, old_tip=old_tip_key,
                               new_tip=self.blocks[sender_tip].key,
                               height=sender_h, anchor=anchor_h,
                               adopted=adopted, rolled_back=rolled_back,
                               **extra)
        if rolled_back:
            self.reorgs[arr] += 1
            self.reorged_away[arr] += rolled_back
            counter("sim_reorgs_total",
                    help="chain reorganizations across all groups"
                    ).inc(len(members))
            histogram("sim_reorg_depth",
                      help="blocks rolled back per reorg"
                      ).observe(rolled_back)

    # ---- churn -----------------------------------------------------------

    def _apply_churn(self) -> None:
        # Fault-plan integration: an armed plan's "sim.churn" site
        # is polled once per step (unarmed cost: one None check). A
        # fired fault crash-restarts a seeded-chosen live node — fault
        # plans compose with the scenario's own churn schedule, and the
        # crash is causally recorded like any scheduled one.
        fault = injection.check("sim.churn", step=self.step_count)
        if fault is not None:
            live = np.nonzero(self.alive)[0]
            if live.size:
                node = int(live[self.rng.draw(
                    "churn", self.step_count, 0xFA, mod=live.size)])
                down = 5 + self.rng.draw("churn", self.step_count, 0xFB,
                                         mod=max(2, self.scenario.steps
                                                 // 10))
                self.alive[node] = False
                up = self.step_count + down
                if up < self.scenario.steps:
                    self._churn_by_step.setdefault(up, []).append(
                        ChurnEvent(step=up, node=node, kind="join"))
                counter("sim_churn_events_total",
                        help="node membership changes "
                             "(crash/leave/join)", kind="crash").inc()
                self.bus_log.record("churn", step=self.step_count,
                                    node=node, action="crash",
                                    injected=True, fault=fault.kind,
                                    height=int(self.heights[node]))
        for e in self._churn_by_step.get(self.step_count, ()):
            was_alive = bool(self.alive[e.node])
            if e.kind in ("crash", "leave"):
                if not was_alive:
                    continue
                self.alive[e.node] = False
            else:                       # join / crash-restart
                if was_alive:
                    continue
                self.alive[e.node] = True
            counter("sim_churn_events_total",
                    help="node membership changes (crash/leave/join)",
                    kind=e.kind).inc()
            self.bus_log.record("churn", step=self.step_count,
                                node=e.node, action=e.kind,
                                height=int(self.heights[e.node]))

    # ---- mining ----------------------------------------------------------

    def _mine(self) -> None:
        # Per-node bits for the NEXT block under the retarget schedule,
        # then the lottery: P(find) = hashes * hashrate / 2^bits.
        next_h = self.heights + 1
        s = self.scenario
        if self.rule.interval:
            bits = (s.difficulty_bits
                    + self.rule.step_bits * (next_h // self.rule.interval))
            cap = max(self.rule.max_bits or 255, s.difficulty_bits)
            bits = np.minimum(bits, cap)
        else:
            bits = np.full(self.n_nodes, s.difficulty_bits, dtype=np.int64)
        p = (s.hashes_per_step * self.hashrate
             / np.exp2(bits.astype(np.float64)))
        u = self.rng.vector("mine", self.step_count, 0, self.n_nodes)
        winners = np.nonzero((u < p) & self.alive)[0]
        for w in winners:
            w = int(w)
            b = self.new_block(int(self.tips[w]), w, self.step_count)
            self.tips[w] = b.idx
            self.heights[w] = b.height
            self.blocks_mined[w] += 1
            counter("sim_vec_blocks_mined_total",
                    help="blocks found by the vectorized mining lottery"
                    ).inc()
            self.log(w).record("mine", step=self.step_count,
                               **self._hdr_info(b))
            publish = True
            for strat in self.strategies:
                publish = strat.on_mined(self, self.step_count, w, b) \
                    and publish
            if publish:
                self.broadcast(w, b.idx)

    # ---- the step loop ---------------------------------------------------

    def step(self) -> None:
        self._apply_churn()
        for strat in self.strategies:
            strat.on_step_begin(self, self.step_count)
        self._deliver_due()
        self._mine()
        for strat in self.strategies:
            strat.on_step_end(self, self.step_count)
        self.step_count += 1
        heartbeat("sim_heartbeat").set(self.step_count)
        self._mirror_gauges()

    def _mirror_gauges(self) -> None:
        live = self.alive.sum()
        gauge("sim_vec_live_nodes",
              help="nodes currently up in the vectorized sim"
              ).set(int(live))
        gauge("sim_vec_height_max",
              help="highest chain height across live nodes").set(
            int(self.heights[self.alive].max()) if live else 0)
        gauge("sim_vec_tips_distinct",
              help="distinct tips across live nodes (1 = converged)").set(
            int(np.unique(self.tips[self.alive]).size) if live else 0)
        gauge("sim_eclipse_victims",
              help="nodes whose peer set is currently monopolized by "
                   "an eclipse attacker").set(
            sum(s.eclipsing() for s in self.strategies))

    def run(self) -> dict:
        for _ in range(self.scenario.steps):
            self.step()
        # Converge margin: fault-free reconciliation (the legacy
        # "partition heals, then the network must converge" epilogue).
        # Mining continues — an equal-height fork at cutoff can only be
        # broken by the next block — but drops and attacks are over:
        # adversaries are told the horizon ended (a selfish miner must
        # release-or-abandon its private fork).
        self.fault_phase = False
        for strat in self.strategies:
            strat.on_horizon_end(self, self.step_count)
        for _ in range(self.scenario.converge_margin):
            if not self._buckets and self.converged():
                break
            self.step()
            self._drain_steps += 1
        # Final drain: deliver everything still in flight (latency
        # tails, partition deferrals), no further mining. Bounded:
        # every re-enqueue targets a finite step.
        while self._buckets:
            self._drain_steps += 1
            # Monotonic: the logical clock never rewinds — _deliver_due
            # pops every bucket at or before it.
            self.step_count = max(self.step_count, min(self._buckets))
            self._deliver_due()
        return self.summary()

    # ---- reporting -------------------------------------------------------

    def converged(self) -> bool:
        if not self.alive.any():
            return False
        return np.unique(self.tips[self.alive]).size == 1

    def canonical_tip(self) -> LightBlock:
        live = np.nonzero(self.alive)[0]
        if not live.size:
            # Everyone down at the end: judge from the last known tips
            # rather than crash the summary of an otherwise-clean run.
            live = np.arange(self.n_nodes)
        best = max(live, key=lambda i: (self.heights[i], -i))
        return self.blocks[int(self.tips[int(best)])]

    def chain_miners(self) -> dict[int, int]:
        """miner id -> blocks on the CANONICAL chain (revenue accounting
        for the selfish-mining audit)."""
        out: dict[int, int] = {}
        b = self.canonical_tip()
        while b.height > 0:
            out[b.miner] = out.get(b.miner, 0) + 1
            b = self.blocks[b.prev_idx]
        return out

    def summary(self) -> dict:
        live = self.alive
        tip = self.canonical_tip()
        return {
            "event": "sim_done",
            "engine": "vec",
            "converged": self.converged(),
            "steps": self.scenario.steps,
            "drain_steps": self._drain_steps,
            "n_nodes": self.n_nodes,
            "live_nodes": int(live.sum()),
            "blocks_total": len(self.blocks) - 1,
            "canonical_height": int(tip.height),
            "canonical_tip": tip.key,
            "final_bits": self.rule.expected_bits(
                self.scenario.difficulty_bits, int(tip.height) + 1),
            "height_min": int(self.heights[live].min()) if live.any()
            else 0,
            "height_max": int(self.heights[live].max()) if live.any()
            else 0,
            "deliveries": self._deliveries,
            "sync_rejections": self._sync_rejections,
            "reorgs": int(self.reorgs.sum()),
            "strategies": {s.name: s.summary() for s in self.strategies},
        }

    # ---- causal export ---------------------------------------------------

    def causal_logs(self) -> list:
        return ([self._logs[k] for k in sorted(self._logs)]
                + [self.bus_log])

    def dump_causal(self, path, meta: dict | None = None):
        base = {"engine": "vec", "steps": self.step_count,
                "converged": self.converged(),
                "n_nodes": self.n_nodes,
                "scenario": self.scenario.to_dict()}
        base.update(meta or {})
        return dump_causal_logs(self.causal_logs(), path, meta=base)


def run_scenario(scenario: Scenario,
                 on_network=None) -> tuple[VecNetwork, dict]:
    """Builds and runs the engine; ``on_network`` (like
    ``run_adversarial``'s hook) sees the engine before the run so a
    failing run's causal logs are still dumpable."""
    net = VecNetwork(scenario)
    if on_network is not None:
        on_network(net)
    return net, net.run()
