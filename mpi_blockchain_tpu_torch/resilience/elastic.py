"""Elastic mesh of the port: rank-death survival. Detect, shrink,
re-stripe, mine on.

The port's copy of the reference's ``resilience/elastic.py``. Without it
every multi-rank world dies with its weakest rank: the mesh aggregator
names a dead rank stale, and nothing evicts it. Three pieces:

* **guarded_collective**: the watchdogged dispatch every elastic
  rendezvous goes through. The collective runs on a pooled daemon worker
  thread under ``MPIBT_COLLECTIVE_TIMEOUT``; exceeding it raises
  ``RankLossSuspected`` instead of hanging the survivor. A wedged worker
  is abandoned with its mesh, and the next call gets a fresh one. The
  ``parallel.collective`` fault site makes a dying rendezvous
  deterministic: every kind surfaces as suspicion.

* **ElasticWorld + ElasticMiner**: the process-per-rank world (one OS
  process a rank, a shared ``--mesh-obs`` directory, no
  ``torch.distributed``: a gloo world's size is fixed at init and cannot
  shrink). Each rank sweeps only its stripe of the nonce space
  (``parallel.mesh.stripe_windows``), each window one launch of the
  CUDA sweep on the card. Before every block the supervisor consults the
  shard directory: a finished rank wrote a final shard, a SIGKILLed one
  could not, and that asymmetry is the death oracle. Confirmed-dead ranks
  (``recommended_action == "evict"``) are evicted and the stripes
  re-striped over the survivors with no gap and no overlap. Membership
  rides the checkpoint sidecar, so ``--resume`` restores the shrunken
  world, not the seed world. The ``mesh.rank_death`` fault site
  hard-exits a seeded-chosen victim (``os._exit``: no final shard,
  exactly like SIGKILL) while every survivor evicts it at the same block
  step, which makes the recovery replay byte for byte (same-seed runs
  write byte-identical causal dumps, the reference's bytes).

* **ElasticMeshBackend**: the in-process flavor, the counterpart of the
  reference's multi-device mesh: one ``CudaBackend`` with ``n_miners``
  logical miners in one process. The build and every search run under
  the guard; on suspicion the backend is rebuilt one miner smaller under
  the ``mesh.rebuild`` retry budget and mining continues. The
  lowest-nonce rule makes the shrunken world mine the same chain.
"""
from __future__ import annotations

import os
import queue
import re
import struct
import threading
import time
import zlib

from ..backend import MinerBackend
from ..config import ConfigError
from ..models.miner import Miner
from ..telemetry import CausalLog, counter, emit_event, gauge
from ..telemetry.causal import dump_causal_logs
from ..telemetry.events import env_number
from . import FaultInjected, RankLossSuspected
from .policy import call_with_retry

#: Watchdog budget for one guarded collective or rendezvous (seconds). A
#: healthy dispatch completes in milliseconds to seconds; a peer death
#: leaves it blocked forever: 60 s is "the mesh is gone", not "the mesh is
#: slow".
DEFAULT_COLLECTIVE_TIMEOUT_S = env_number(
    "MPIBT_COLLECTIVE_TIMEOUT", 60.0, cast=float, minimum=1e-3)

#: Startup grace before a missing rank (expected by world_size, never
#: wrote a shard) becomes evictable. Dead-shard and failed evictions need
#: no grace (a shard existed, the asymmetry is proven), but "missing" at
#: startup usually means "still importing torch", and evicting a
#: late-arriving rank would make it re-overlap stripes the survivors
#: re-covered once it joins.
DEFAULT_MISSING_GRACE_S = env_number(
    "MPIBT_ELASTIC_GRACE", 15.0, cast=float, minimum=0.0)


class _GuardWorker:
    """One long-lived daemon worker ``guarded_collective`` dispatches
    on. Workers are pooled and reused: every search of the in-process
    flavor goes through the guard, so a thread spawn per dispatch would
    sit on the hot path. A worker whose dispatch timed out is abandoned
    (never returned to the pool): it is still parked inside the wedged
    fn, and its eventual reply lands in a queue nobody reads."""

    def __init__(self):
        self.inbox: queue.Queue = queue.Queue(maxsize=1)
        self.thread = threading.Thread(target=self._loop,
                                       name="guarded-collective",
                                       daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            # The idle park between dispatches (the watchdog guards the
            # dispatch, not this daemon worker waiting for work).
            fn, out = self.inbox.get()
            try:
                out.put(("ok", fn()))
            except BaseException as e:   # delivered to the caller
                out.put(("err", e))


_idle_workers: list[_GuardWorker] = []
_idle_lock = threading.Lock()


def guarded_collective(fn, *, site: str = "winner_select",
                       timeout_s: float | None = None):
    """Runs ``fn()``, a collective or rendezvous dispatch, under the
    rank-loss watchdog: the one way elastic code reaches a collective.

    The dispatch runs on a pooled daemon worker thread; if it does not
    return within ``timeout_s`` (``MPIBT_COLLECTIVE_TIMEOUT``), the
    survivor raises ``RankLossSuspected`` instead of blocking forever.
    The abandoned worker stays parked in the dead rendezvous: it is
    daemonic and its mesh is about to be rebuilt, so it leaks nothing the
    process needs. Exceptions from ``fn`` re-raise unchanged. The
    ``parallel.collective`` fault site fires here: every kind surfaces as
    ``RankLossSuspected`` (a hung, raised or damaged rendezvous is the
    same event to the survivor).
    """
    from . import injection

    timeout_s = (DEFAULT_COLLECTIVE_TIMEOUT_S if timeout_s is None
                 else float(timeout_s))
    try:
        fault = injection.check("parallel.collective", collective=site)
    except FaultInjected as e:
        raise RankLossSuspected(
            site, message=f"injected fault in the {site} rendezvous: "
            f"{e}") from e
    if fault is not None:
        raise RankLossSuspected(
            site, message=f"injected {fault.kind} fault damaged the "
            f"{site} rendezvous — treating as peer loss")
    with _idle_lock:
        worker = _idle_workers.pop() if _idle_workers else None
    if worker is None:
        worker = _GuardWorker()
    worker.thread.name = f"guarded-{site}"
    out: queue.Queue = queue.Queue(maxsize=1)
    t0 = time.monotonic()
    try:
        # The wait is a `collective` pipeline segment on the newest
        # dispatch record (stamped with the in-scope block trace), so the
        # per-block critical path prices rendezvous waits apart from
        # device compute: mesh builds and rebuilds happen outside any
        # device window and would otherwise read as gap. It is recorded
        # even when the wait times out: that overhang is the wait worth
        # seeing. The skew_span wraps the whole dispatch (put + wait), so
        # its enter stamp is this rank's arrival at the rendezvous, the
        # quantity the mesh-skew analyzer joins across ranks; a timeout
        # exits the span with ok=False before the suspicion is raised.
        from ..meshprof.spans import skew_span
        from ..meshwatch.pipeline import profiler

        # chained=False: the wait runs concurrently with whatever the
        # record's open stage is; backdating it to the previous stage
        # boundary (the chained default) would stretch it over the whole
        # device window.
        with skew_span(site=site):
            worker.inbox.put((fn, out))
            with profiler().segment_on_last("collective", chained=False):
                kind, value = out.get(timeout=timeout_s)
    except queue.Empty:
        elapsed = time.monotonic() - t0
        counter("collective_timeouts_total",
                help="guarded collectives that exceeded the rank-loss "
                     "watchdog", site=site).inc()
        emit_event({"event": "collective_timeout", "site": site,
                    "elapsed_s": round(elapsed, 3),
                    "timeout_s": timeout_s})
        raise RankLossSuspected(site, elapsed_s=elapsed) from None
    with _idle_lock:
        _idle_workers.append(worker)
    if kind == "err":
        raise value
    return value


# ---- the death oracle ------------------------------------------------------


def confirmed_dead(obs_dir, live, self_rank: int, *,
                   stall_s: float | None = None,
                   heartbeat_stall_s: float | None = None,
                   allow_missing: bool = False,
                   now: float | None = None) -> list[tuple[int, str]]:
    """Ranks among ``live`` the meshwatch shard directory CONFIRMS dead:
    ``recommended_action == "evict"`` (dead-shard stale, failed, or —
    only when ``allow_missing`` — expected-but-absent). A wedged-but-
    alive rank (``no-progress``) reads ``restart``, never ``evict``:
    evicting a rank that later recovers would re-overlap its stripes.
    Returns ``(rank, reason)`` pairs; ``self_rank`` is never returned
    (a rank does not evict itself)."""
    from ..meshwatch.aggregate import rank_status, read_shards

    status = rank_status(read_shards(obs_dir), stall_s=stall_s,
                         heartbeat_stall_s=heartbeat_stall_s, now=now)
    dead: list[tuple[int, str]] = []
    for rank in live:
        if rank == self_rank:
            continue
        info = status["ranks"].get(str(rank))
        if info is None:
            # Beyond every shard's declared world: same as missing.
            if allow_missing:
                dead.append((rank, "missing"))
            continue
        if info.get("recommended_action") != "evict":
            continue
        if info["status"] == "missing" and not allow_missing:
            continue   # startup grace: a late-arriving rank is not dead
        dead.append((rank, info.get("stale_reason") or info["status"]))
    return dead


# ---- the process-per-rank elastic world ------------------------------------


class ElasticWorld:
    """Live-membership supervisor for one rank of a process-per-rank
    elastic world.

    Tracks which ranks are live, evicts confirmed-dead peers (meshwatch
    staleness oracle + the deterministic ``mesh.rank_death`` fault
    site), exposes the re-striped nonce windows, and records every
    membership transition in a Lamport causal log (no wall clock — the
    byte-identical-dump determinism contract, same as the sim bus).
    """

    def __init__(self, world_size: int, rank: int, obs_dir=None, *,
                 stall_s: float | None = None,
                 heartbeat_stall_s: float | None = None,
                 hard_exit=os._exit):
        world_size = int(world_size)
        rank = int(rank)
        if world_size < 1:
            raise ConfigError(f"elastic world_size must be >= 1, "
                              f"got {world_size}")
        if not 0 <= rank < world_size:
            raise ConfigError(f"elastic rank {rank} out of range for "
                              f"world_size {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.obs_dir = obs_dir
        self.live: list[int] = list(range(world_size))
        self.evicted: list[dict] = []
        self.log = CausalLog(rank)
        self._stall_s = stall_s
        self._hb_stall_s = heartbeat_stall_s
        self._started = time.monotonic()
        self._death_draws = 0
        # Ranks killed by fired mesh.rank_death faults — the draw pool
        # for the next victim is the seed world minus this set, NEVER
        # the oracle-mutated self.live (see _victim_for).
        self._death_victims: set[int] = set()
        self._hard_exit = hard_exit
        gauge("mesh_live_ranks",
              help="ranks with a fresh, non-final shard").set(world_size)

    # -- membership --------------------------------------------------------

    @property
    def n_live(self) -> int:
        return len(self.live)

    def index(self) -> int:
        """This rank's dense index among the survivors — the stripe
        slot ``parallel.mesh.stripe_windows`` assigns."""
        return self.live.index(self.rank)

    def stripe_windows(self, batch_size: int, space: int | None = None):
        """This rank's current nonce windows (re-striped over the
        surviving world; union over survivors = the whole space, no gap,
        no overlap). Lazy import: the striping rule lives next to
        ``sharded_local_base`` in parallel/mesh.py so the host and
        device stripings cannot drift."""
        from ..parallel.mesh import NONCE_SPACE, stripe_windows

        return stripe_windows(self.index(), self.n_live, batch_size,
                              NONCE_SPACE if space is None else space)

    def evict(self, rank: int, reason: str, height: int = 0) -> bool:
        """Removes ``rank`` from the live set (idempotent; a rank never
        evicts itself) and re-stripes: emits the ``mesh_shrunk``
        event + causal record, bumps ``mesh_evicted_ranks_total`` and
        re-stamps ``mesh_live_ranks``."""
        rank = int(rank)
        if rank == self.rank or rank not in self.live:
            return False
        self.live.remove(rank)
        self.evicted.append({"rank": rank, "reason": reason,
                             "height": height})
        counter("mesh_evicted_ranks_total",
                help="ranks evicted from the elastic mesh, by reason",
                reason=reason).inc()
        gauge("mesh_live_ranks",
              help="ranks with a fresh, non-final shard").set(self.n_live)
        self.log.record("mesh_shrunk", step=height, evicted=rank,
                        reason=reason, live=list(self.live))
        emit_event({"event": "mesh_shrunk", "rank": self.rank,
                    "evicted": rank, "reason": reason, "height": height,
                    "live": list(self.live)})
        # The chainwatch seam: an eviction is definitive membership
        # damage, so the watchdog fires its ``stale_rank`` incident NOW
        # (with the surviving membership for the bundle) instead of
        # waiting for the next cadence tick to read the ring. Lazy
        # import + flag-check no-op while disarmed/off.
        from .. import chainwatch

        chainwatch.notify_eviction(rank, reason, height=height,
                                   live=self.live)
        return True

    # -- the per-block supervision point -----------------------------------

    def step(self, height: int) -> None:
        """Once per block, BEFORE the sweep: the deterministic
        ``mesh.rank_death`` fault site first (all ranks step in lockstep
        per height, so a seeded victim choice agrees everywhere), then
        the wall-clock staleness oracle. The step is a skew span: every
        rank passes here exactly once per height in the same order, so
        (``block.step``, round) is the cross-PROCESS join key the
        mesh-skew analyzer aligns a process-per-rank world on — the
        rendezvous-equivalent of ``winner_select`` for a world with no
        in-process collective."""
        from ..meshprof.spans import skew_span

        with skew_span(site="block.step"):
            self._check_rank_death(height)
            self._poll_oracle(height)

    def _check_rank_death(self, height: int) -> None:
        from . import injection

        fault = injection.check("mesh.rank_death", height=height,
                                rank=self.rank)
        if fault is None:
            return
        victim = self._victim_for(fault)
        if victim is None:
            return
        if victim == self.rank:
            # Die like SIGKILL: no finally blocks, no final shard — the
            # survivors' oracle (or the shared plan) must notice, which
            # is the point. The injectable seam exists for tests only.
            self.log.record("rank_death", step=height, rank=victim)
            emit_event({"event": "rank_death", "rank": victim,
                        "height": height})
            self._hard_exit(137)
            return
        self.evict(victim, "rank_death", height)

    def _victim_for(self, fault) -> int | None:
        """The rank the fired ``mesh.rank_death`` fault kills: an
        explicit ``message="rank=N"`` wins; otherwise a crc32 draw from
        (plan seed, firing index) over the SEED world minus prior
        rank_death victims, EXCLUDING the lowest such rank — the anchor
        rank owns the chain artifact and the causal dump, and killing
        the observer is a different scenario. The draw deliberately
        ignores oracle evictions (``self.live``): every rank arms the
        same plan and steps this site in lockstep, but wall-clock oracle
        polls land at different instants per rank, so a draw over the
        oracle-mutated live list could pick DIFFERENT victims on
        different ranks — two ranks dying, or a still-live rank being
        evicted while it keeps mining. Drawing a victim the oracle
        already evicted is harmless: ``evict`` is a no-op then."""
        from . import injection

        m = re.search(r"rank=(\d+)", fault.message or "")
        if m:
            victim = int(m.group(1))
            if not (0 <= victim < self.world_size) \
                    or victim in self._death_victims:
                return None
            self._death_victims.add(victim)
            return victim
        candidates = sorted(set(range(self.world_size))
                            - self._death_victims)[1:]
        if not candidates:
            return None
        plan = injection.armed_plan()
        seed = plan.seed if plan is not None else 0
        key = struct.pack("<ii", int(seed), self._death_draws)
        self._death_draws += 1
        victim = candidates[zlib.crc32(b"mesh.rank_death" + key)
                            % len(candidates)]
        self._death_victims.add(victim)
        return victim

    def _poll_oracle(self, height: int) -> None:
        if not self.obs_dir:
            return
        # Startup grace for MISSING ranks: a peer is only evictable for
        # never having written a shard once this rank has itself been up
        # longer than max(stall budget, MPIBT_ELASTIC_GRACE).
        from ..meshwatch.aggregate import DEFAULT_MESH_STALL_S

        stall = (self._stall_s if self._stall_s is not None
                 else DEFAULT_MESH_STALL_S)
        grace_over = (time.monotonic() - self._started) > \
            max(stall, DEFAULT_MISSING_GRACE_S)
        for rank, reason in confirmed_dead(
                self.obs_dir, list(self.live), self.rank,
                stall_s=self._stall_s,
                heartbeat_stall_s=self._hb_stall_s,
                allow_missing=grace_over):
            self.evict(rank, reason, height)

    # -- checkpointed membership -------------------------------------------

    def membership(self) -> dict:
        """The sidecar payload that rides the crash-safe checkpoint
        (utils/checkpoint.save_chain ``mesh=``): enough to restore a
        shrunken world on ``--resume``."""
        return {"world_size": self.world_size, "live": list(self.live),
                "evicted": [dict(e) for e in self.evicted]}

    def restore(self, mesh: dict | None) -> None:
        """Adopts a checkpointed membership (the ``--resume`` path): the
        resumed run starts from the shrunken world, not the seed one."""
        if not mesh:
            return
        try:
            world_size = int(mesh["world_size"])
            live = sorted(int(r) for r in mesh["live"])
        except (KeyError, TypeError, ValueError):
            raise ConfigError(
                f"checkpoint mesh membership is malformed: {mesh!r}"
            ) from None
        if self.rank not in live:
            raise ConfigError(
                f"checkpoint mesh membership evicted this rank "
                f"({self.rank}; live {live}) — a dead rank must not "
                f"resume into stripes the survivors re-covered")
        if not all(0 <= r < world_size for r in live):
            raise ConfigError(f"checkpoint mesh membership out of range: "
                              f"live {live} for world_size {world_size}")
        self.world_size = world_size
        self.live = live
        self.evicted = [dict(e) for e in mesh.get("evicted", [])]
        gauge("mesh_live_ranks",
              help="ranks with a fresh, non-final shard").set(self.n_live)
        self.log.record("membership_restored", live=list(self.live),
                        world_size=world_size)
        emit_event({"event": "membership_restored", "rank": self.rank,
                    "live": list(self.live), "world_size": world_size})

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        return {"world_size": self.world_size, "rank": self.rank,
                "live": list(self.live),
                "evicted": [dict(e) for e in self.evicted],
                "shrunk": bool(self.evicted)}

    def dump_causal(self, path, meta: dict | None = None):
        """Writes this rank's causal log (membership transitions + mined
        blocks) as a forensics-readable dump. Deterministic: records
        carry no wall clock, so same-seed ``mesh.rank_death`` runs are
        byte-identical (the elastic-smoke gate asserts this)."""
        return dump_causal_logs(
            [self.log], path,
            meta={"world_size": self.world_size, "rank": self.rank,
                  **(meta or {})})


class ElasticMiner(Miner):
    """A Miner whose per-candidate sweep covers only this rank's stripe of
    the nonce space, re-striped by its ElasticWorld on every eviction.
    The chain it mines is valid (full proof of work and linkage through
    the C++ Node) but rank-dependent: the world's aggregate sweep per
    template covers the whole space exactly once, which is the throughput
    contract striping exists for."""

    def __init__(self, config, world: ElasticWorld, backend=None,
                 log_fn=None):
        super().__init__(config, backend=backend, log_fn=log_fn)
        self.world = world

    def search_windows(self):
        return self.world.stripe_windows(self.config.batch_size)

    def _begin_block(self, height: int) -> None:
        # One supervision step (fault site, staleness oracle and any
        # resulting re-stripe) before every block's first consumed sweep,
        # so both drivers supervise alike. In the pipelined driver a
        # re-stripe here invalidates the in-flight speculative dispatch
        # (its windows were the dead world's), and the driver discards it
        # and re-dispatches on the shrunken stripes: a dead dispatch's
        # slices are never merged into a re-mined height.
        self.world.step(height)

    def _block_mined(self, rec) -> None:
        # Causal record per block: deterministic fields only (height,
        # nonce, hash prefix), so same-seed dumps stay byte-identical.
        self.world.log.record("mine", step=rec.height, height=rec.height,
                              nonce=rec.nonce, hash=rec.hash[:16])


# ---- the in-process flavor ------------------------------------------------


class ElasticMeshBackend(MinerBackend):
    """A backend that makes an in-process world of logical miners
    survivable: the build and every search (whose epilogue is the
    winner-select) run under ``guarded_collective``; on
    ``RankLossSuspected`` the ``CudaBackend`` is rebuilt one miner smaller
    under the ``mesh.rebuild`` retry budget and the search retries.

    One process writes one shard, so there is no per-miner staleness
    asymmetry to consult here: the watchdog (or the injected
    ``parallel.collective`` fault) is the detector, and the shrink is one
    miner per suspicion, floored at one (past that the suspicion
    re-raises: a one-miner world with a dead miner is a dead run, and rc 2
    beats a silent wedge). Shrinking never changes the mined chain: every
    width sweeps ascending rounds and takes the lowest qualifying nonce,
    so the result does not depend on ``n_miners``.
    """

    def __init__(self, config, timeout_s: float | None = None):
        if config.backend != "cuda" or config.n_miners < 2:
            raise ConfigError(
                f"ElasticMeshBackend needs a cuda config of at least two "
                f"logical miners (backend {config.backend!r}, n_miners "
                f"{config.n_miners})")
        self._config = config
        self._timeout_s = timeout_s
        self.n_live = config.n_miners
        self.evictions: list[dict] = []
        self._backend = guarded_collective(
            lambda: self._rendezvous(self.n_live),
            site="mesh.build", timeout_s=timeout_s)
        # Not mesh_live_ranks: that gauge counts rank processes (the shard
        # oracle's world), and this flavor counts miners inside one
        # process; a combined run would make one number mean two things.
        gauge("mesh_live_devices",
              help="devices in the elastic in-process mesh").set(
            self.n_live)

    def _rendezvous(self, n_live: int):
        """The searcher's construction over ``n_live`` miners: a
        rendezvous (every miner must take part), so callers reach it only
        through ``guarded_collective``."""
        from ..backend import get_backend

        return get_backend("cuda",
                           batch_pow2=self._config.effective_batch_pow2,
                           n_miners=n_live, kernel=self._config.kernel,
                           device=self._config.device)

    @property
    def name(self) -> str:
        return self._backend.name

    def search(self, header80: bytes, difficulty_bits: int,
               start_nonce: int = 0, max_count: int = 1 << 32):
        while True:
            try:
                return guarded_collective(
                    lambda: self._backend.search(
                        header80, difficulty_bits,
                        start_nonce=start_nonce, max_count=max_count),
                    site="winner_select", timeout_s=self._timeout_s)
            except RankLossSuspected as e:
                self._shrink(e)

    def _shrink(self, cause: RankLossSuspected) -> None:
        """Evicts one miner and rebuilds over the survivors under the
        ``mesh.rebuild`` budget; re-raises the suspicion when already down
        to one miner."""
        if self.n_live <= 1:
            raise cause
        old = self.n_live
        self.n_live -= 1
        # The rebuild is itself a guarded rendezvous; transient rebuild
        # failures retry under policy_for("mesh.rebuild")
        # (MPIBT_MESH_REBUILD_RETRIES), then surface as RetryExhausted
        # (CLI rc 2).
        self._backend = call_with_retry(
            lambda: guarded_collective(
                lambda: self._rendezvous(self.n_live),
                site="mesh.rebuild", timeout_s=self._timeout_s),
            site="mesh.rebuild")
        record = {"event": "mesh_shrunk", "from": old, "to": self.n_live,
                  "reason": "suspected", "cause": str(cause)}
        self.evictions.append(record)
        counter("mesh_evicted_ranks_total",
                help="ranks evicted from the elastic mesh, by reason",
                reason="suspected").inc()
        gauge("mesh_live_devices",
              help="devices in the elastic in-process mesh").set(
            self.n_live)
        emit_event(record)

    def summary(self) -> dict:
        return {"n_miners": self._config.n_miners, "n_live": self.n_live,
                "evictions": [dict(e) for e in self.evictions],
                "shrunk": bool(self.evictions)}
