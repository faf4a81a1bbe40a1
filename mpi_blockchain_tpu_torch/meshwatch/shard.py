"""Per-rank telemetry shard writer.

The port's copy of the reference's ``meshwatch/shard.py``: the same
payload keys, ``SHARD_VERSION``, tails and interval, so either package's
aggregator reads the other's shards. One rank = one JSON file in a shared directory (``rank_0003.json``),
rewritten atomically (tmp + ``os.replace`` — a reader never sees a torn
shard) by a daemon flusher thread every ``MPIBT_MESH_OBS_INTERVAL``
seconds (default 1.0) and once more at close. The shard carries:

* identity: ``rank``, ``world_size``, ``pid``, a per-rank write ``seq``;
* ``written_at`` (wall clock) — shard age is the liveness signal the
  aggregator compares against the stall budget;
* ``final`` — True only on the exit write, with ``exit_status`` (the
  CLI's return code, or "error" for an uncaught exception) alongside.
  A rank that exits says goodbye — and HOW it exited travels with the
  goodbye, so a clean rc-0 rank reads ``finished`` while an rc-2 one
  reads ``failed``. A SIGKILL'd rank cannot say goodbye at all, so its
  last shard stays non-final and ages — that asymmetry is how
  ``mesh_health`` tells "done" from "dead" without any coordinator.
  Failure paths that keep the process alive use ``abort()`` (stop the
  flusher, NO final write) so the frozen shard ages into staleness
  instead of being refreshed forever;
* ``heartbeats`` — every ``*_heartbeat`` gauge's value + age at write;
* ``registry`` — the full registry snapshot (counters summed by the
  aggregator, gauges/histograms kept per-rank);
* ``events_tail`` / ``causal_tail`` — bounded tails of the event ring
  and of any flight-recorder-registered network's causal logs;
* ``pipeline`` — the dispatch pipeline profiler's record tail
  (``meshwatch report --dir`` reads these);
* ``skew_spans`` — the newest rendezvous skew spans (``meshprof``: the
  mesh-skew analyzer joins them across shards on (site, round));
* ``memory`` — per-device memory watermarks (``cuda:0`` on ranks that
  mine on the card, ``{}`` on ranks that never initialized CUDA; sampled
  on the flusher thread without initializing or synchronizing the card);
* ``incidents`` — the rank's open chainwatch incidents (empty while
  the watchdog is disarmed); the flush tick is also one of chainwatch's
  two rule-evaluation cadences;
* ``compiles`` — the rank's dispatchwatch compile snapshot (per-site
  census + event tail; ``{}`` on ranks that never observed a compile),
  so divergent per-rank compile counts surface in ``mesh_health``
  before the desync hang they precede;
* ``service`` — the rank's blockserve door stats (mempool depth, shed
  totals, accept-gate state; ``{}`` on serviceless ranks), so the mesh
  ``/healthz`` can show saturation and closed doors per rank.

Wall-clock timestamps are deliberate here (unlike the causal logs):
staleness is a wall-clock question, and shards never participate in the
byte-identical-dump determinism contract.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import tempfile
import threading
import time

from ..telemetry import default_registry, heartbeat_snapshot, set_mesh_rank
from ..telemetry.events import env_number, recent_with_seq

SHARD_VERSION = 1
SHARD_PREFIX = "rank_"
SHARD_GLOB = SHARD_PREFIX + "*.json"

#: Background flush cadence (seconds). Cheap: one snapshot + one small
#: file write per tick.
DEFAULT_INTERVAL_S = env_number("MPIBT_MESH_OBS_INTERVAL", 1.0, cast=float,
                                minimum=1e-2)

EVENTS_TAIL_N = 64     # newest event-ring records carried per shard
CAUSAL_TAIL_N = 64     # newest causal records per sim node
PIPELINE_TAIL_N = 512  # newest pipeline dispatch records


def shard_path(directory, rank: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"{SHARD_PREFIX}{int(rank):04d}.json"


class ShardWriter:
    """Writes this process's telemetry shard; start() arms the flusher."""

    def __init__(self, directory, rank: int = 0, world_size: int = 1,
                 interval_s: float | None = None, registry=None):
        self.directory = pathlib.Path(directory)
        self.rank = int(rank)
        self.world_size = max(int(world_size), 1)
        self.interval_s = float(interval_s if interval_s is not None
                                else DEFAULT_INTERVAL_S)
        self._registry = registry
        self._seq = 0
        self._started_at = time.time()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Guards _seq: payload() runs from both the flusher thread and
        # the closing caller.
        self._lock = threading.Lock()

    @property
    def path(self) -> pathlib.Path:
        return shard_path(self.directory, self.rank)

    # ---- payload ---------------------------------------------------------

    def _causal_tails(self) -> dict:
        """Causal-log tails of every flight-recorder-registered network
        (sim runs); {} when none is registered (mine/bench runs)."""
        from ..telemetry import flight_recorder

        tails: dict = {}
        for net in flight_recorder.registered_networks():
            try:
                logs = net.causal_logs()
            except (AttributeError, RuntimeError):
                continue    # a half-built network must not kill a flush
            for log in logs:
                tails[str(log.node_id)] = log.events()[-CAUSAL_TAIL_N:]
        return tails

    def payload(self, final: bool = False,
                status: int | str | None = None) -> dict:
        reg = (self._registry if self._registry is not None
               else default_registry())
        beats = heartbeat_snapshot(reg)
        with self._lock:
            self._seq += 1
            seq = self._seq
        from ..chainwatch import evaluate as chainwatch_evaluate
        from ..chainwatch import open_incidents
        from ..dispatchwatch import compile_snapshot
        from ..meshprof.memory import memory_snapshot
        from ..meshprof.spans import SKEW_TAIL_N, spans_tail
        from ..service import service_stats
        from .pipeline import profiler

        # The shard-flush tick is one of chainwatch's two sanctioned
        # evaluation cadences (the other: observe_block_metrics). This
        # runs on the flusher daemon thread — off the mining hot path —
        # so the full rule sweep is forced, no throttle. Disarmed/off
        # processes pay a flag check.
        chainwatch_evaluate(source="flush", force=True)
        return {
            "version": SHARD_VERSION,
            "rank": self.rank,
            "world_size": self.world_size,
            "pid": os.getpid(),
            "seq": seq,
            "final": bool(final),
            # Only meaningful on the final write: 0/None reads as
            # `finished`, anything else as `failed` (aggregate.py).
            "exit_status": status if final else None,
            "written_at": time.time(),
            # When this rank started: lets the aggregator flag a rank
            # that never produced a heartbeat (wedged before its first
            # unit of work) once the progress budget elapses.
            "started_at": self._started_at,
            "heartbeats": beats,
            "registry": reg.snapshot(),
            "events_tail": [
                {"seq": s, **r}
                for s, r in recent_with_seq(n=EVENTS_TAIL_N)],
            "causal_tail": self._causal_tails(),
            "pipeline": profiler().records(tail=PIPELINE_TAIL_N),
            # Rendezvous skew spans + device-memory watermarks (the
            # meshprof carriage: the mesh-skew analyzer joins the spans
            # across shards on (site, round); memory stays {} on ranks
            # that never initialized CUDA).
            "skew_spans": spans_tail(SKEW_TAIL_N),
            "memory": memory_snapshot(),
            # Open chainwatch incidents ride the shard (same carriage
            # model as skew_spans/memory: [] while disarmed) so the
            # aggregator's /healthz and /incidents views see them.
            "incidents": open_incidents(),
            # Dispatchwatch compile census rides the same carriage ({}
            # on cold-backend ranks) so mesh_health can flag divergent
            # per-rank compile counts before the desync hang.
            "compiles": compile_snapshot(),
            # Blockserve door stats ({} on serviceless ranks): mempool
            # depth, shed totals and accept-gate state ride to the mesh
            # aggregator's /healthz `service` view.
            "service": service_stats(),
        }

    # ---- writing ---------------------------------------------------------

    def write(self, final: bool = False,
              status: int | str | None = None) -> pathlib.Path:
        """One atomic shard write: tmp in the same directory + replace."""
        self.directory.mkdir(parents=True, exist_ok=True)
        data = json.dumps(self.payload(final=final, status=status),
                          sort_keys=True, default=str)
        fd, tmp = tempfile.mkstemp(prefix=f".{SHARD_PREFIX}{self.rank}-",
                                   suffix=".tmp", dir=str(self.directory))
        try:
            with os.fdopen(fd, "w") as f:
                f.write(data)
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        return self.path

    def start(self) -> pathlib.Path:
        """First write (so the shard exists before any work) + flusher."""
        set_mesh_rank(self.rank)
        path = self.write()
        self._thread = threading.Thread(
            target=self._loop, name=f"meshwatch-shard-{self.rank}",
            daemon=True)
        self._thread.start()
        return path

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write()
            except OSError:
                # A transient FS error must not kill the flusher; the
                # next tick retries (a persistently failing shard just
                # reads as stale mesh-side, which is the right signal).
                pass

    def rebind(self, rank: int, world_size: int | None = None) -> None:
        """Re-stamp this writer's rank identity and move to the new
        shard path. Called after ``init_distributed`` joins the world:
        the CLI arms the writer before the world exists, under the rank
        ``--process-id`` or ``MPIBT_MESH_RANK`` named, and the rank the
        world was joined as is the one the shard must carry.
        The abandoned file is NOT deleted: on shared storage it may be
        the legitimate shard of whichever rank actually resolves to the
        old id, and that rank's flusher overwrites it anyway."""
        rank = int(rank)
        if world_size is not None:
            self.world_size = max(int(world_size), 1)
        if rank != self.rank:
            self.rank = rank
        set_mesh_rank(rank)
        # A flusher tick racing this mutation can write one transitional
        # shard; the next tick (and this write) correct it. Same
        # tolerance as the flusher loop: a transient FS error here must
        # not kill the run (this is called inside distributed init).
        try:
            self.write()
        except OSError:
            pass

    def close(self, status: int | str | None = None) -> None:
        """Stop the flusher and write the ``final`` shard, carrying the
        exit status (0/None = finished, anything else = failed) so a
        rank that exited BADLY never reads as cleanly done. Idempotent."""
        self._stop_flusher()
        try:
            self.write(final=True, status=status)
        except OSError:
            pass

    def abort(self) -> None:
        """Stop the flusher WITHOUT a final write. For failure paths in
        long-lived processes: the shard freezes at its last refresh and
        ages past the stall budget — the failed rank reads ``stale``,
        which is the truth. (A dying process can just not call close();
        this exists for callers that stay alive after the failure.)"""
        self._stop_flusher()

    def _stop_flusher(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---- the process-default writer (CLI arming point) ------------------------

_writer: ShardWriter | None = None


def install(directory, rank: int = 0, world_size: int = 1,
            interval_s: float | None = None) -> ShardWriter:
    """Arms the process shard writer (replacing any previous one). On a
    failed first write nothing stays armed — a later ``rebind_installed``
    / ``uninstall`` must not trip over a writer that never worked."""
    global _writer
    if _writer is not None:
        _writer.close()
        _writer = None
    writer = ShardWriter(directory, rank=rank, world_size=world_size,
                         interval_s=interval_s)
    writer.start()
    _writer = writer
    return writer


def installed() -> ShardWriter | None:
    return _writer


def rebind_installed(rank: int, world_size: int | None = None) -> None:
    """Re-stamp the installed writer's rank (no-op when none is armed).
    ``parallel/distributed.py`` calls this right after the gloo world
    is joined, so shard files carry the real process index even when the
    launcher could not know it."""
    if _writer is not None:
        _writer.rebind(rank, world_size)


def uninstall(status: int | str | None = None) -> None:
    """Final flush (stamped with the run's exit status) + disarm — every
    CLI exit path calls this."""
    global _writer
    if _writer is not None:
        _writer.close(status=status)
        _writer = None
