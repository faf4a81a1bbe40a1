"""FaultPlan: the seeded, byte-reproducible fault-injection spec.

A plan is a list of ``FaultSpec`` entries: which injection *site*, which
0-based *call* index at that site, how many consecutive calls (*times*;
-1 = every call from there on), and which fault *kind*:

=========  ===========================================================
``raise``    the call raises ``FaultInjected`` before doing any work
``hang``     the call wedges for ``seconds`` (a real sleep), then raises
             ``FaultTimeout``: the deterministic stand-in for a
             watchdogged hang
``corrupt``  the call completes but its result is damaged (a wrong
             search digest or a fabricated winner, a bitrot byte in a
             written or read checkpoint)
``partial``  the call completes but its result is truncated or lost (a
             suppressed search winner, a torn checkpoint write or read)
=========  ===========================================================

A plan is a pure value (JSON round-trippable), ``FaultPlan.from_seed``
derives one from a seed through crc32 with no global RNG, and the
injection counters reset at arm time, so a faulted run replays exactly.

``SITES`` is the reference's list, in its order and of its length, with
``backend.tpu.dispatch`` renamed ``backend.cuda.dispatch``: a seed derives
the reference's plan up to that one name. The port hooks
``backend.cuda.dispatch``, ``backend.cpu.search``, ``sim.deliver``,
``native.load``, ``checkpoint.write``, ``checkpoint.read``,
``distributed.init``, ``sim.churn``, ``parallel.collective``,
``mesh.rank_death``, ``service.submit`` and ``service.rebuild``: every
site of the list.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import struct
import zlib

from . import FaultPlanError

#: Every hook site, in the reference's order.
SITES = (
    "backend.cuda.dispatch",  # CudaBackend.search, before the launch
    "backend.cpu.search",     # CpuBackend.search, before the C++ sweep
    "sim.deliver",            # Network.deliver_due, per delivery attempt:
    #                           raise/hang crash the sim step, partial
    #                           loses the delivery, corrupt damages the
    #                           header in flight (consensus rejects it)
    "native.load",            # core/build.ensure_built, before the build
    "checkpoint.write",       # utils/checkpoint.save_chain
    "checkpoint.read",        # utils/checkpoint.load_chain
    "distributed.init",       # parallel/distributed.init_distributed
    "sim.churn",              # sim/vecnet.VecNetwork, once per step:
    #                           a fired corrupt/partial fault
    #                           crash-restarts a seeded-chosen live node;
    #                           raise/hang crash the step
    "parallel.collective",    # resilience/elastic.guarded_collective,
    #                           per guarded rendezvous: every kind
    #                           surfaces as RankLossSuspected (a hung,
    #                           raised or damaged collective is the same
    #                           event to the survivor as a lost peer)
    "mesh.rank_death",        # resilience/elastic.ElasticWorld.step,
    #                           once per block: a fired corrupt/partial
    #                           fault hard-exits the seeded-chosen victim
    #                           rank (os._exit, no final shard, like
    #                           SIGKILL) while every survivor evicts it
    #                           at the same step; raise/hang crash the
    #                           step
    "service.submit",         # service/frontdoor.ServiceState.submit,
    #                           per admission attempt: raise/hang retry
    #                           under the service budget and shed typed
    #                           on exhaustion; corrupt rejects the tx
    #                           before the mempool; partial admits it
    #                           but loses the receipt (tx_status finds it)
    "service.rebuild",        # service/frontdoor.TemplateFeed.rebuild,
    #                           per rebuild: raise/hang retry, and on
    #                           exhaustion the previous template serves
    #                           on; corrupt damages the template (the
    #                           block boundary discards it); partial
    #                           embeds only a prefix (the rest stays
    #                           pending)
)

KINDS = ("raise", "hang", "corrupt", "partial")

VERSION = 1


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault: site + call window + kind."""
    site: str
    kind: str
    call: int = 0          # first 0-based call index at the site that faults
    times: int = 1         # consecutive faulted calls; -1 = forever
    seconds: float = 0.05  # hang: simulated wedge before FaultTimeout
    message: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise FaultPlanError(f"unknown fault site {self.site!r}; "
                                 f"known: {list(SITES)}")
        if self.kind not in KINDS:
            raise FaultPlanError(f"unknown fault kind {self.kind!r}; "
                                 f"known: {list(KINDS)}")
        if self.call < 0:
            raise FaultPlanError(f"fault call index must be >= 0, "
                                 f"got {self.call}")
        if self.times < -1 or self.times == 0:
            raise FaultPlanError(f"fault times must be >= 1 or -1 "
                                 f"(forever), got {self.times}")
        if not self.seconds >= 0:   # also rejects NaN
            raise FaultPlanError(f"fault seconds must be >= 0, "
                                 f"got {self.seconds}")

    def matches(self, index: int) -> bool:
        """Does this fault fire on the index-th call at its site?"""
        if index < self.call:
            return False
        return self.times < 0 or index < self.call + self.times


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered set of FaultSpecs + the seed that labels the scenario.

    A ``strict`` plan demands that every fault fires: a run that ends with
    unfired faults fails with ``FaultPlanError`` (CLI rc 3), since the
    injected scenario was not exercised.
    """
    faults: tuple[FaultSpec, ...] = ()
    seed: int = 0
    strict: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        if not isinstance(d, dict):
            raise FaultPlanError(f"fault plan must be a JSON object, "
                                 f"got {type(d).__name__}")
        version = d.get("version", VERSION)
        if version != VERSION:
            raise FaultPlanError(f"unsupported fault-plan version "
                                 f"{version!r} (have {VERSION})")
        raw = d.get("faults", [])
        if not isinstance(raw, list):
            raise FaultPlanError("fault plan 'faults' must be a list")
        faults = []
        known = {f.name for f in dataclasses.fields(FaultSpec)}
        for i, entry in enumerate(raw):
            if not isinstance(entry, dict):
                raise FaultPlanError(f"fault #{i} must be an object")
            unknown = sorted(set(entry) - known)
            if unknown:
                raise FaultPlanError(f"fault #{i} has unknown field(s) "
                                     f"{unknown}; known: {sorted(known)}")
            try:
                faults.append(FaultSpec(**entry))
            except TypeError as e:
                raise FaultPlanError(f"fault #{i}: {e}") from e
        return cls(faults=tuple(faults), seed=int(d.get("seed", 0)),
                   strict=bool(d.get("strict", False)))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "FaultPlan":
        path = pathlib.Path(path)
        try:
            payload = json.loads(path.read_text())
        except OSError as e:
            raise FaultPlanError(f"cannot read fault plan {path}: "
                                 f"{e}") from e
        except json.JSONDecodeError as e:
            raise FaultPlanError(f"fault plan {path} is not valid JSON: "
                                 f"{e}") from e
        return cls.from_dict(payload)

    @classmethod
    def from_seed(cls, seed: int, n_faults: int = 3,
                  sites: tuple[str, ...] = SITES,
                  strict: bool = False) -> "FaultPlan":
        """Derives a pseudo-random plan from a seed, crc32-keyed, so the
        same seed always yields the same plan with no global RNG state."""
        if not sites:
            raise FaultPlanError("from_seed needs at least one site")
        bad = [s for s in sites if s not in SITES]
        if bad:
            raise FaultPlanError(f"unknown fault site(s) {bad}; "
                                 f"known: {list(SITES)}")

        def draw(i: int, tag: int, mod: int) -> int:
            key = struct.pack("<IIi", tag, i, seed)
            return zlib.crc32(key) % mod

        faults = []
        for i in range(max(1, n_faults)):
            kind = KINDS[draw(i, 1, len(KINDS))]
            faults.append(FaultSpec(
                site=sites[draw(i, 0, len(sites))],
                kind=kind,
                call=draw(i, 2, 8),
                times=1 + draw(i, 3, 3),
                # Hangs stay short: the liveness bound is "no hang
                # outlasts its watchdog", not wall-clock realism.
                seconds=0.01 + draw(i, 4, 5) / 100.0))
        return cls(faults=tuple(faults), seed=seed, strict=strict)

    @classmethod
    def parse_arg(cls, value: str) -> "FaultPlan":
        """The CLI form: ``seed:N`` derives from a seed, anything else is
        a JSON plan path."""
        if value.startswith("seed:"):
            raw = value[len("seed:"):]
            try:
                return cls.from_seed(int(raw))
            except ValueError:
                raise FaultPlanError(
                    f"--fault-plan seed:N needs an integer seed, "
                    f"got {raw!r}") from None
        return cls.load(value)

    def to_dict(self) -> dict:
        return {"version": VERSION, "seed": self.seed,
                "strict": self.strict,
                "faults": [dataclasses.asdict(f) for f in self.faults]}

    def match(self, site: str, index: int) -> FaultSpec | None:
        """The first fault that fires on the index-th call at ``site``."""
        for f in self.faults:
            if f.site == site and f.matches(index):
                return f
        return None

    def match_all(self, site: str, index: int
                  ) -> list[tuple[int, FaultSpec]]:
        """Every (plan index, fault) whose window covers this call. The
        injector applies the first but credits all as fired: a spec
        shadowed by an earlier overlapping window (a times=-1 fault at the
        same site) must not make a strict plan unexhaustible."""
        return [(i, f) for i, f in enumerate(self.faults)
                if f.site == site and f.matches(index)]
