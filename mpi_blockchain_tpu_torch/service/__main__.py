"""blockserve CLI of the port: the chaos-gated serve smoke and the seeded
load generator.

    python -m mpi_blockchain_tpu_torch.service smoke [--device cpu]
    python -m mpi_blockchain_tpu_torch.service loadgen --url URL

``smoke`` is the port's copy of the reference's serve smoke, one
in-process world:

1. a strict fault plan arms ``service.submit`` (hang) and
   ``service.rebuild`` (raise); both must fire or the run fails;
2. a seeded batch of fee-paying submits hits a live door over HTTP
   before mining (admission under faults), then a second batch streams
   while a pipelined ``Miner`` mines the rebuilt templates, and the
   miner's ``ResilientBackend`` steps down mid-run: on the CPU
   (``--device cpu``) its top rung is the reference's flaky C++ rung,
   which fails every call after the third; on the card the plan also
   raises at ``backend.cuda.dispatch`` for the second block's sweep and
   both its retries, so ``cuda:cuda`` steps down to ``cuda:torch`` (the
   port steps a hand-written kernel's rung down only for an injected
   fault). The door must stamp ``degraded`` and keep serving;
3. the hard assertions: every request answers inside the deadline, every
   non-2xx carries a typed ``shed_reason``, every accepted or
   receipt-lost transaction is status-queryable afterwards (zero
   accepted-then-lost), admission is conserved against the pool's bound,
   and the mined chain is byte-identical to a sequential no-service
   replay of the recorded per-height templates on the C++ sweep;
4. the ``serve`` bench payload (requests/s, p99 latency, shed fraction,
   mempool high-water) is judged against ``SECTION_BOUNDS`` by the
   detector over the repo's ``PERF_HISTORY.jsonl`` (a file of the
   reference package, only read here); ``--record PATH`` appends the
   payload to the history file at PATH.

Like every entry point of the port it runs on the card unless
``--device cpu`` asks for the CPU; with no card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import threading
import urllib.request

from ..backend import MinerBackend

SMOKE_SEED = 1337
SMOKE_DIFFICULTY = 12
SMOKE_BLOCKS = 6
SMOKE_CAP = 8
SMOKE_TEMPLATE_TXS = 4
SMOKE_BATCH_A = 10     # pre-mine: exercises admission + the hang fault
SMOKE_BATCH_B = 16     # streamed while the miner runs
SMOKE_DEADLINE_S = 5.0
#: Log2 of a round of the plain sweep, the card's rung after the
#: step-down (the kernel's early-exit launch covers the whole window).
SMOKE_BATCH_POW2 = 12
#: The card's forced step-down: the launch of the second block's sweep
#: (site call 2: call 0 is the first block's, call 1 the speculative
#: second, which the rebuilt template always discards) and its two
#: retries raise, exhausting the dispatch budget of three attempts.
SMOKE_DISPATCH_FAULT = {"site": "backend.cuda.dispatch", "kind": "raise",
                        "call": 2, "times": 3}


class SmokeError(RuntimeError):
    """The serve smoke failed; ``failures`` lists every broken check."""

    def __init__(self, failures: list[str]):
        super().__init__("; ".join(failures))
        self.failures = failures


class _FlakyRung(MinerBackend):
    """A cpu backend whose searches start failing after ``fail_after``
    calls and never recover: exhausts the dispatch retry budget and forces
    the ladder's mid-run step-down. Until the failure it delegates
    verbatim, so both rungs compute identical sweeps and the chain stays
    byte-identical across the step-down."""

    name = "cpu-flaky"

    def __init__(self, fail_after: int):
        from ..backend.cpu import CpuBackend
        self._inner = CpuBackend()
        self._calls = 0
        self._fail_after = fail_after

    def search(self, header80, difficulty_bits, start_nonce=0,
               max_count=1 << 32):
        self._calls += 1
        if self._calls > self._fail_after:
            raise RuntimeError(f"flaky rung wedged (call {self._calls})")
        return self._inner.search(header80, difficulty_bits,
                                  start_nonce, max_count)


def smoke_config(device: str):
    """The smoke's ``MinerConfig``: the C++ sweep's config on the CPU,
    the CUDA kernel on the card."""
    from ..config import MinerConfig

    if device == "cpu":
        return MinerConfig(difficulty_bits=SMOKE_DIFFICULTY,
                           n_blocks=SMOKE_BLOCKS, backend="cpu")
    return MinerConfig(difficulty_bits=SMOKE_DIFFICULTY,
                       n_blocks=SMOKE_BLOCKS, backend="cuda",
                       kernel="cuda", device=device,
                       batch_pow2=SMOKE_BATCH_POW2)


def smoke_plan(cfg):
    """The smoke's strict fault plan for the config ``cfg``: the cuda
    backend's step-down comes from the plan."""
    from ..resilience.faultplan import FaultPlan, FaultSpec

    faults = [FaultSpec(site="service.submit", kind="hang", call=2,
                        times=1, seconds=0.05),
              FaultSpec(site="service.rebuild", kind="raise", call=0,
                        times=1)]
    if cfg.backend == "cuda":
        faults.append(FaultSpec(**SMOKE_DISPATCH_FAULT))
    return FaultPlan(faults=tuple(faults), seed=SMOKE_SEED, strict=True)


def _smoke_world(cfg):
    """(miner, state): the served world under the ladder that steps
    down."""
    from ..backend import backend_from_config
    from ..backend.cpu import CpuBackend
    from ..models.miner import Miner
    from ..resilience.dispatch import ResilientBackend
    from . import install_service
    from .frontdoor import TemplateFeed
    from .mempool import Mempool

    if cfg.backend == "cpu":
        ladder = ResilientBackend(
            [("cpu-flaky", lambda: _FlakyRung(fail_after=3)),
             ("cpu", CpuBackend)], seed=SMOKE_SEED)
    else:
        ladder = backend_from_config(cfg)
    miner = Miner(cfg, backend=ladder, pipeline=True)
    pool = Mempool(cap=SMOKE_CAP)
    feed = TemplateFeed(pool, cfg, max_txs=SMOKE_TEMPLATE_TXS)
    state = install_service(miner, port=0, mempool=pool, feed=feed,
                            deadline_s=SMOKE_DEADLINE_S)
    return miner, state


def replay_oracle(history: dict, blocks: int, difficulty: int):
    """The sequential no-service oracle: a ``Miner`` on the C++ sweep
    whose payload at each height is the one the served miner recorded."""
    from ..backend.cpu import CpuBackend
    from ..config import MinerConfig
    from ..models.miner import Miner

    oracle = Miner(MinerConfig(difficulty_bits=difficulty, n_blocks=blocks,
                               backend="cpu"),
                   backend=CpuBackend(), pipeline=False)
    oracle.payload_for = lambda h: history[h]
    oracle.mine_chain(blocks)
    return oracle


def smoke(device: str = "cuda") -> dict:
    """Runs the serve smoke on ``device``; returns its result, or raises
    ``SmokeError`` listing every failed check."""
    from ..perfwatch.detector import check_candidate
    from ..perfwatch.history import DEFAULT_HISTORY_NAME, HistoryStore
    from ..perfwatch.server import wait_listening
    from ..resilience import FaultPlanError, injection
    from . import active_service, uninstall_service
    from .loadgen import run_load
    from .mempool import txid_of

    repo_root = pathlib.Path(__file__).resolve().parent.parent.parent
    store = HistoryStore(repo_root / DEFAULT_HISTORY_NAME)
    cfg = smoke_config(device)
    plan = smoke_plan(cfg)
    injection.arm(plan)
    state = None
    failures: list[str] = []
    try:
        miner, state = _smoke_world(cfg)
        base_url = state.server.url("/").rstrip("/")
        if not wait_listening(state.server.host, state.server.port):
            raise SmokeError(["door never started listening"])

        # Phase A: pre-mine admission under faults; the strict hang fires
        # here (call index 2), the rebuild raise fired at bind.
        report_a = run_load(base_url, seed=SMOKE_SEED, n=SMOKE_BATCH_A,
                            workers=2, mempool_probe=state.mempool.depth)

        # Phase B: stream submits while the pipelined miner mines the
        # rebuilt templates and its ladder steps down.
        report_b: dict = {}

        def _stream():
            report_b.update(run_load(
                base_url, seed=SMOKE_SEED + 1, n=SMOKE_BATCH_B,
                workers=2, mempool_probe=state.mempool.depth))

        streamer = threading.Thread(target=_stream, name="serve-stream",
                                    daemon=True)
        streamer.start()
        miner.mine_chain(SMOKE_BLOCKS)
        streamer.join(timeout=60)
        if streamer.is_alive():
            failures.append("loadgen stream never finished (a hung "
                            "request escaped its deadline)")

        for tag, rep, n in (("A", report_a, SMOKE_BATCH_A),
                            ("B", report_b, SMOKE_BATCH_B)):
            if rep.get("untyped_sheds", 1):
                failures.append(f"phase {tag}: non-2xx response without "
                                f"a shed_reason: {rep.get('by_outcome')}")
            if rep.get("errors", 1):
                failures.append(f"phase {tag}: transport errors: "
                                f"{rep.get('by_outcome')}")
            if rep.get("requests") != n:
                failures.append(f"phase {tag}: not every request "
                                f"answered: {rep.get('requests')}")
            if rep.get("max_latency_ms", 1e9) >= SMOKE_DEADLINE_S * 1e3:
                failures.append(f"phase {tag}: request latency "
                                f"{rep.get('max_latency_ms')}ms breached "
                                f"the deadline budget")

        # Zero accepted-then-lost: every admitted tx answers through the
        # live door; a receipt-lost tx (the partial fault) carried no
        # txid over the wire, so it is recomputed from its payload.
        lost = []
        for rep in (report_a, report_b):
            for txid in rep.get("accepted_txids", []):
                with urllib.request.urlopen(
                        f"{base_url}/tx_status?txid={txid}",
                        timeout=5) as resp:
                    if resp.status != 200:
                        lost.append(txid)
            for res_payload in rep.get("receipt_lost_payloads", []):
                tid = txid_of(res_payload.encode())
                code, _ = state.tx_status(tid)
                if code != 200:
                    lost.append(tid)
        if lost:
            failures.append(f"accepted-then-lost txids: {lost}")

        # Admission conservation: 10 unique submits into a cap-8 pool
        # displace or shed at least 2.
        snap = state.mempool.snapshot()
        displaced = (sum(report_a.get("shed_reasons", {}).values())
                     + snap["evicted_total"])
        if displaced < SMOKE_BATCH_A - SMOKE_CAP:
            failures.append(f"admission conservation broke: {displaced} "
                            f"displaced/shed for {SMOKE_BATCH_A} submits "
                            f"into cap {SMOKE_CAP}: {snap}")
        if snap["included_total"] < 1:
            failures.append(f"no submitted tx was ever mined into a "
                            f"template: {snap}")

        # The forced step-down: degraded stamp, reads stay up.
        if not miner.backend.degraded:
            failures.append("the ladder never stepped down")
        tmpl = state.template_view()
        if not tmpl.get("degraded"):
            failures.append(f"template response missing the degraded "
                            f"stamp: {tmpl}")
        chain = state.chain_view(n=SMOKE_BLOCKS)
        if chain["height"] != SMOKE_BLOCKS:
            failures.append(f"served chain height {chain['height']} != "
                            f"{SMOKE_BLOCKS}")

        history = dict(state.feed.history)
        oracle = replay_oracle(history, SMOKE_BLOCKS, SMOKE_DIFFICULTY)
        chain_identical = oracle.chain_hashes() == miner.chain_hashes()
        if not chain_identical:
            failures.append("served chain diverged from the sequential "
                            "no-service oracle")

        try:
            injection.disarm(strict=True)
        except FaultPlanError as e:
            failures.append(str(e))

        payload = {
            "backend": "cpu" if device == "cpu" else "cuda",
            "difficulty_bits": SMOKE_DIFFICULTY,
            "n_blocks": SMOKE_BLOCKS,
            "requests": report_b.get("requests", 0),
            "requests_per_sec": report_b.get("requests_per_sec", 0.0),
            "p99_latency_ms": report_b.get("p99_latency_ms", 0.0),
            "shed_fraction": report_b.get("shed_fraction", 0.0),
            "mempool_depth_max": max(
                report_a.get("mempool_depth_max", 0),
                report_b.get("mempool_depth_max", 0)),
            "mempool_cap": SMOKE_CAP,
            "included_total": snap["included_total"],
            "chain_identical": chain_identical,
        }
        finding = check_candidate(store, "serve", payload)
        if finding.verdict == "regression":
            failures.append(f"serve bench over budget: "
                            f"{finding.render()}")
        if failures:
            raise SmokeError(failures)
        return {"event": "serve_smoke", "ok": True,
                "faults_fired": len(plan.faults),
                "degraded_to": miner.backend.rung,
                "step_downs": [d["to"] for d in miner.backend.degradations],
                "sheds": dict(state.shed_totals),
                "verdict": finding.verdict,
                "history": {h: d.decode() for h, d in history.items()},
                "tip_hash": miner.node.tip_hash.hex(),
                **payload}
    finally:
        injection.disarm()
        if state is not None and active_service() is state:
            uninstall_service(state)


def cmd_smoke(args) -> int:
    from ..config import ConfigError
    from ..perfwatch.history import HistoryStore

    try:
        result = smoke(device=args.device)
    except SmokeError as e:
        for f in e.failures:
            print(f"serve-smoke: {f}", file=sys.stderr)
        return 1
    except ConfigError as e:
        print(json.dumps({"event": "error", "error": str(e)},
                         sort_keys=True))
        return 2
    result.pop("history")
    if args.record:
        keys = ("backend", "difficulty_bits", "n_blocks", "requests",
                "requests_per_sec", "p99_latency_ms", "shed_fraction",
                "mempool_depth_max", "mempool_cap", "included_total",
                "chain_identical")
        HistoryStore(args.record).record(
            "serve", {k: result[k] for k in keys}, source="serve-smoke")
    print(json.dumps(result, sort_keys=True))
    return 0


def cmd_loadgen(args) -> int:
    from .loadgen import run_load

    report = run_load(args.url, seed=args.seed, n=args.requests,
                      workers=args.workers)
    report.pop("accepted_txids", None)
    print(json.dumps(report, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    from ..config import DEVICES

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.service",
        description="blockserve front door: chaos-gated serve smoke + "
                    "seeded load generator")
    sub = parser.add_subparsers(dest="command", required=True)

    p_smoke = sub.add_parser(
        "smoke", help="faulted, degraded, oracle-checked serving")
    p_smoke.add_argument("--device", choices=DEVICES, default="cuda",
                         help="torch device of the miner (default cuda; "
                              "cpu runs the reference's flaky C++ rung)")
    p_smoke.add_argument("--record", metavar="PATH", default=None,
                         help="append the serve bench payload to the "
                              "history file PATH on success")
    p_smoke.set_defaults(fn=cmd_smoke)

    p_load = sub.add_parser("loadgen", help="drive a seeded submit load "
                                            "at a live door")
    p_load.add_argument("--url", required=True,
                        help="door base URL, e.g. http://127.0.0.1:9100")
    p_load.add_argument("--seed", type=int, default=0)
    p_load.add_argument("--requests", type=int, default=32)
    p_load.add_argument("--workers", type=int, default=2)
    p_load.set_defaults(fn=cmd_loadgen)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
