"""The port's blockserve front door against the reference's, on the CPU.

Each case of the reference's ``tests/test_service.py`` (the mempool's
order, capacity, displacement and deadlines; the template feed's rebuilds
under faults; typed sheds, the ``service.submit`` fault matrix and the
heartbeat gate; the live HTTP door; loadgen; the ``serve`` bound) runs on
both packages with the same inputs, and the port must give what the
reference gives: the same outcomes, receipts (``public()`` bodies), shed
bodies, template bytes and counts. Then a seeded sequence of submits
(numpy), the port's serve smoke with its hard assertions, its served
chain replayed through the reference's sequential ``Miner``, and the CLI
(``serve``, ``mine --serve``). Tolerance: exact, these are bytes, counts
and orderings. The reference's three ``mempool_saturation`` rule tests
belong to ``chainwatch`` and wait with it.
"""
import json
import pathlib
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mpi_blockchain_tpu.service as ref_service
import mpi_blockchain_tpu_torch.service as port_service
from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu.backend.cpu import CpuBackend as RefCpuBackend
from mpi_blockchain_tpu.chainwatch import incident as ref_incident
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu.perfwatch import detector as ref_detector
from mpi_blockchain_tpu.perfwatch import history as ref_history
from mpi_blockchain_tpu.perfwatch import server as ref_server
from mpi_blockchain_tpu.resilience import faultplan as ref_faultplan
from mpi_blockchain_tpu.resilience import injection as ref_injection
from mpi_blockchain_tpu.service import loadgen as ref_loadgen
from mpi_blockchain_tpu.service import mempool as ref_mempool
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.backend.cpu import CpuBackend
from mpi_blockchain_tpu_torch.chainwatch import incident
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.perfwatch import detector, history, server
from mpi_blockchain_tpu_torch.resilience import faultplan, injection
from mpi_blockchain_tpu_torch.service import __main__ as port_smoke
from mpi_blockchain_tpu_torch.service import loadgen, mempool

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _quiet(_event):
    return None


REF = types.SimpleNamespace(
    name="ref", service=ref_service, mempool=ref_mempool,
    loadgen=ref_loadgen, telemetry=ref_telemetry, injection=ref_injection,
    faultplan=ref_faultplan, detector=ref_detector, history=ref_history,
    server=ref_server,
    config=lambda **kw: RefConfig(**{"difficulty_bits": 10, "n_blocks": 2,
                                     "backend": "cpu", "seed": 7, **kw}),
    miner=lambda cfg, **kw: RefMiner(cfg, backend=RefCpuBackend(),
                                     log_fn=_quiet, **kw))
PORT = types.SimpleNamespace(
    name="port", service=port_service, mempool=mempool, loadgen=loadgen,
    telemetry=telemetry, injection=injection, faultplan=faultplan,
    detector=detector, history=history, server=server,
    config=lambda **kw: MinerConfig(**{"difficulty_bits": 10,
                                       "n_blocks": 2, "backend": "cpu",
                                       **kw}),
    miner=lambda cfg, **kw: Miner(cfg, backend=CpuBackend(), **kw))


def _reset(pkg) -> None:
    state = pkg.service.active_service()
    while state is not None:
        pkg.service.uninstall_service(state)
        state = pkg.service.active_service()
    pkg.injection.disarm()
    pkg.telemetry.reset()
    pkg.telemetry.clear_events()


@pytest.fixture(autouse=True)
def fresh_state():
    for pkg in (REF, PORT):
        _reset(pkg)
    ref_incident.reset()
    incident.reset()
    yield
    for pkg in (REF, PORT):
        _reset(pkg)
    ref_incident.reset()
    incident.reset()


def _both(case):
    """Runs ``case(pkg)`` on the reference and on the port, each from
    fresh state, asserts the two results equal, and returns the port's."""
    want = case(REF)
    for pkg in (REF, PORT):
        _reset(pkg)
    got = case(PORT)
    assert got == want
    return got


def _plan(pkg, *faults, **kw):
    kw.setdefault("seed", 0)
    return pkg.faultplan.FaultPlan(
        faults=tuple(pkg.faultplan.FaultSpec(**f) for f in faults), **kw)


# ---- mempool: ordering, capacity, eviction ------------------------------


def test_mempool_take_is_fee_ordered_admission_tiebroken():
    def case(pkg):
        pool = pkg.mempool.Mempool(cap=8)
        outcomes = [pool.submit(p, f)[0] for p, f in
                    ((b"a", 5), (b"b", 9), (b"c", 5), (b"d", 1))]
        return (outcomes, [t.payload for t in pool.take(4)],
                [t.payload for t in pool.take(4)],
                [t.payload for t in pool.take(2)])
    got = _both(case)
    assert got[1] == [b"b", b"a", b"c", b"d"] == got[2]
    assert got[3] == [b"b", b"a"]


def test_mempool_capacity_sheds_or_displaces():
    def case(pkg):
        pool = pkg.mempool.Mempool(cap=2)
        _, low = pool.submit(b"low", 1)
        pool.submit(b"mid", 5)
        shed = pool.submit(b"equal", 1)
        depth = pool.depth()
        outcome, rec = pool.submit(b"rich", 9)
        return (shed, depth, outcome, rec.public(), pool.depth(),
                low.public(), pool.status(low.txid).public(),
                pool.evicted_total, [t.payload for t in pool.take(4)])
    got = _both(case)
    assert got[0] == ("shed", None) and got[2] == "accepted"
    assert got[5]["status"] == mempool.EVICTED and got[7] == 1
    assert got[8] == [b"rich", b"mid"]


def test_mempool_duplicate_is_idempotent():
    def case(pkg):
        pool = pkg.mempool.Mempool(cap=4)
        _, first = pool.submit(b"x", 3)
        outcome, rec = pool.submit(b"x", 3)
        return outcome, rec is first, pool.depth(), pool.submitted_total
    assert _both(case) == ("duplicate", True, 1, 1)


def test_mempool_cap_zero_sheds_everything():
    def case(pkg):
        pool = pkg.mempool.Mempool(cap=0)
        return pool.submit(b"any", 100), pool.depth()
    assert _both(case) == (("shed", None), 0)


def test_seeded_submit_sequence_orders_displaces_and_sheds_alike():
    """One seeded sequence of submits (numpy: payloads with repeats, fees,
    deadlines) through a small pool, with takes and inclusions between:
    every outcome, receipt, take and snapshot equal."""
    rng = np.random.default_rng(20261017)
    ops = []
    for i in range(120):
        kind = rng.choice(["submit", "submit", "submit", "take", "include"])
        ops.append((str(kind), int(rng.integers(0, 40)),
                    int(rng.integers(1, 50)), float(rng.integers(5, 60)),
                    float(i), int(rng.integers(1, 6))))

    def case(pkg):
        pool = pkg.mempool.Mempool(cap=4, clock=lambda: 0.0)
        out, taken = [], []
        for kind, p, fee, deadline, now, k in ops:
            if kind == "submit":
                outcome, rec = pool.submit(b"tx-%d" % p, fee,
                                           deadline_s=deadline, now=now)
                out.append((outcome, None if rec is None else rec.public()))
            elif kind == "take":
                taken = pool.take(k, now=now)
                out.append([t.public() for t in taken])
            else:
                out.append(pool.mark_included([t.txid for t in taken[:k]],
                                              height=int(now)))
            out.append(pool.snapshot())
        return out
    got = _both(case)
    outcomes = {o[0] for o in got if isinstance(o, tuple)}
    assert {"accepted", "duplicate", "shed"} <= outcomes
    assert got[-1]["evicted_total"] > 0 and got[-1]["expired_total"] > 0


# ---- deadlines: dropped before the miner, never after -------------------


def test_deadline_enforced_at_take_before_not_after():
    def case(pkg):
        pool = pkg.mempool.Mempool(cap=4, clock=lambda: 0.0)
        _, rec = pool.submit(b"t", 5, deadline_s=1.0, now=0.0)
        before = [t.txid for t in pool.take(4, now=0.5)]
        status_before = rec.status
        after = pool.take(4, now=1.5)
        return (before == [rec.txid], status_before, after, rec.public(),
                pool.expired_total, pool.depth())
    got = _both(case)
    assert got[0] and got[1] == mempool.PENDING and got[2] == []
    assert got[3]["status"] == mempool.EXPIRED
    assert got[3]["reason"] == "deadline" and got[4:] == (1, 0)


def test_inclusion_truth_beats_lapsed_deadline():
    def case(pkg):
        pool = pkg.mempool.Mempool(cap=4)
        _, rec = pool.submit(b"t", 5, deadline_s=0.5, now=0.0)
        pool.take(4, now=2.0)
        expired = rec.status
        return expired, pool.mark_included([rec.txid], height=3), \
            rec.public()
    got = _both(case)
    assert got[:2] == (mempool.EXPIRED, 1)
    assert got[2] == {"txid": mempool.txid_of(b"t"), "fee": 5, "size": 1,
                      "status": mempool.INCLUDED, "height": 3}


# ---- template feed: rebuilds + block-boundary re-validation -------------


def test_template_payload_bytes_equal_the_references():
    txids = [mempool.txid_of(b"tx-%d" % i) for i in range(5)]
    for h in (0, 1, 7, 1000):
        for n in (0, 1, 5):
            assert port_service.template_payload(
                PORT.config(), h, txids[:n]) == ref_service.template_payload(
                REF.config(), h, txids[:n])
        assert port_service.template_payload(PORT.config(), h, ()) == \
            PORT.config().payload(h)
    assert txids == [ref_mempool.txid_of(b"tx-%d" % i) for i in range(5)]


def test_corrupt_rebuild_discarded_at_block_boundary():
    def case(pkg):
        cfg = pkg.config()
        pool = pkg.mempool.Mempool(cap=4)
        feed = pkg.service.TemplateFeed(pool, cfg, max_txs=4)
        _, rec = pool.submit(b"tx", 5)
        pkg.injection.arm(_plan(pkg, {"site": "service.rebuild",
                                      "kind": "corrupt"}))
        landed = feed.rebuild()
        pkg.injection.disarm()
        first = feed.payload_for(1)
        discards = feed.corrupt_discards
        return (landed, first, discards, feed.rebuild(),
                feed.payload_for(2), feed.stats())
    got = _both(case)
    assert got[0] and got[1] == PORT.config().payload(1) and got[2] == 1
    assert mempool.txid_of(b"tx") in got[4].decode()


def test_rebuild_raise_exhaustion_keeps_previous_template():
    def case(pkg):
        cfg = pkg.config()
        pool = pkg.mempool.Mempool(cap=4)
        feed = pkg.service.TemplateFeed(pool, cfg, max_txs=4)
        pool.submit(b"tx-a", 5)
        out = [feed.rebuild(), feed.current()]
        pool.submit(b"tx-b", 9)
        pkg.injection.arm(_plan(pkg, {"site": "service.rebuild",
                                      "kind": "raise", "times": -1}))
        out += [feed.rebuild()]
        pkg.injection.disarm()
        out += [feed.current(), feed.rebuild_failures, feed.rebuild(),
                feed.current()]
        return out
    got = _both(case)
    assert got[0] and not got[2] and got[3] == got[1] and got[4] == 1
    assert len(got[6][0]) == 2


def test_partial_rebuild_keeps_rest_pending():
    def case(pkg):
        cfg = pkg.config()
        pool = pkg.mempool.Mempool(cap=4)
        feed = pkg.service.TemplateFeed(pool, cfg, max_txs=4)
        pool.submit(b"tx-a", 9)
        pool.submit(b"tx-b", 5)
        pkg.injection.arm(_plan(pkg, {"site": "service.rebuild",
                                      "kind": "partial"}))
        landed = feed.rebuild()
        pkg.injection.disarm()
        return landed, feed.current(), pool.depth()
    got = _both(case)
    assert got[1][0] == (mempool.txid_of(b"tx-a"),) and got[2] == 2


def test_note_block_marks_included_and_drops_from_next_template():
    def case(pkg):
        cfg = pkg.config()
        pool = pkg.mempool.Mempool(cap=4)
        feed = pkg.service.TemplateFeed(pool, cfg, max_txs=4)
        _, rec = pool.submit(b"tx", 5)
        feed.rebuild()
        data = feed.payload_for(1)
        feed.note_block(1)
        return data, rec.public(), feed.payload_for(2)
    got = _both(case)
    assert mempool.txid_of(b"tx") in got[0].decode()
    assert got[1]["status"] == mempool.INCLUDED and got[1]["height"] == 1
    assert got[2] == PORT.config().payload(2)


# ---- admission control: typed sheds, gate, fault matrix -----------------


def _state(pkg, **kw):
    miner = kw.pop("miner", None) or pkg.miner(pkg.config())
    kw.setdefault("mempool", pkg.mempool.Mempool(cap=4))
    return pkg.service.ServiceState(miner, **kw)


def test_shed_bodies_are_typed_mempool_full():
    def case(pkg):
        state = _state(pkg, mempool=pkg.mempool.Mempool(cap=0))
        return state.submit(b"tx", 5), state.shed_totals
    (code, body), totals = _both(case)
    assert (code, body["error"], body["shed_reason"]) == \
        (429, "shed", "mempool_full")
    assert body["retry_after_s"] > 0 and totals == {"mempool_full": 1}


def test_shed_bodies_are_typed_queue_depth():
    def case(pkg):
        return _state(pkg, max_inflight=0).submit(b"tx", 5)
    code, body = _both(case)
    assert (code, body["shed_reason"]) == (503, "queue_depth")


def test_submit_fault_matrix():
    def case(pkg):
        state = _state(pkg)
        out = []
        for spec, payload in (
                ({"kind": "raise", "times": -1}, b"tx"),
                ({"kind": "hang", "seconds": 0.01}, b"tx"),
                ({"kind": "corrupt"}, b"tx2"),
                ({"kind": "partial"}, b"tx3")):
            pkg.injection.arm(_plan(pkg, {"site": "service.submit",
                                          **spec}))
            out.append((state.submit(payload, 5), state.mempool.depth()))
            pkg.injection.disarm()
        out.append(state.tx_status(mempool.txid_of(b"tx3")))
        out.append(dict(state.shed_totals))
        return out
    got = _both(case)
    assert (got[0][0][0], got[0][0][1]["shed_reason"], got[0][1]) == \
        (503, "retry_exhausted", 0)
    assert (got[1][0][0], got[1][0][1]["result"]) == (200, "accepted")
    assert (got[2][0][0], got[2][0][1]["shed_reason"], got[2][1]) == \
        (400, "corrupt", 1)
    assert got[3][0] == (200, None)
    assert (got[4][0], got[4][1]["status"]) == (200, mempool.PENDING)


def test_deadline_burned_inside_admission_sheds_typed():
    def case(pkg):
        t = [0.0]

        def clock():
            t[0] += 10.0
            return t[0]
        state = _state(pkg, clock=clock, deadline_s=5.0)
        return state.submit(b"tx", 5), state.mempool.depth()
    (code, body), depth = _both(case)
    assert (code, body["shed_reason"], depth) == (503, "deadline", 0)


def test_heartbeat_gate_flips_and_recovers():
    def case(pkg):
        t = [0.0]
        state = _state(pkg, clock=lambda: t[0], stall_s=1.0)
        out = [state.accept_gate()]
        t[0] = 5.0
        out += [state.accept_gate(), state.submit(b"tx", 5)]
        pkg.telemetry.heartbeat("miner_heartbeat").set(1)
        out += [state.accept_gate(), state.submit(b"tx", 5)[0]]
        return out
    got = _both(case)
    assert got[0] == (True, None) and got[1] == (False, "miner_stalled")
    assert got[2][1]["shed_reason"] == "miner_stalled"
    assert got[3] == (True, None) and got[4] == 200


def test_degraded_stamp_reads_the_ladder_and_the_incident_table():
    """A stepped-down ladder and an open ``stale_rank`` incident mark the
    door's responses degraded, in both packages."""
    from mpi_blockchain_tpu.resilience.dispatch import \
        ResilientBackend as RefResilient
    from mpi_blockchain_tpu_torch.resilience.dispatch import \
        ResilientBackend

    stale = {"rule": "stale_rank", "severity": "critical", "detail": {},
             "heights": [], "incident_seq": 1, "opened_at": 0.0,
             "source": ""}

    def case(pkg):
        miner = pkg.miner(pkg.config())
        out = [_state(pkg, miner=miner).degraded_info()]
        if pkg is REF:
            ref_incident.emit_incident(rule="stale_rank",
                                       severity="critical")
            ladder = RefResilient([("cpu", RefCpuBackend)])
        else:
            incident._state["open"].append(dict(stale))
            ladder = ResilientBackend([("cpu", CpuBackend)])
        out.append(_state(pkg, miner=miner).degraded_info())
        ladder.degradations.append({"to": "cpu"})
        miner.backend = ladder
        out.append(_state(pkg, miner=miner).degraded_info())
        return out
    got = _both(case)
    assert got[0] == {"degraded": False}
    assert got[1] == {"degraded": True, "stale_rank_incidents": 1}
    assert got[2]["degraded_to"] == "cpu"


def test_service_sites_registered_all_kinds_constructible():
    assert faultplan.SITES == tuple(
        s.replace("backend.tpu.", "backend.cuda.")
        for s in ref_faultplan.SITES)
    assert faultplan.KINDS == ref_faultplan.KINDS
    assert "service.submit" in faultplan.SITES
    assert "service.rebuild" in faultplan.SITES
    for site in ("service.submit", "service.rebuild"):
        for kind in faultplan.KINDS:
            faultplan.FaultSpec(site=site, kind=kind)   # no FaultPlanError
    assert json.dumps(faultplan.FaultPlan.from_seed(11).to_dict()) == \
        json.dumps(ref_faultplan.FaultPlan.from_seed(11).to_dict()).replace(
            "backend.tpu.", "backend.cuda.")


# ---- the HTTP door end to end -------------------------------------------


def _post(base, doc, timeout=10):
    req = urllib.request.Request(
        base + "/submit", data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path, timeout=10):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_door_serves_submit_mine_status_chain():
    def case(pkg):
        cfg = pkg.config(difficulty_bits=10, n_blocks=2)
        miner = pkg.miner(cfg)
        pool = pkg.mempool.Mempool(cap=4)
        state = pkg.service.install_service(
            miner, port=0, mempool=pool,
            feed=pkg.service.TemplateFeed(pool, cfg, max_txs=4))
        out = []
        try:
            assert pkg.server.wait_listening("127.0.0.1",
                                             state.server.port)
            base = f"http://127.0.0.1:{state.server.port}"
            code, body = _post(base, {"payload": "tx-hello", "fee": 9})
            tid = body["txid"]
            out += [(code, body), _post(base, {"payload": "tx-hello",
                                               "fee": 9})]
            code, tmpl = _get(base, "/template")
            out.append((code, tmpl))
            miner.mine_chain(cfg.n_blocks)
            out.append(_get(base, f"/tx_status?txid={tid}"))
            out.append(_get(base, f"/chain?n={cfg.n_blocks}"))
            out.append(_get(base, "/tx_status?txid=feed"))
            out.append(_get(base, "/tx_status"))
            code, health = _get(base, "/healthz")
            out.append((code, sorted(health), health["service"]["mempool"]))
            out.append(_post(base, {"fee": 1})[0])
            out.append(_get(base, "/nope")[0])
            out.append(miner.node.tip_hash.hex())
        finally:
            pkg.service.uninstall_service(state)
        out.append((pkg.service.service_stats(),
                    "payload_for" in miner.__dict__))
        return out
    got = _both(case)
    assert got[0][1]["result"] == "accepted"
    assert got[0][1]["txid"] == mempool.txid_of(b"tx-hello")
    assert got[1][1]["result"] == "duplicate"
    assert got[2][1]["txids"] == [got[0][1]["txid"]]
    assert got[2][1]["degraded"] is False
    assert (got[3][0], got[3][1]["status"], got[3][1]["height"]) == \
        (200, mempool.INCLUDED, 1)
    assert got[4][1]["height"] == 2 and len(got[4][1]["blocks"]) == 2
    assert got[4][1]["tip_hash"] == got[10]
    assert (got[5][0], got[5][1]["error"]) == (404, "unknown_txid")
    assert got[6][0] == 400
    assert got[7][2]["included_total"] == 1
    assert got[8] == 400 and got[9] == 404
    assert got[11] == ({}, False)


def test_install_service_binds_seam_and_stats():
    def case(pkg):
        miner = pkg.miner(pkg.config())
        out = [pkg.service.service_stats()]
        state = pkg.service.install_service(miner, port=0)
        try:
            out += [pkg.service.active_service() is state,
                    pkg.service.service_stats(),
                    miner.payload_for == state.feed.payload_for]
        finally:
            pkg.service.uninstall_service(state)
            pkg.service.uninstall_service(state)    # idempotent
        return out
    got = _both(case)
    assert got[0] == {} and got[1] is True and got[3] is True
    assert got[2]["mempool"]["depth"] == 0
    assert got[2]["accept_gate"]["open"] is True
    assert got[2]["degraded"] is False


# ---- loadgen determinism ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1337, 1338, 0xFFFFFFFF, 1 << 33])
def test_loadgen_schedule_equals_the_references(seed):
    a = loadgen.requests_for_seed(seed, 64)
    assert a == ref_loadgen.requests_for_seed(seed, 64)
    assert a == loadgen.requests_for_seed(seed, 64)
    assert a != loadgen.requests_for_seed(seed + 1, 64)
    assert len({r["payload"] for r in a}) == 64
    assert all(1 <= r["fee"] <= 1000 for r in a)
    lat = [float(x) for x in np.random.default_rng(seed % 97).random(37)]
    assert loadgen.p99_ms(lat) == ref_loadgen.p99_ms(lat)
    assert loadgen.p99_ms([]) == ref_loadgen.p99_ms([]) == 0.0


def test_run_load_reports_alike_against_a_live_door():
    """The seeded load against each package's own door, one worker so the
    arrival order is the schedule's: the same report, bar the clocks."""
    def case(pkg):
        cfg = pkg.config()
        pool = pkg.mempool.Mempool(cap=5)
        state = pkg.service.install_service(
            pkg.miner(cfg), port=0, mempool=pool,
            feed=pkg.service.TemplateFeed(pool, cfg, max_txs=3))
        try:
            pkg.telemetry.heartbeat("miner_heartbeat").set(0)
            rep = pkg.loadgen.run_load(state.server.url("/"), seed=7, n=12,
                                       workers=1, mempool_probe=pool.depth)
        finally:
            pkg.service.uninstall_service(state)
        for k in ("wall_s", "requests_per_sec", "p99_latency_ms",
                  "max_latency_ms"):
            rep.pop(k)
        return rep, state.stats()["template"]
    rep, _ = _both(case)
    assert rep["requests"] == 12 and rep["by_outcome"]["shed"] > 0
    assert rep["untyped_sheds"] == 0 and rep["errors"] == 0


# ---- the serve bench section + absolute bound ---------------------------


def test_serve_bench_payload_gated_by_absolute_bound(tmp_path):
    payload = {"backend": "cpu", "difficulty_bits": 12, "n_blocks": 6,
               "requests_per_sec": 500.0, "p99_latency_ms": 12.5,
               "shed_fraction": 0.25, "mempool_depth_max": 8}
    assert detector.SECTION_BOUNDS == ref_detector.SECTION_BOUNDS
    assert detector.SECTION_BOUNDS["serve"] == 2000.0
    for p99 in (12.5, 2000.0, 2500.0):
        cand = {**payload, "p99_latency_ms": p99}
        got = detector.check_candidate(
            history.HistoryStore(tmp_path / "p.jsonl"), "serve", cand)
        want = ref_detector.check_candidate(
            ref_history.HistoryStore(tmp_path / "r.jsonl"), "serve", cand)
        assert got.to_dict() == want.to_dict()
        assert got.render() == want.render()
    assert got.verdict == "regression" and got.key == "serve/cpu/d12/n6"


def test_committed_history_serve_entry_present_and_in_budget():
    store = history.HistoryStore(REPO / history.DEFAULT_HISTORY_NAME)
    serve = store.entries("serve")
    assert serve and [e.to_dict() for e in serve] == [
        e.to_dict() for e in ref_history.HistoryStore(
            REPO / ref_history.DEFAULT_HISTORY_NAME).entries("serve")]
    findings = [f for f in detector.check_history(store)
                if f.section == "serve"]
    assert findings and all(f.verdict != "regression" for f in findings)


# ---- the serve smoke and the served chain -------------------------------


def test_serve_smoke_passes_every_hard_assertion_on_the_cpu():
    history_before = (REPO / history.DEFAULT_HISTORY_NAME).read_bytes()
    got = port_smoke.smoke(device="cpu")
    assert got["ok"] and got["chain_identical"]
    assert got["degraded_to"] == "cpu" and got["faults_fired"] == 2
    assert got["requests"] == port_smoke.SMOKE_BATCH_B
    assert got["included_total"] >= 1 and got["verdict"] == "ok"
    assert got["p99_latency_ms"] < detector.SECTION_BOUNDS["serve"]
    assert got["mempool_depth_max"] <= port_smoke.SMOKE_CAP
    # The smoke's served chain, replayed through the REFERENCE's
    # sequential Miner on its C++ sweep: the same tip.
    hist = {int(h): d.encode() for h, d in got["history"].items()}
    ref = RefMiner(RefConfig(difficulty_bits=port_smoke.SMOKE_DIFFICULTY,
                             n_blocks=port_smoke.SMOKE_BLOCKS,
                             backend="cpu"),
                   backend=RefCpuBackend(), log_fn=_quiet, pipeline=False)
    ref.payload_for = lambda h: hist[h]
    ref.mine_chain()
    assert ref.node.tip_hash.hex() == got["tip_hash"]
    assert any(b"|" in d for d in hist.values())   # templates carried txs
    # Nothing recorded into the repo's history.
    assert (REPO / history.DEFAULT_HISTORY_NAME).read_bytes() == \
        history_before
    assert got["step_downs"] == ["cpu"]


def test_serve_smoke_steps_down_the_cuda_ladder_by_its_plan(monkeypatch):
    """The card's form of the smoke on the CPU: the cuda backend with the
    plain sweep (``cuda:torch`` on the CPU), stepped down to ``cpu`` by
    the plan's ``backend.cuda.dispatch`` faults alone, with every hard
    assertion holding and the plan firing in full."""
    cfg = MinerConfig(difficulty_bits=port_smoke.SMOKE_DIFFICULTY,
                      n_blocks=port_smoke.SMOKE_BLOCKS, backend="cuda",
                      kernel="torch", device="cpu",
                      batch_pow2=port_smoke.SMOKE_BATCH_POW2)
    plan = port_smoke.smoke_plan(cfg)
    assert plan.strict and [f.site for f in plan.faults] == [
        "service.submit", "service.rebuild", "backend.cuda.dispatch"]
    assert [f.site for f in port_smoke.smoke_plan(
        port_smoke.smoke_config("cpu")).faults] == [
        "service.submit", "service.rebuild"]
    monkeypatch.setattr(port_smoke, "smoke_config", lambda device: cfg)
    got = port_smoke.smoke(device="cpu")
    assert got["ok"] and got["chain_identical"] and got["faults_fired"] == 3
    assert got["step_downs"] == ["cpu"]
    assert telemetry.default_registry().total("retries_total") >= 2


def test_serve_smoke_cli_records_only_where_asked(tmp_path, capsys):
    path = tmp_path / "history.jsonl"
    assert port_smoke.main(["smoke", "--device", "cpu", "--record",
                            str(path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (entry,) = history.HistoryStore(path).entries("serve")
    assert entry.key == "serve/cpu/d12/n6" and entry.source == "serve-smoke"
    assert entry.payload["p99_latency_ms"] == out["p99_latency_ms"]


def test_served_chain_under_load_equals_the_no_service_oracle():
    """A served d12/n6 chain on the CPU, pipelined, with submits streaming
    over HTTP while it mines: the chain equals the sequential replay of
    the door's templates through the reference's ``Miner``, and a quiet
    door mines the serviceless chain."""
    cfg = MinerConfig(difficulty_bits=12, n_blocks=6, backend="cpu")
    miner = Miner(cfg, backend=CpuBackend(), pipeline=True)
    pool = mempool.Mempool(cap=8)
    state = port_service.install_service(
        miner, port=0, mempool=pool,
        feed=port_service.TemplateFeed(pool, cfg, max_txs=4))
    try:
        base = state.server.url("/").rstrip("/")
        loadgen.run_load(base, seed=1337, n=6, workers=2)
        streamer = threading.Thread(target=loadgen.run_load,
                                    args=(base, 1338, 12), daemon=True)
        streamer.start()
        miner.mine_chain()
        streamer.join(timeout=60)
        assert not streamer.is_alive()
        recorded = dict(state.feed.history)
    finally:
        port_service.uninstall_service(state)
    ref = RefMiner(RefConfig(difficulty_bits=12, n_blocks=6, backend="cpu"),
                   backend=RefCpuBackend(), log_fn=_quiet, pipeline=False)
    ref.payload_for = lambda h: recorded[h]
    ref.mine_chain()
    assert miner.chain_hashes() == ref.chain_hashes()
    assert pool.snapshot()["included_total"] >= 1

    quiet = Miner(cfg, backend=CpuBackend(), pipeline=True)
    state = port_service.install_service(quiet, port=0)
    try:
        quiet.mine_chain()
    finally:
        port_service.uninstall_service(state)
    plain = RefMiner(RefConfig(difficulty_bits=12, n_blocks=6,
                               backend="cpu"),
                     backend=RefCpuBackend(), log_fn=_quiet)
    plain.mine_chain()
    assert quiet.chain_hashes() == plain.chain_hashes()


# ---- the CLI: serve and mine --serve ------------------------------------


def test_cli_serve_on_the_cpu_mines_the_references_chain(capsys):
    assert main(["serve", "--device", "cpu", "--difficulty", "11",
                 "--blocks", "3", "--port", "0", "--mempool-cap", "4",
                 "--template-txs", "2"]) == 0
    cap = capsys.readouterr()
    started = json.loads(cap.err.strip().splitlines()[0])
    assert started["event"] == "service_started"
    assert "/submit" in started["endpoints"]
    summary = json.loads(cap.out.strip().splitlines()[-1])
    ref = RefMiner(RefConfig(difficulty_bits=11, n_blocks=3, backend="cpu"),
                   backend=RefCpuBackend(), log_fn=_quiet)
    ref.mine_chain()
    assert summary["event"] == "chain_served"
    assert summary["tip_hash"] == ref.node.tip_hash.hex()
    assert summary["service"]["mempool"]["cap"] == 4
    assert port_service.active_service() is None


def test_cli_mine_serve_attaches_the_door_and_refuses_fused(capsys):
    assert main(["mine", "--backend", "cpu", "--difficulty", "10",
                 "--blocks", "2", "--serve", "0"]) == 0
    cap = capsys.readouterr()
    assert "serving chain on http://127.0.0.1:" in cap.err
    summary = json.loads(cap.out.strip().splitlines()[-1])
    assert summary["service"]["accept_gate"]["open"] is True
    assert port_service.active_service() is None
    assert main(["mine", "--device", "cpu", "--fused", "--serve", "0"]) == 2
    assert "--serve needs the per-block miner" in capsys.readouterr().out
    # A door on one rank of a world would feed that rank alone.
    assert main(["mine", "--device", "cpu", "--serve", "0",
                 "--coordinator", "127.0.0.1:1", "--num-processes", "2",
                 "--process-id", "0"]) == 2
    assert "--serve with --coordinator" in capsys.readouterr().out
    assert port_service.active_service() is None


def test_serve_without_a_card_fails_loudly(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for argv in (["serve", "--difficulty", "8", "--blocks", "1"],
                 ["mine", "--serve", "0", "--difficulty", "8", "--blocks",
                  "1"]):
        assert main(argv) == 2
        err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "no CUDA device" in err["error"]
    assert port_smoke.main(["smoke"]) == 2
    assert port_service.active_service() is None
