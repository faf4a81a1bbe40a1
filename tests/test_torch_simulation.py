"""The port's real-chain simulation bus (``simulation.py``) against the
reference's, on the CPU: the same partition, reorg, drop and byzantine
runs, with exact equality of tips, steps, heights, stats and the causal
dump's bytes (a proof-of-work chain has no tolerance). The port's ``cuda``
backend runs here with ``device="cpu"``, which is its plain PyTorch sweep,
against the reference's TPU backend with the jnp kernel on the CPU."""
import dataclasses

import pytest

from mpi_blockchain_tpu import simulation as ref_sim
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.sim import RetargetRule as RefRetarget
from mpi_blockchain_tpu_torch import core
from mpi_blockchain_tpu_torch.backend import backend_from_config
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig
from mpi_blockchain_tpu_torch.resilience.dispatch import ladder_from_config
from mpi_blockchain_tpu_torch.sim import RetargetRule
from mpi_blockchain_tpu_torch.simulation import (MAX_SYNC_SUFFIX, Network,
                                                 SimNode, locator_heights,
                                                 run_adversarial,
                                                 seeded_drop)

CFG = MinerConfig(difficulty_bits=8, n_blocks=6, backend="cpu")
REF_CFG = RefConfig(difficulty_bits=8, n_blocks=6, backend="cpu")


def _outcome(net, path) -> dict:
    """What a run must reproduce: tips, steps, heights, stats and the
    bytes of its causal dump."""
    net.dump_causal(path, meta={"case": "equality"})
    return {"tips": [n.node.tip_hash for n in net.nodes],
            "steps": net.step_count,
            "heights": [n.node.height for n in net.nodes],
            "stats": [dataclasses.asdict(n.stats) for n in net.nodes],
            "conserved": [n.stats.conserved_height() == n.node.height
                          for n in net.nodes],
            "dump": path.read_bytes()}


# (name, run_adversarial keywords, difficulty, retarget (interval, step, max))
CASES = [
    ("partition", dict(partition_steps=25, target_height=6), 8, None),
    ("drop", dict(partition_steps=15, target_height=5, drop_rate_pct=30,
                  seed=7), 8, None),
    ("drop_conserved", dict(partition_steps=25, target_height=6,
                            drop_rate_pct=20, seed=3), 8, None),
    ("three_groups", dict(partition_steps=15, target_height=4, n_groups=3),
     8, None),
    ("delay", dict(partition_steps=10, target_height=5, delay_steps=3), 8,
     None),
    ("d12", dict(partition_steps=10, target_height=4, nonce_budget=1 << 12),
     12, None),
    ("retarget", dict(partition_steps=10, target_height=6), 8, (3, 1, 10)),
]


@pytest.mark.parametrize("name,kw,bits,rule", CASES,
                         ids=[c[0] for c in CASES])
def test_run_adversarial_matches_the_reference(tmp_path, name, kw, bits,
                                               rule):
    cfg = MinerConfig(difficulty_bits=bits, n_blocks=kw["target_height"],
                      backend="cpu")
    ref_cfg = RefConfig(difficulty_bits=bits, n_blocks=kw["target_height"],
                        backend="cpu")
    port = run_adversarial(config=cfg, retarget=(
        RetargetRule(*rule) if rule else None), **kw)
    ref = ref_sim.run_adversarial(config=ref_cfg, retarget=(
        RefRetarget(*rule) if rule else None), **kw)
    got = _outcome(port, tmp_path / "port.json")
    want = _outcome(ref, tmp_path / "ref.json")
    assert got == want
    assert port.converged() and all(got["conserved"])
    assert all(h >= kw["target_height"] for h in got["heights"])
    if name == "partition":
        # Both groups mined in the partition, so the heal reorged.
        assert all(n.stats.blocks_mined > 0 for n in port.nodes)
        assert sum(n.stats.reorgs for n in port.nodes) >= 1
    if rule is not None:
        for h in range(1, port.nodes[0].node.height + 1):
            f = core.HeaderFields.unpack(port.nodes[0].node.block_header(h))
            assert f.bits == RetargetRule(*rule).expected_bits(bits, h)


def test_cuda_backend_on_the_cpu_matches_the_references_tpu_backend(
        tmp_path):
    """Each group searches through its own ResilientBackend around the
    cuda backend (here its plain sweep, asked for with device="cpu"), as
    the reference's groups search through the TPU backend (here the jnp
    kernel on two virtual CPU devices): the same run, event for event.
    The budget stays well below one expected winner a step, or both
    groups find a block every step and stay in lockstep."""
    kw = dict(partition_steps=6, target_height=3, nonce_budget=1 << 8)
    port_cfg = MinerConfig(difficulty_bits=8, n_blocks=3, backend="cuda",
                           device="cpu", batch_pow2=11, n_miners=2)
    ref_cfg = RefConfig(difficulty_bits=8, n_blocks=3, backend="tpu",
                        kernel="jnp", batch_pow2=11, n_miners=2)
    port = run_adversarial(config=port_cfg, **kw)
    ref = ref_sim.run_adversarial(config=ref_cfg, **kw)
    assert _outcome(port, tmp_path / "p.json") == \
        _outcome(ref, tmp_path / "r.json")
    assert port.converged()
    from mpi_blockchain_tpu_torch.backend.cuda import CudaBackend
    for n in port.nodes:
        assert n.backend.rung == "cuda:torch" and not n.backend.degraded
        active = n.backend.active_backend
        assert isinstance(active, CudaBackend) and active.n_miners == 2
        assert active.effective_kernel == "torch"


def test_cpu_ranks_reaches_the_cpu_backend_and_rung():
    """``cpu_ranks`` overrides the C++ rank count wherever the factory
    builds a cpu backend, raw, wrapped or as the ladder's last rung, and a
    SimNode runs each group as one rank, whatever ``n_miners`` says."""
    cfg = MinerConfig(difficulty_bits=8, n_blocks=2, backend="cpu",
                      n_miners=4)
    assert backend_from_config(cfg).active_backend.n_ranks == 4
    assert backend_from_config(cfg, cpu_ranks=1).active_backend.n_ranks == 1
    assert backend_from_config(cfg, resilient=False,
                               cpu_ranks=1).n_ranks == 1
    cuda_cfg = MinerConfig(difficulty_bits=8, n_blocks=2, backend="cuda",
                           device="cpu", n_miners=3)
    rungs = dict(ladder_from_config(cuda_cfg, cpu_ranks=1))
    assert list(rungs) == ["cuda:torch", "cpu"]
    assert rungs["cpu"]().n_ranks == 1
    assert dict(ladder_from_config(cuda_cfg))["cpu"]().n_ranks == 3
    node = SimNode(0, dataclasses.replace(cfg, n_miners=2))
    assert node.backend.active_backend.n_ranks == 1


def test_no_card_is_a_config_error_unless_the_cpu_is_asked_for(
        monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        SimNode(0, MinerConfig(difficulty_bits=8, backend="cuda"))
    with pytest.raises(ConfigError, match="n_groups"):
        run_adversarial(n_groups=1)


def _make_net(mod, cfg, n_nodes=2, **kw):
    return mod.Network([mod.SimNode(i, cfg) for i in range(n_nodes)], **kw)


@pytest.mark.parametrize("n_nodes,kw,target", [
    (2, {}, 6),
    (4, {"delay_steps": 2}, 5),
    (2, {"drop_fn": lambda step, s, r: r == 1 and step < 10}, 5),
], ids=["two_nodes", "four_nodes_delay", "drop_to_one_node"])
def test_network_run_matches_the_reference(tmp_path, n_nodes, kw, target):
    import mpi_blockchain_tpu_torch.simulation as port_sim
    port = _make_net(port_sim, CFG, n_nodes, **kw)
    ref = _make_net(ref_sim, REF_CFG, n_nodes, **kw)
    port.run(target_height=target, nonce_budget=1 << 8)
    ref.run(target_height=target, nonce_budget=1 << 8)
    assert _outcome(port, tmp_path / "p.json") == \
        _outcome(ref, tmp_path / "r.json")
    assert port.converged()


@pytest.mark.parametrize("tip", [0, 1, 9, 10, 11, 12, 100, 1000, 4096,
                                 123457])
def test_locator_heights_equal_the_reference(tip):
    hs = locator_heights(tip)
    assert hs == ref_sim.locator_heights(tip)
    assert hs[0] == tip and hs[-1] == 0 and hs == sorted(hs, reverse=True)
    dense = min(10, tip)                # step 1 for the last 10 heights
    assert hs[:dense] == list(range(tip, tip - dense, -1))


@pytest.mark.parametrize("step,sender,receiver,seed", [
    (0, 0, 1, 0), (5, 1, 0, 7), (1 << 20, 2, 1, 3), (99, 0, 2, 123)])
@pytest.mark.parametrize("rate", [0, 30, 100])
def test_seeded_drop_equals_the_reference(step, sender, receiver, seed,
                                          rate):
    assert seeded_drop(rate, seed)(step, sender, receiver) == \
        ref_sim.seeded_drop(rate, seed)(step, sender, receiver)


def _mine_one(node) -> bytes:
    hdr = None
    while hdr is None:
        hdr = node.mine_step(1 << 12)
    return hdr


def test_find_anchor_picks_the_highest_common_height():
    cfg = MinerConfig(difficulty_bits=8, n_blocks=4, backend="cpu")
    a, b = SimNode(0, cfg), SimNode(1, cfg)
    for _ in range(2):                  # a shared prefix of 2 blocks
        b.node.receive(_mine_one(a))
    while a.node.height < 4:            # then a forks ahead alone
        a.mine_step(1 << 12)
    locator = [(h, b.node.block_hash(h))
               for h in locator_heights(b.node.height)]
    assert a.find_anchor(locator) == 2
    assert a.find_anchor([(5, b"\x11" * 32), (0, b"\x22" * 32)]) == 0


@pytest.mark.parametrize("forge", ["bad_pow", "orphan"])
def test_byzantine_headers_leave_the_chain_untouched(forge):
    """A well-formed block whose hash misses the difficulty is INVALID; a
    valid-PoW block on an unknown parent cannot substantiate a longer
    chain. Either way the victim's chain stays as it was."""
    net = Network([SimNode(i, CFG) for i in range(2)])
    net.run(target_height=3, nonce_budget=1 << 8)
    victim, peer = net.nodes[1], net.nodes[0]
    h, tip = victim.node.height, victim.node.tip_hash
    if forge == "bad_pow":
        evil = peer.node.make_candidate(b"byzantine")
        nz = 0
        while core.leading_zero_bits(core.header_hash(
                core.set_nonce(evil, nz))) >= CFG.difficulty_bits:
            nz += 1
        assert victim.node.receive(core.set_nonce(evil, nz)) == \
            core.RecvResult.INVALID
    else:
        cand = victim.node.make_candidate(b"orphan")
        fake = cand[:4] + b"\xab" * 32 + cand[36:]
        nonce, _ = core.cpu_search(fake, 0, 1 << 20, CFG.difficulty_bits)
        victim.receive(core.set_nonce(fake, nonce), peer)
    assert victim.node.height == h and victim.node.tip_hash == tip


@pytest.mark.parametrize("backend,device", [("cpu", "cuda"),
                                            ("cuda", "cpu")])
def test_nonce_exhaustion_opens_a_fresh_search_space(backend, device):
    """Past 2^32 with no winner the extra nonce is bumped, so the next
    candidate carries new payload data, as the reference's does; a
    network that cannot mine ends with the reference's error."""
    cfg = MinerConfig(difficulty_bits=64, n_blocks=1, backend=backend,
                      device=device, batch_pow2=8)
    node = SimNode(0, cfg)
    ref = ref_sim.SimNode(0, RefConfig(difficulty_bits=64, n_blocks=1,
                                       backend="cpu"))
    before = node._candidate()
    assert before == ref._candidate()
    node._next_nonce = ref._next_nonce = (1 << 32) - 256
    assert node.mine_step(256) is None and ref.mine_step(256) is None
    assert node._extra_nonce == 1 and node._next_nonce == 0
    assert node._candidate() != before
    assert node._candidate() == ref._candidate()
    net = Network([node, SimNode(1, cfg)])
    with pytest.raises(RuntimeError, match="no convergence") as e:
        net.run(target_height=1, max_steps=5, nonce_budget=1 << 8)
    assert e.value.network is net


def test_flush_delivers_future_due_messages():
    net = Network([SimNode(i, CFG) for i in range(2)], delay_steps=3)
    a, b = net.nodes
    net.broadcast(0, _mine_one(a))
    net.deliver_due()                   # not due yet
    assert b.node.height == 0 and len(net.queue) == 1
    net.deliver_due(horizon=net.delay_steps)
    assert b.node.height == 1 and net.queue == []


def test_stale_announcement_still_syncs_when_the_peer_is_ahead():
    cfg = MinerConfig(difficulty_bits=8, n_blocks=6, backend="cpu")
    a, b, c = (SimNode(i, cfg) for i in range(3))
    while a.node.height < 3:
        a.mine_step(1 << 12)
    while b.node.height < 2:
        b.mine_step(1 << 12)
    b.receive(a.node.block_header(1), a)   # stale, but a is longer
    assert b.node.height == 3 and b.node.tip_hash == a.node.tip_hash
    while c.node.height < 2:
        c.mine_step(1 << 12)
    before = a.stats.headers_fetched
    a.receive(c.node.block_header(2), c)   # c is not longer: no fetch
    assert a.stats.headers_fetched == before and a.node.height == 3


def test_suffix_sync_transfer_is_o_suffix():
    net = Network([SimNode(i, CFG) for i in range(2)])
    net.run(target_height=15, nonce_budget=1 << 8)
    base = sum(n.stats.headers_fetched for n in net.nodes)
    net.partitioned_until = net.step_count + 12
    net.run(target_height=max(n.node.height for n in net.nodes) + 3,
            nonce_budget=1 << 8)
    assert net.converged()
    heal = sum(n.stats.headers_fetched for n in net.nodes) - base
    assert 0 < heal < net.nodes[0].node.height
    assert all(n.stats.conserved_height() == n.node.height
               for n in net.nodes)


def test_sync_budget_is_the_references():
    assert MAX_SYNC_SUFFIX == ref_sim.MAX_SYNC_SUFFIX


# ---- the byzantine bounds, driven by real attackers on the live bus ------


def _live_bus(flood_mode: str, seed: int):
    from mpi_blockchain_tpu_torch.sim.real_attackers import FloodingSimNode
    honest = [SimNode(i, CFG) for i in range(2)]
    flooder = FloodingSimNode(2, CFG, mode=flood_mode, seed=seed)
    net = Network(honest + [flooder])
    for _ in range(40):
        net.step(nonce_budget=1 << 8)
    return net, honest, flooder


@pytest.mark.parametrize("mode,seed", [("budget", 1), ("linkage", 2)])
def test_flood_is_rejected_on_the_live_bus(mode, seed):
    from mpi_blockchain_tpu_torch.telemetry import counter
    before = counter("sim_sync_rejected_total").value
    net, honest, flooder = _live_bus(mode, seed)
    tips = [n.node.tip_hash for n in honest]
    flooder.flood(net)
    net.step(nonce_budget=1 << 8)
    for n, tip in zip(honest, tips):
        rej = [e for e in n.causal.events() if e["kind"] == "sync_rejected"]
        assert rej and mode in rej[-1]["reason"]
        assert n.node.find(tip) >= 0, "the flood rolled a block back"
    assert flooder.floods == 1
    assert counter("sim_sync_rejected_total").value >= before + 2
    net.run(target_height=6, nonce_budget=1 << 8)
    assert net.converged()


def test_eclipsed_node_recovers_after_the_heal_as_the_reference(tmp_path):
    from mpi_blockchain_tpu.sim.real_attackers import \
        eclipse_drop_fn as ref_eclipse
    from mpi_blockchain_tpu_torch.sim.real_attackers import eclipse_drop_fn
    port = Network([SimNode(i, CFG) for i in range(3)],
                   drop_fn=eclipse_drop_fn(victim=2, attacker=1, start=0,
                                           until=25))
    ref = ref_sim.Network([ref_sim.SimNode(i, REF_CFG) for i in range(3)],
                          drop_fn=ref_eclipse(victim=2, attacker=1,
                                              start=0, until=25))
    port.run(target_height=6, nonce_budget=1 << 8)
    ref.run(target_height=6, nonce_budget=1 << 8)
    assert _outcome(port, tmp_path / "p.json") == \
        _outcome(ref, tmp_path / "r.json")
    victim = port.nodes[2]
    assert victim.stats.blocks_mined > 0 and victim.stats.blocks_adopted > 0
