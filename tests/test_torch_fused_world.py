"""The port's fused k-block miner as one rank of a world of processes
(``mine --fused --coordinator``, ``FusedMiner(..., group=)``), on the CPU,
against the reference.

Two ranks over gloo mine the reference's chains byte for byte: the
reference's single-process ``Miner`` (the oracle of
``tests/test_distributed.py``), the reference's in-process ``FusedMiner``
over a 2-device mesh (jnp), and the port's per-block world. A chain whose
winner lies in rank 1's slice of its round, and a block with no qualifier
below the fused cap (recovered through the staged exhaustion of
``tests/test_exhaustion.py``), keep every rank on the oracle's chain.
Exact.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from mpi_blockchain_tpu.backend import get_backend as ref_get_backend
from mpi_blockchain_tpu.config import MinerConfig as RefConfig
from mpi_blockchain_tpu.models.fused import FusedMiner as RefFusedMiner
from mpi_blockchain_tpu.models.miner import Miner as RefMiner
from mpi_blockchain_tpu.parallel.mesh import make_miner_mesh
from mpi_blockchain_tpu_torch import core
from test_exhaustion import ExhaustFirstSpace
from test_torch_fused import _rollover_prefix

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
#: The chain of ``test_torch_parallel``'s gloo world: difficulty 11, 4
#: blocks, 2^9 nonces a rank's slice.
D, N, B = 11, 4, 9


def _quiet(_record: dict) -> None:
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))


def _world(argvs: list[list[str]], timeout: float = 180.0):
    """Runs one process per argv (rank = position); returns each one's
    (rc, stdout, stderr)."""
    procs = [subprocess.Popen([sys.executable, *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(), cwd=str(REPO))
             for argv in argvs]
    try:
        got = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, got)]


def _mine_world(flags: list[str], out: pathlib.Path):
    port = _free_port()
    return _world([["-m", "mpi_blockchain_tpu_torch", "mine", "--device",
                    "cpu", *flags, "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(rank)]
                   + (["--out", str(out)] if rank == 0 else [])
                   for rank in range(2)])


def _block_records(stderr: str) -> list[dict]:
    return [json.loads(ln) for ln in stderr.splitlines()
            if '"block_mined"' in ln]


def _ref_oracle(n_blocks: int, prefix: str = "block") -> RefMiner:
    """The reference's single-process Miner on its C++ sweep."""
    ref = RefMiner(RefConfig(difficulty_bits=D, n_blocks=n_blocks,
                             backend="cpu", data_prefix=prefix),
                   log_fn=_quiet)
    ref.mine_chain()
    return ref


def test_two_rank_fused_world_saves_the_references_chain(tmp_path):
    fused_out, block_out = tmp_path / "fused.bin", tmp_path / "block.bin"
    chain = ["--difficulty", str(D), "--blocks", str(N), "--batch-pow2",
             str(B)]
    fused = _mine_world([*chain, "--fused", "--blocks-per-call", "2"],
                        fused_out)
    per_block = _mine_world(chain, block_out)
    for rc, _, err in fused + per_block:
        assert rc == 0, err[-2000:]
    oracle = _ref_oracle(N)
    ref_fused = RefFusedMiner(
        RefConfig(difficulty_bits=D, n_blocks=N, backend="tpu", kernel="jnp",
                  n_miners=2, batch_pow2=B),
        blocks_per_call=2, mesh=make_miner_mesh(2), log_fn=_quiet)
    ref_fused.mine_chain()
    want = oracle.node.save()
    assert fused_out.read_bytes() == want
    assert ref_fused.node.save() == want
    assert block_out.read_bytes() == want
    (_, out0, err0), (_, out1, err1) = fused
    summary = json.loads(out0.strip().splitlines()[-1])
    tip = oracle.node.tip_hash.hex()
    assert summary["tip_hash"] == tip and summary["fused"] is True
    assert summary["config"]["n_miners"] == 2 and summary["height"] == N
    assert out1.strip() == ""                  # rank 1 stays silent
    for err in (err0, err1):
        blocks = _block_records(err)
        assert [b["height"] for b in blocks] == list(range(1, N + 1))
        assert blocks[-1]["hash"] == tip
        assert [b["nonce"] for b in blocks] == [r.nonce
                                                for r in oracle.records]


# ---- FusedMiner(group=) in processes the test starts ------------------------

_RANK = """
import json, os, sys
import torch.distributed as dist
from mpi_blockchain_tpu_torch import core
from mpi_blockchain_tpu_torch.backend import SearchResult, backend_from_config
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.models.fused import FusedMiner, make_fused_miner

rank, port, spec = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
group = dist.group.WORLD
cfg = MinerConfig(difficulty_bits=spec["d"], n_blocks=spec["n"],
                  batch_pow2=spec["b"], n_miners=2, device="cpu",
                  data_prefix=spec["prefix"])


class ExhaustFirstSpace:
    # tests/test_exhaustion.py's stub, over the world's own search: every
    # base-payload space reads empty, extended ones are searched.
    name = "exhaust-first-space"

    def __init__(self, inner):
        self.inner = inner

    def search(self, header80, difficulty_bits, start_nonce=0,
               max_count=1 << 32):
        f = core.HeaderFields.unpack(header80)
        if f.data_hash == core.sha256d(cfg.payload(f.timestamp)):
            return SearchResult(None, None, max_count)
        return self.inner.search(header80, difficulty_bits,
                                 start_nonce=start_nonce,
                                 max_count=max_count)


recovery = (ExhaustFirstSpace(backend_from_config(cfg, group=group))
            if spec["staged"] else None)
records = []
fm = FusedMiner(cfg, blocks_per_call=spec["k"], group=group,
                recovery_backend=recovery, log_fn=records.append)
if spec["max_rounds"]:
    fm._fns[spec["k"]] = make_fused_miner(
        spec["k"], spec["b"], spec["d"], device="cpu",
        max_rounds=spec["max_rounds"], n_miners=2, group=group)
fm.mine_chain()
print(json.dumps({"rank": rank, "chain": fm.node.save().hex(),
                  "records": records}))
sys.stdout.flush()
os._exit(0)
"""


def _fused_ranks(spec: dict) -> list[dict]:
    """Both ranks' chain bytes and log_fn records."""
    port = str(_free_port())
    got = _world([["-c", _RANK, str(rank), port, json.dumps(spec)]
                  for rank in range(2)])
    for rc, _, err in got:
        assert rc == 0, err[-2000:]
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in got]


def _rank_one_prefix(batch: int) -> str:
    """A data prefix whose height-1 block (on genesis) has its lowest
    winner in rank 1's slice of its round, found with the C++ sweep: rank
    0's slice of that round holds no qualifier, so its own result is the
    sentinel, not the winner."""
    genesis = core.Node(D).tip_hash
    for i in range(64):
        prefix = f"slice{i}"
        header = core.make_candidate_header(genesis, f"{prefix}:1".encode(),
                                            1, D)
        nonce, _ = core.cpu_search(header, 0, 1 << 32, D)
        if (nonce // batch) % 2 == 1:
            return prefix
    pytest.fail("no prefix puts the first winner in rank 1's slice")


def test_a_winner_in_rank_ones_slice_keeps_the_oracle_chain():
    """The step finalizes each block from the world's winner-select, not
    from this rank's own slice: with the first block's winner in rank 1's
    slice and a second block built from it inside the same call, both
    ranks mine the oracle's chain."""
    prefix = _rank_one_prefix(1 << B)
    ranks = _fused_ranks({"d": D, "n": 3, "b": B, "k": 2, "prefix": prefix,
                          "staged": False, "max_rounds": None})
    oracle = _ref_oracle(3, prefix)
    assert (oracle.records[0].nonce >> B) % 2 == 1
    for got in ranks:
        assert bytes.fromhex(got["chain"]) == oracle.node.save()
        assert [r["nonce"] for r in got["records"]] == [
            r.nonce for r in oracle.records]
        assert [r["event"] for r in got["records"]] == ["block_mined"] * 3


def test_a_block_with_no_qualifier_below_the_cap_is_recovered_alike():
    """Capped at one round of 2 x 2^4 nonces, every block's base space
    holds no qualifier below the cap: each ends in the sentinel, fails
    validation on both ranks, and both roll over through the staged
    exhaustion, searching over the world, to the chain of the sequential
    miners (the port's and the reference's) through the same stub."""
    prefix, oracle = _rollover_prefix()
    ranks = _fused_ranks({"d": 10, "n": 3, "b": 4, "k": 1, "prefix": prefix,
                          "staged": True, "max_rounds": 1})
    ref_cfg = RefConfig(difficulty_bits=10, n_blocks=3, backend="cpu",
                        data_prefix=prefix)
    ref = RefMiner(ref_cfg, backend=ExhaustFirstSpace(
        ref_get_backend("cpu"), ref_cfg), log_fn=_quiet)
    ref.mine_chain()
    assert ranks[0]["records"] == ranks[1]["records"]
    for got in ranks:
        node = core.Node(10)
        assert node.load(bytes.fromhex(got["chain"]))
        assert [node.block_hash(h).hex() for h in range(4)] == oracle \
            == ref.chain_hashes()
        events = [r["event"] for r in got["records"]]
        assert events == ["nonce_space_exhausted", "block_mined"] * 3
        assert {r["backend"] for r in got["records"]
                if r["event"] == "block_mined"} == {"cuda-fused/rollover"}


def test_a_fused_rank_with_no_card_is_refused_not_moved_to_the_cpu():
    """Without ``--device cpu`` a rank of a fused world needs a card: with
    none it exits 2 with a JSON error, and mines nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    port = _free_port()
    ((rc, out, err),) = _world([[
        "-m", "mpi_blockchain_tpu_torch", "mine", "--fused", "--difficulty",
        "8", "--blocks", "2", "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "1", "--process-id", "0"]])
    assert rc == 2, err[-1000:]
    assert "no CUDA device" in json.loads(out.strip().splitlines()[-1])[
        "error"]
    assert '"block_mined"' not in err


def test_world_turns_prices_a_round_piece_by_piece_on_the_cpu():
    """``tools/world_turns.round_cost`` in a gloo world of one, on the CPU
    (the plain versions, a short slice): every piece timed, the round at
    least its slice."""
    from mpi_blockchain_tpu_torch.tools import world_turns

    cost = world_turns.round_cost(device="cpu", count=1 << 8, reps=3)
    assert set(cost) == {"slice_and_read_us", "winner_select_us",
                         "put_result_us", "step_us", "round_us"}
    assert all(v > 0 for v in cost.values())
    assert cost["round_us"] >= cost["slice_and_read_us"] * 0.5
    assert world_turns.ORDER == ("fused", "per_block", "per_block", "fused")
