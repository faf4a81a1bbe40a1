"""The comparison fails the control and every fault a cell can have.

Each run here skips the harness's look for a card and drives the rest of
a run on the CPU, with the program's timed path broken underneath:

* ``half_batch``: the sweep searches only even 32-nonce slices;
* ``next_answer``: the sweep answers the next qualifier after the lowest
  (an answer altered where it is produced: valid work, not the lowest);
* ``step_unchanged``: the fused step leaves its state as it was after
  the first block (no next header);
* ``exchange``: a world's winner-select returns each rank's own result.
"""
from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark import control, harness, reference, spec


def _sweep(keep_odd: bool, skip_first: bool):
    from mpi_blockchain_tpu_torch.ops import sha256_torch as st

    def sweep(ext, base, count, bits, *, early_exit=False):
        st.check_range(base, count)
        words = st.ext_words(ext)
        device = ext.device if hasattr(ext, "device") else "cpu"
        import torch

        found = []
        for lo in range(base, base + count, st.CHUNK):
            hi = min(lo + st.CHUNK, base + count)
            nonces = torch.arange(lo, hi, dtype=torch.int64, device=device)
            h0, h1 = st.sha256d_h01_from_ext(words, st._bswap32(nonces))
            qual = st.difficulty_mask(h0, h1, bits)
            if not keep_odd:
                qual &= (nonces >> 5) & 1 == 0
            found += nonces[qual].tolist()
            if len(found) > int(skip_first) and early_exit:
                break
        if not found:
            return 0, st.NOT_FOUND_U32
        best = found[1] if skip_first and len(found) > 1 else found[0]
        return len(found), best
    return sweep


def plant(name: str, setattr_=setattr) -> None:
    """Breaks the program's timed path in this process."""
    from mpi_blockchain_tpu_torch.models import fused
    from mpi_blockchain_tpu_torch.ops import sha256_block, sha256_torch

    if name == "half_batch":
        setattr_(sha256_torch, "sweep_core_ext", _sweep(False, False))
    elif name == "next_answer":
        setattr_(sha256_torch, "sweep_core_ext", _sweep(True, True))
    elif name == "step_unchanged":
        step = sha256_block.step_plain

        def unchanged(scratch, *, prev=None, **kw):
            if prev is not None:
                step(scratch, prev=prev, **kw)
        setattr_(sha256_block, "step_plain", unchanged)
    elif name == "exchange":
        setattr_(fused, "winner_select",
                 lambda count, best, group=None: (int(count), int(best)))
    else:
        raise ValueError(name)


def _launch(name: str):
    """Starts a world's other ranks with the same fault planted."""
    code = ("import sys; from benchmark.test_cell_faults import plant; "
            f"plant({name!r}); from benchmark import rank; "
            "from mpi_blockchain_tpu_torch.parallel.distributed import "
            "exit_process; exit_process(rank.main(sys.argv[1:]))")

    def start(argv):
        return subprocess.Popen([sys.executable, "-c", code, *argv[3:]],
                                cwd=spec.ROOT, stdin=subprocess.DEVNULL,
                                stdout=subprocess.DEVNULL)
    return start


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(tiny, seed):
    c = tiny("t-fused")
    v = control.readings(c, seed, 16)
    assert not v.correct and v.not_lowest >= 1
    assert v.header_mismatch == v.pow_fail == v.hash_mismatch == 0


@pytest.mark.parametrize("cell,fault", [
    ("t-fused", "half_batch"), ("t-fused", "next_answer"),
    ("t-fused", "step_unchanged"), ("t-miner", "half_batch"),
    ("t-miner", "next_answer")])
def test_a_fault_in_the_timed_path_is_not_correct(tiny, monkeypatch, cell,
                                                  fault):
    c = tiny(cell)
    plant(fault, monkeypatch.setattr)
    result, rc = harness.run(c.name, 7, 3.0, False, device="cpu", cell=c)
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("fault", ["exchange", "half_batch"])
def test_a_fault_in_a_world_is_not_correct(tiny, monkeypatch, fault):
    c = tiny("t-world")
    plant(fault, monkeypatch.setattr)
    result, rc = harness.run(c.name, 7, 3.0, False, device="cpu", cell=c,
                             launch=_launch(fault))
    assert result["correct"] is False and result["failed"] >= 1
    if fault == "exchange":
        assert result["compared"]["rank_divergence"]["value"] == 1


def test_a_sound_world_is_correct_on_every_rank(tiny):
    c = tiny("t-world")
    result, rc = harness.run(c.name, 6, 0.05, False, device="cpu", cell=c)
    assert rc == 0 and result["correct"], result
    assert result["compared"]["rank_divergence"] == {"value": 0,
                                                     "limit": 0}


def test_the_sound_chain_and_the_control_share_the_headers():
    # The control's chain differs from the program's only in nonces the
    # lowest-nonce rule rejects: every header it builds is well formed.
    chain, hashes = control.mine("seed-8", 8, 10)
    v = reference.check_chain(chain, prefix="seed-8", bits=8, seed=8,
                              block_hashes=hashes)
    assert v.header_mismatch == v.pow_fail == v.hash_mismatch == 0
