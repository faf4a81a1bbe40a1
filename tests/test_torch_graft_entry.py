"""The port's twin of ``__graft_entry__.py`` (``graft_entry``) against the
reference's, on the CPU: ``entry()``'s sweep gives the reference's
(count, min_nonce), and ``dryrun_multichip(n, device="cpu")`` prints the
reference's line (the per-round winner, the multi-round searcher's
agreement and the fused 2-block tip), the reference's dry run in its own
subprocess, as ``tests/test_graft_entry.py`` runs it. Exact."""
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from mpi_blockchain_tpu_torch import graft_entry
from mpi_blockchain_tpu_torch.config import ConfigError

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _ref_dryrun_line(n: int) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "MBT_DRYRUN_CHILD")}
    code = f"import __graft_entry__; __graft_entry__.dryrun_multichip({n})"
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-800:]
    (line,) = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("dryrun_multichip(")]
    return line


def test_entry_gives_the_references_count_and_nonce():
    sys.path.insert(0, str(REPO))
    import __graft_entry__

    ref_fn, ref_args = __graft_entry__.entry()
    want = [int(x) for x in jax.jit(ref_fn)(*ref_args)]
    fn, args = graft_entry.entry(device="cpu")
    assert [int(x) for x in fn(*args)] == want
    assert want[0] > 0
    # The example is the reference's: the same midstate and template.
    assert [a.tolist() for a in args[:2]] == [
        [int(v) for v in a] for a in ref_args[:2]]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_prints_the_references_line(n, capsys):
    graft_entry.dryrun_multichip(n, device="cpu")
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("dryrun_multichip(")]
    assert line == _ref_dryrun_line(n)
    assert f"'miners': {n}" in line


def test_the_cli_runs_the_dry_run_then_the_entry(capsys):
    assert graft_entry.main(["2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    fn, args = graft_entry.entry(device="cpu")
    assert "dryrun_multichip(2):" in out
    assert f"entry(): {[int(x) for x in fn(*args)]}" in out


def test_with_no_card_the_card_is_not_replaced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(ConfigError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
