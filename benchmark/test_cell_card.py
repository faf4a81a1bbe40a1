"""On the card: today's sweep against the frozen roofline in fused-d24.

    python -m pytest -q -m cuda benchmark/test_cell_card.py -s
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import replay, spec

DATA = json.loads((spec.HERE / "metrics" / "sweep_roofline.json")
                  .read_text())


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sweep kernel runs only there")


@pytest.mark.cuda
def test_sweep_reads_at_most_its_roofline_in_fused_d24():
    _card()
    p = subprocess.run([sys.executable, "-m", "benchmark", "--workload",
                        "fused-d24", "--seed", "2147483659", "--seconds",
                        "3", "--trace", "1"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    share = result["metrics"]["sweep_roofline"]["value"]
    work = DATA["work"]["1"]
    clocks = replay.clocks_per_nonce(work["alu_only"], work["adds"])
    print(f"sweep_roofline {share:.3f}% of max(L/64, (2L+A)/192) = "
          f"{clocks:.4f} SM clocks a nonce (L {work['alu_only']}, A "
          f"{work['adds']}) on {DATA['peak']['sms']} SMs at "
          f"{DATA['peak']['sm_clock_mhz']} MHz; "
          f"{result['device']['kind']}, power limit "
          f"{result['device'].get('power_limit')}")
    assert 0 < share <= 100
