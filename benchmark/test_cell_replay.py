"""The roofline's work per nonce: the replay against its frozen numbers,
and what the counts mean."""
from __future__ import annotations

import json
import pathlib

import pytest

from benchmark import replay

FROZEN = json.loads((pathlib.Path(replay.__file__).parent / "metrics"
                     / "sweep_roofline.json").read_text())


@pytest.mark.parametrize("bits,cls", [(0, 0), (1, 1), (20, 1), (24, 1),
                                      (31, 1), (32, 2), (33, 3), (63, 3),
                                      (64, 4)])
def test_replay_reproduces_the_frozen_work_per_class(bits, cls):
    assert replay.difficulty_class(bits) == cls
    assert replay.work(bits) == FROZEN["work"][str(cls)]


def test_replay_counts():
    # The adds are the kernel source's own count at these difficulties
    # (1081 below 33 bits, 1082 above: word 1's feed-forward); the
    # ALU-only operations are the rotates, shifts, three-input logic and
    # the test, fewer than the 1897 of today's compiled loop at d24.
    assert replay.work(24) == {"alu_only": 1879, "adds": 1081}
    assert replay.work(40) == {"alu_only": 1880, "adds": 1082}
    assert replay.work(0) == {"alu_only": 0, "adds": 0}


def test_clocks_per_nonce_is_the_busier_pipe():
    # ALU-bound: L / 64.
    assert replay.clocks_per_nonce(1879, 1081) == pytest.approx(1879 / 64)
    # Add-bound once the adds outweigh the ALU-only work: (2L + A) / 192.
    assert replay.clocks_per_nonce(64, 1000) == pytest.approx(1128 / 192)
    assert replay.clocks_per_nonce(0, 0) == 0


def test_the_peak_is_the_published_one():
    assert FROZEN["peak"]["sms"] == 132
    assert FROZEN["peak"]["sm_clock_mhz"] == 1980
