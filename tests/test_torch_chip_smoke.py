"""The plain helpers of ``chip_smoke.py`` that turn its measurements into
numbers, on synthetic input: no card needed."""
import numpy as np
import pytest

import chip_smoke
from chip_smoke import M32, block_gaps, spread


def _call(start: float, sweeps: list[float], step: float, copy: float,
          first_step: float = 50.0) -> dict:
    """Event times of one k-block call starting at ``start``: the first
    step takes ``first_step``, then each block the copy, its sweep of the
    given length, the next step and so on."""
    t = start + first_step
    out = {"sweeps": [], "steps": [t]}
    for length in sweeps:
        t += copy
        out["sweeps"].append((t, t + length))
        t += length + step
        out["steps"].append(t)
    return out


def test_gaps_are_taken_within_a_call_only():
    calls = [_call(0.0, [10.0, 20.0, 30.0], step=2.0, copy=0.5),
             _call(1000.0, [5.0, 5.0], step=3.0, copy=1.0)]
    split = block_gaps(calls)
    # 2 gaps in the first call, 1 in the second; none across the 900 ms
    # between the calls, nor before a call's first sweep.
    assert split["gap"] == pytest.approx([2.5, 2.5, 4.0])
    assert split["step"] == pytest.approx([2.0, 2.0, 3.0])
    assert split["copy"] == pytest.approx([0.5, 0.5, 1.0])
    one = block_gaps([_call(0.0, [7.0], step=1.0, copy=1.0)])
    assert one == {"gap": [], "step": [], "copy": []}


def test_gaps_without_step_events_are_not_split():
    call = _call(0.0, [1.0, 1.0, 1.0], step=4.0, copy=2.0)
    del call["steps"]
    assert block_gaps([call]) == {"gap": [6.0, 6.0], "step": [], "copy": []}


def test_spread_gives_median_p90_and_max():
    values = [float(v) for v in np.random.default_rng(3).permutation(100)]
    assert spread(values) == {"n": 100, "median": 50.0, "p90": 90.0,
                              "max": 99.0}
    assert spread([4.0]) == {"n": 1, "median": 4.0, "p90": 4.0, "max": 4.0}
    assert spread([]) == {"n": 0, "median": None, "p90": None, "max": None}
    # Over the gaps of a run: 99 a call at K = 100, 990 over 10 calls.
    calls = [_call(2000.0 * i, [1.0] * 100, step=float(i + 1), copy=1.0)
             for i in range(10)]
    gaps = spread(block_gaps(calls)["gap"])
    assert gaps == {"n": 990, "median": 7.0, "p90": 11.0, "max": 11.0}


def test_step_edge_cases_cover_every_edge():
    groups = chip_smoke.step_edge_cases(np.random.default_rng(0))
    assert [bits for *_, bits in groups] == list(chip_smoke.STEP_EDGE_BITS)
    for prev, data, heights, nonces, bits in groups:
        assert prev.dtype == data.dtype == nonces.dtype == np.uint32
        assert data.shape == (len(prev), 2, 8) and nonces.shape == (
            len(prev), 2)
        assert {int(w) for w in prev.ravel()} == {0, M32}
        assert all(len(set(row)) == 1 for row in prev.tolist())
        assert set(heights.tolist()) == {0, M32}
        assert set(nonces[:, 0].tolist()) == set(nonces[:, 1].tolist()) \
            == {0, M32}
        combos = {(int(p[0]), int(h), int(n[0]))
                  for p, h, n in zip(prev, heights, nonces)}
        assert len(combos) == len(prev) == 8
