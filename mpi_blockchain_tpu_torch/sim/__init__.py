"""Network-scale adversarial simulation.

The port's copy of the reference's ``sim`` package, numpy and standard
library only, as there: the scenario engine on top of ``simulation.py``.
The vectorized engine stands in for mining with a seeded lottery, so it
runs on the host in both packages and has no device path; its draws come
from counter-based generators keyed by the scenario seed, which is what
makes a run here equal to the reference's, event for event.


* ``scenario`` — scenarios as pure values: seeded latency
  distributions, first-class partition windows, node churn
  (join/leave/crash-restart), adversary specs, and the documented
  churn > partition > drop fault-composition precedence.
* ``retarget`` — the height-scheduled difficulty-retarget rule shared
  with the C++ core (``Chain::expected_bits``), enforced on every
  adoption path.
* ``vecnet`` — the vectorized engine: ~1000 nodes x 10k steps via
  batched delivery masks and a Philox mining lottery, with the SAME
  consensus shape (keep-first, live-height sync gate, byzantine
  suffix bounds) and the same causal-event vocabulary as the real bus,
  so one forensics reader audits both.
* ``strategies`` — pluggable adversaries: selfish mining
  (withhold-and-release), eclipse (peer-set monopolization), stale-tip
  flooding (forged deep suffixes vs the sync budget/linkage/retarget
  gates). Seeded randomness only.
* ``real_attackers`` — the same attacks aimed at the REAL
  ``Network``/``SimNode`` stack (C++ chains, 80-byte headers) for the
  byzantine-bounds regression tests.

CLI: ``python -m mpi_blockchain_tpu_torch sim --preset adversarial-1k``
(scenario presets live in ``scenario.SCENARIO_PRESETS``; strategy /
churn / retarget flags compose ad-hoc scenarios). Every run is
byte-reproducible from its scenario value.
"""
from __future__ import annotations

from .retarget import RetargetRule  # noqa: F401
from .scenario import (SCENARIO_PRESETS, AdversarySpec,  # noqa: F401
                       ChurnEvent, ChurnSchedule, LatencySpec,
                       PartitionWindow, Scenario, ScenarioRng)
from .vecnet import VecNetwork, run_scenario  # noqa: F401
