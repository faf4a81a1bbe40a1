"""Chain forensics of the port: merge per-node causal logs and
reconstruct what happened.

The port's copy of the reference's ``forensics`` package, the reader of
the causal dumps that ``sim --events-dump``, ``mine --elastic
--events-dump`` and the flight recorder write (the same bytes the
reference writes for the same run):

* **merge**: one causally consistent total order over all nodes' events
  (sorted by ``(lamport, node, seq)``; a deliver never sorts before its
  send).
* **fork_tree**: the block DAG reconstructed from mine events: fork
  points, per-node final tips, the canonical chain, and the orphaned
  (reorged-away) blocks.
* **reorg audit**: which node adopted which suffix, which announcements
  addressed to it were dropped or partition-deferred, and whether that
  loss explains the fork it had to heal from.
* **convergence stats**: announcement propagation latency (in sim steps)
  and the run's overall convergence picture.
* **attack_audit**: what each selfish, eclipse or flood strategy of an
  adversarial dump did and achieved.
* **trace_export**: the merged order as Chrome trace-event JSON (logical
  time on the timeline axis), viewable in Perfetto.

CLI::

    python -m mpi_blockchain_tpu_torch.forensics --events causal.json \\
        [--trace trace.json] [--json]

Everything here is a pure function of the dump, host-only, standard
library only: the same artifact always gives the same report.
"""
from __future__ import annotations

from ..telemetry.causal import load_causal_dump  # noqa: F401
from .attack_audit import attack_audit  # noqa: F401
from .fork_tree import (build_fork_tree, convergence_stats,  # noqa: F401
                        reorg_audit)
from .merge import merge_events, node_order  # noqa: F401
from .trace_export import to_chrome_trace  # noqa: F401


def analyze_dump(dump: dict) -> dict:
    """The full forensics report for one causal dump (the CLI's payload).
    Dumps carrying ``attack_*`` events additionally get the attack audit:
    what each selfish, eclipse or flood strategy did and achieved."""
    merged = merge_events(dump)
    tree = build_fork_tree(merged)
    return {
        "meta": dump.get("meta", {}),
        "nodes": node_order(dump),
        "events_merged": len(merged),
        "fork_tree": tree,
        "reorg_audit": reorg_audit(merged, tree),
        "convergence": convergence_stats(merged, tree),
        "attack_audit": attack_audit(merged, tree),
    }
