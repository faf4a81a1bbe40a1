# Repo-level gates. `make check` is the one-command PR gate: chainlint
# static analysis first (fails fast, ~100 ms), then the tier-1 test
# command from ROADMAP.md.
PY ?= python3
SHELL := /bin/bash   # tier1 uses pipefail/PIPESTATUS

.PHONY: check lint lint-fast opbudget-check shardbudget-check \
        metrics-smoke forensics-smoke \
        perf-smoke chaos-smoke adversary-smoke meshwatch-smoke \
        elastic-smoke trace-smoke pipeline-smoke skew-smoke \
        incident-smoke compile-smoke serve-smoke tier1 core clean

check: lint opbudget-check shardbudget-check metrics-smoke \
        forensics-smoke perf-smoke \
        chaos-smoke adversary-smoke meshwatch-smoke elastic-smoke \
        trace-smoke pipeline-smoke skew-smoke incident-smoke \
        compile-smoke serve-smoke tier1

# chainlint: binding contract, header layout, JAX purity, sanitizer
# matrix, thread races (CONC), SPMD collectives, hot-path blocking,
# device-sync provenance (SYNC), buffer donation (DON), deadlint
# (LCK lock-order, FUT future lifecycle, THR thread lifecycle),
# shardlint (SHD partition-spec/axis-context), and the four committed
# ratchets: OPBUDGET.json (kernel ALU ops), TRANSFERBUDGET.json
# (sweep-path host<->device transfer sites), WAITBUDGET.json
# (sweep-scope blocking-wait sites), and SHARDBUDGET.json (SPMD-scope
# collective call sites) — so `make check` gates on all four budgets.
# --audit-suppressions rides the same run and is warning-only: it
# prints rot but never fails the gate.
lint:
	$(PY) -m mpi_blockchain_tpu.analysis --jobs 4 --audit-suppressions

# Pre-commit-speed lint: only pass families whose scope holds a file
# changed since HEAD (git-diff driven; see docs/static_analysis.md).
lint-fast:
	$(PY) -m mpi_blockchain_tpu.analysis --since HEAD --jobs 4

# OPBUDGET monotonicity guard: re-running the sanctioned mover on a
# clean tree must reproduce the committed OPBUDGET.json byte-for-byte,
# and a per-nonce census that moved UP fails loudly with the delta
# (the ratchet only goes down; docs/perfwatch.md §Roofline).
opbudget-check:
	env JAX_PLATFORMS=cpu $(PY) experiments/roofline.py --check-budget

# SHARDBUDGET monotonicity guard: re-running the sanctioned mover's
# census (static collective sites + the traced per-flavor collective
# census of the mesh sweep) must reproduce the committed
# SHARDBUDGET.json byte-for-byte; growth fails loudly as a RATCHET
# INCREASE with the delta (docs/static_analysis.md §SBD).
shardbudget-check:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.analysis.shard_budget --check

# Telemetry smoke: the instrumented mini-run (mine + faulted sim) must
# exit 0 and emit a Prometheus snapshot with the headline counters.
metrics-smoke:
	out=$$(env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.telemetry \
	    --steps 3 2>/dev/null) || \
	    { echo "metrics-smoke: telemetry CLI failed"; exit 1; }; \
	echo "$$out" | grep -q '^mining_rounds_total' && \
	echo "$$out" | grep -q '^hashes_tried_total' && \
	echo "$$out" | grep -q '_count' || \
	    { echo "metrics-smoke: required metrics missing"; exit 1; }; \
	echo "metrics-smoke: ok ($$(echo "$$out" | wc -l) snapshot lines)"

# Forensics smoke: a seeded 3-group faulted sim must dump causal logs,
# and the forensics CLI must reconstruct a non-empty fork tree with at
# least one trace event per node from them.
forensics-smoke:
	tmp=$$(mktemp -d); \
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu sim --groups 3 \
	    --drop-rate 20 --seed 3 --blocks 4 --partition-steps 12 \
	    --events-dump $$tmp/causal.json >/dev/null 2>&1 || \
	    { echo "forensics-smoke: faulted sim failed"; rm -rf $$tmp; exit 1; }; \
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.forensics \
	    --events $$tmp/causal.json --trace $$tmp/trace.json --json \
	    > $$tmp/report.json 2>/dev/null || \
	    { echo "forensics-smoke: forensics CLI failed"; rm -rf $$tmp; exit 1; }; \
	$(PY) -c "import json,sys; \
	r = json.load(open('$$tmp/report.json')); \
	t = json.load(open('$$tmp/trace.json')); \
	assert r['fork_tree']['blocks'], 'empty fork tree'; \
	assert r['fork_tree']['fork_points'], 'no fork reconstructed'; \
	assert r['convergence']['reorgs'] >= 1, 'no reorg audited'; \
	pids = {e['pid'] for e in t['traceEvents'] if e['ph'] == 'X'}; \
	assert len(pids) >= 4, f'trace rows missing: {sorted(pids)}'; \
	print('forensics-smoke: ok (%d blocks, %d fork points, %d reorgs, ' \
	      '%d trace events)' % (len(r['fork_tree']['blocks']), \
	      len(r['fork_tree']['fork_points']), r['convergence']['reorgs'], \
	      len(t['traceEvents'])))" || \
	    { echo "forensics-smoke: assertions failed"; rm -rf $$tmp; exit 1; }; \
	rm -rf $$tmp

# Chaos smoke: the resilience gate (docs/resilience.md) — a fixed fault
# plan must produce byte-identical causal dumps across two sims, a
# SIGKILL'd checkpointing mine must resume (incl. torn-tail truncation)
# to a verifying chain, and a dead TPU dispatch must walk the
# degradation ladder to cpu and still converge with rc 0.
chaos-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.resilience smoke \
	    2>/dev/null || { echo "chaos-smoke: failed"; exit 1; }; \
	echo "chaos-smoke: ok"

# Adversary smoke: the ISSUE 6 gate — the vectorized scenario engine runs
# selfish mining + eclipse + stale-tip flooding (with churn, a partition,
# and difficulty retargeting) twice with one seed; the two causal dumps
# must be byte-identical, and the forensics attack audit must show the
# expected outcomes: withheld-block releases causing reorgs, the eclipse
# victim recovering onto the canonical chain, and every flood dying in
# sync_rejected (budget + linkage + bits) with chains untouched.
adversary-smoke:
	tmp=$$(mktemp -d); \
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu sim \
	    --preset adversarial-smoke --events-dump $$tmp/a.json \
	    --metrics-dump $$tmp/metrics.txt >/dev/null 2>&1 || \
	    { echo "adversary-smoke: adversarial sim failed"; rm -rf $$tmp; exit 1; }; \
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu sim \
	    --preset adversarial-smoke --events-dump $$tmp/b.json \
	    >/dev/null 2>&1 || \
	    { echo "adversary-smoke: second run failed"; rm -rf $$tmp; exit 1; }; \
	cmp -s $$tmp/a.json $$tmp/b.json || \
	    { echo "adversary-smoke: same-seed causal dumps differ"; rm -rf $$tmp; exit 1; }; \
	grep -q '^sim_sync_rejected_total [1-9]' $$tmp/metrics.txt || \
	    { echo "adversary-smoke: sim_sync_rejected_total not exercised"; rm -rf $$tmp; exit 1; }; \
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.forensics \
	    --events $$tmp/a.json --json > $$tmp/report.json 2>/dev/null || \
	    { echo "adversary-smoke: forensics CLI failed"; rm -rf $$tmp; exit 1; }; \
	$(PY) -c "import json; \
	r = json.load(open('$$tmp/report.json')); \
	a = r['attack_audit']; \
	s = a['selfish'][0]; e = a['eclipse'][0]; f = a['flood'][0]; \
	assert r['fork_tree']['blocks'] and r['fork_tree']['fork_points']; \
	assert s['withheld_total'] > 0 and s['released_total'] > 0; \
	assert any(rel['reorgs_caused'] for rel in s['releases']), 'no release reorged'; \
	assert e['victim_tip_canonical'] and e['post_heal_adopt'], 'eclipse victim stuck'; \
	assert f['rejections'] > 0 and f['chains_untouched']; \
	assert set(f['rejections_by_path']) == {'budget', 'linkage', 'bits'}, f['rejections_by_path']; \
	print('adversary-smoke: ok (%d withheld, %d released, eclipse fork %d, ' \
	      '%d floods rejected)' % (s['withheld_total'], s['released_total'], \
	      e['isolated_fork_len'], f['rejections']))" || \
	    { echo "adversary-smoke: audit assertions failed"; rm -rf $$tmp; exit 1; }; \
	rm -rf $$tmp

# Meshwatch smoke: the ISSUE 7 gate — launch a 4-rank virtual-cpu world
# with --mesh-obs, SIGKILL one rank mid-run, then the merged mesh view
# must sum the per-rank hash counters, show every rank's heartbeat, name
# exactly the killed rank as stale, and render a non-empty dispatch
# pipeline report + Perfetto trace.
meshwatch-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.meshwatch smoke \
	    2>/dev/null || { echo "meshwatch-smoke: failed"; exit 1; }; \
	echo "meshwatch-smoke: ok"

# Elastic smoke: the ISSUE 9 gate — a 4-rank striped elastic world with
# one rank SIGKILL'd mid-run must evict it via meshwatch shard staleness
# (not a timeout guess), re-stripe over the survivors, finish rc 0 with
# an oracle-valid chain; and two same-seed mesh.rank_death runs must
# produce byte-identical causal dumps (docs/resilience.md §Elastic mesh).
elastic-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.resilience \
	    elastic-smoke 2>/dev/null || { echo "elastic-smoke: failed"; exit 1; }; \
	echo "elastic-smoke: ok"

# Trace smoke: the ISSUE 10 gate — a 2-rank --mesh-obs run with tracing
# on must yield a COMPLETE critical path (gap_pct < 5) for every mined
# height on every rank, a deterministic report, a loadable Perfetto
# export carrying the critical-path flow, and a telemetry self-overhead
# measurement inside the < 3% observer-effect budget, gated through the
# perfwatch detector's trace_overhead absolute bound.
trace-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.blocktrace smoke \
	    2>/dev/null || { echo "trace-smoke: failed"; exit 1; }; \
	echo "trace-smoke: ok"

# Pipeline smoke: the ROADMAP-item-1 gate — the async double-buffered
# miner's measured bubble_fraction on the fixed-seed instrumented mine
# must pass its SECTION_BOUNDS absolute budget (<= 0.15), the pipelined
# chain must be byte-identical to the sequential oracle, and `device`
# must dominate every block's critical path (docs/perfwatch.md
# §Pipelined dispatch).
pipeline-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.meshwatch \
	    pipeline-smoke 2>/dev/null || \
	    { echo "pipeline-smoke: failed"; exit 1; }; \
	echo "pipeline-smoke: ok"

# Skew smoke: the meshprof gate — two same-seed 4-rank --elastic cpu
# worlds must join the identical (site, round, rank) skew shape (the
# structural half of the mesh-skew report is deterministic; the
# millisecond values are scheduler weather), and the report's
# max_skew_ms must pass the collective_skew SECTION_BOUNDS budget
# through the perfwatch detector (docs/observability.md §meshprof).
skew-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.meshwatch \
	    skew-smoke 2>/dev/null || \
	    { echo "skew-smoke: failed"; exit 1; }; \
	echo "skew-smoke: ok"

# Perfwatch smoke: serve a faulted instrumented run, scrape /metrics +
# /healthz live, then prove the regression sentinel flags an injected
# 20% drop and passes within-spread noise (the merge-gate contract).
perf-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.perfwatch smoke \
	    2>/dev/null || { echo "perf-smoke: failed"; exit 1; }; \
	echo "perf-smoke: ok"

# Incident smoke: the chainwatch gate — a fault-injected 4-rank cpu
# world must yield EXACTLY the expected incident (one event_storm on
# the faulted rank, complete schema-pinned bundle, every rank still
# exits 0), and a clean fixed-seed world must yield ZERO incidents
# (the false-positive pin; docs/observability.md §chainwatch).
incident-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.chainwatch smoke \
	    2>/dev/null || { echo "incident-smoke: failed"; exit 1; }; \
	echo "incident-smoke: ok"

# Compile smoke: the dispatchwatch gate — a fixed-seed two-leg cpu mine
# (sequential + pipelined, chains byte-identical) must compile each
# sweep callable exactly once (per-site compiles == cache entries),
# zero post-warmup recompiles, zero recompile_storm incidents, and a
# complete measured-vs-committed cost join; the recompiles_after_warmup
# headline is gated at the compile_cache absolute bound (0.0).
compile-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.dispatchwatch \
	    smoke 2>/dev/null || { echo "compile-smoke: failed"; exit 1; }; \
	echo "compile-smoke: ok"

# Blockserve smoke: seeded loadgen against a live served mine under a
# strict fault plan (service.submit hang + service.rebuild raise) and
# a forced mid-run backend step-down — every request answers typed
# within its deadline, zero accepted-then-lost transactions, the chain
# is byte-identical to the no-service oracle, and the measured p99
# holds the `serve` SECTION_BOUNDS budget (docs/serving.md).
serve-smoke:
	env JAX_PLATFORMS=cpu $(PY) -m mpi_blockchain_tpu.service \
	    smoke 2>/dev/null || { echo "serve-smoke: failed"; exit 1; }; \
	echo "serve-smoke: ok"

# Tier-1 verify, verbatim from ROADMAP.md.
tier1:
	set -o pipefail; rm -f /tmp/_t1.log; \
	timeout -k 10 870 env JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q \
	    -m 'not slow' --continue-on-collection-errors -p no:cacheprovider \
	    -p no:xdist -p no:randomly 2>&1 | tee /tmp/_t1.log; \
	rc=$${PIPESTATUS[0]}; \
	echo DOTS_PASSED=$$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$$' /tmp/_t1.log | tr -cd . | wc -c); \
	exit $$rc

core:
	$(MAKE) -C mpi_blockchain_tpu/core

clean:
	$(MAKE) -C mpi_blockchain_tpu/core clean

# The port's gate (mpi_blockchain_tpu_torch/gate.py): the counterpart of
# `check` above, one step per prerequisite, on the card unless DEVICE=cpu.
DEVICE ?= cuda
.PHONY: check-torch
check-torch: ; $(PY) -m mpi_blockchain_tpu_torch.gate --device $(DEVICE)
