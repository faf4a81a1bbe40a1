"""The port's chainlint (``mpi_blockchain_tpu_torch.analysis``) against the
reference's (``mpi_blockchain_tpu.analysis``).

What it compares:

* the families ported near-verbatim (conc, lock, future, thread's THR
  rules, resilience, telemetry): the same fixture source goes through the
  reference's pass and the port's, each through its ``overrides`` seam,
  and both must give the same set of (line, rule);
* the families read for torch (sync, hotpath, header, binding): twin
  fixtures, the JAX form for the reference and its torch form for the
  port, must fire the same rule ids at the same lines (``isinstance`` is
  a negative case of SYNC002 for the port only; the drifted ``extern "C"``
  block of the CUDA library has no reference counterpart);
* the port's CLI runs clean over the repo, once per family;
* the port's wait budget: the up-ratchet refusal and the mover's rewrite;
* the faults the port's passes found, repaired: the ladder lock is not
  held across a wait on the card, and bench's per-rank counter goes
  through ``rank_counter``.
"""
import json
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap
import threading

import pytest

from mpi_blockchain_tpu import analysis as ref_analysis
from mpi_blockchain_tpu import bench_lib as ref_bench
from mpi_blockchain_tpu_torch import analysis, bench_lib
from mpi_blockchain_tpu_torch.analysis import (binding_contract,
                                               hotpath_lint, sanitizers,
                                               thread_lint)
from mpi_blockchain_tpu_torch.backend import MinerBackend, SearchResult
from mpi_blockchain_tpu_torch.resilience.dispatch import ResilientBackend

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mpi_blockchain_tpu_torch"
REF = ROOT / "mpi_blockchain_tpu"


def lines_rules(findings, path=None):
    return {(f.line, f.rule) for f in findings
            if path is None or f.file == str(path)}


def _both(family, overrides_for, text, tmp_path, name="mod.py"):
    """(reference findings, port findings) of one family on one fixture."""
    path = tmp_path / name
    path.write_text(text)
    over = overrides_for(path)
    ref = ref_analysis.run_all(root=ROOT, passes=[family], overrides=over,
                               apply_suppress=False)
    port = analysis.run_all(root=ROOT, passes=[family], overrides=over,
                            apply_suppress=False)
    return path, ref, port


# ---- near-verbatim families: one fixture, both passes ----------------------


CONC = textwrap.dedent("""\
    import threading

    _shared = []
    _counts = {}
    _lock = threading.Lock()


    def _worker():
        _shared.append(1)              # CONC001: no lock anywhere
        _counts["x"] = 1               # CONC002: other site IS locked


    def start():
        t = threading.Thread(target=_worker, daemon=True)
        t.start()
        _shared.append(2)              # CONC001: host side
        with _lock:
            _counts["x"] = 0           # locked side


    class Flusher:
        def __init__(self):
            self.seq = 0
            self._lock = threading.Lock()

        def start(self):
            threading.Thread(target=self._loop, daemon=True).start()

        def _loop(self):
            self.seq += 1              # CONC001: thread side

        def close(self):
            with self._lock:
                self.seq += 1          # locked: the loop's site is CONC002
    """)

LCK = textwrap.dedent("""\
    import threading

    _a_lock = threading.Lock()
    _b_lock = threading.Lock()


    def forward(q):
        with _a_lock:
            with _b_lock:                  # A -> B witness
                q.put(1)


    def backward(fut):
        with _b_lock:
            with _a_lock:                  # B -> A: LCK001
                pass
            res = fut.result()             # LCK002: wait under _b_lock
            return res


    def notify(cb):
        with _a_lock:
            on_block = cb
            on_block()                     # LCK003: callback under lock


    def poll(ready):
        with _a_lock:
            _spin(ready)                   # LCK002 via the helper


    def _spin(ready):
        import time
        while not ready():
            time.sleep(0.001)


    def bounded(q):
        with _a_lock:
            return q.get(timeout=1.0)      # bounded: clean
    """)

FUT = textwrap.dedent("""\
    import threading

    _records = []


    class Miner:
        def mine(self, backend, pool):
            fut = backend.search_async(b"x", 16)     # FUT001: dropped
            pool.submit(self._sweep)                 # FUT001: discarded
            got = backend.search_async(b"x", 20)
            return got.result()                      # FUT002: unbounded

        def bounded(self, backend):
            got = backend.search_async(b"x", 20)
            return got.result(timeout=5.0)           # bounded: clean

        def _sweep(self):
            pass


    def arm(fut):
        fut.add_done_callback(lambda f: _records.append(f))   # FUT003
    """)

THR = textwrap.dedent("""\
    import threading


    class Runner:
        def __init__(self):
            self.done = False

        def start(self):
            t = threading.Thread(target=self._loop)    # THR001
            t.start()
            threading.Thread(target=self._loop).start()   # THR001
            return t

        def _loop(self):
            self.done = True                           # THR002

        def is_done(self):
            return self.done

        def reaped(self):
            v = threading.Thread(target=self._loop)    # joined: clean
            v.start()
            v.join(timeout=5)
    """)

RES = textwrap.dedent("""\
    def dispatch(x):
        try:
            x()
        except:                            # RES001: bare, swallowed
            pass
        try:
            x()
        except Exception:                  # RES001: broad, pass
            pass
        try:
            x()
        except (ValueError, BaseException):  # RES001: broad in a tuple
            ...
        try:
            x()
        except Exception as e:             # recorded: clean
            print(e)
        try:
            x()
        except:                            # re-raised: clean
            raise
    """)

ADVERSARY = textwrap.dedent("""\
    import random                          # RES002
    import time
    from time import perf_counter          # RES002

    import numpy as np


    def step():
        t = time.time()                    # RES002
        np.random.seed(0)                  # RES002
        rng = np.random.default_rng()      # RES002
        ok = np.random.default_rng(7)      # seeded: clean
        return t, rng, ok
    """)

METRICS = textwrap.dedent("""\
    def instrument(rank):
        counter("requests").inc()              # TEL002
        gauge("queue_total").set(1)            # TEL002
        histogram("latency").observe(1.0)      # TEL002
        counter("good_total").inc()
        counter("hashes_total", rank=rank)     # TEL003 (rank scope)
        rank_counter("hashes_total", rank=rank)
        profiler().dispatch(kind="sweep")      # TEL004
        profiler().dispatch(kind="sweep", height=3)
        skew_span("mesh.sweep")                # TEL005
        skew_span(site="mesh.sweep")
        emit_incident(rule="storm")            # TEL006 (severity)
        compile_scope("fused")                 # TEL007
        note_cache(site="fused", hit=True)
    """)

SIM = textwrap.dedent("""\
    def announce(header80, record, node, lamport):
        emit_event({"event": "sim.announce"})              # TEL001
        emit_event(record)                                 # TEL001
        emit_event({"event": "sim.announce", "node": node,
                    "lamport": lamport})
    """)


def _tel_overrides(path):
    return {"telemetry_files": [path], "rank_scope_files": [path],
            "blocktrace_scope_files": [path], "skew_scope_files": [path],
            "incident_scope_files": [path], "compile_scope_files": [path]}


NEAR_VERBATIM = {
    "conc": (CONC, lambda p: {"conc_files": [p]},
             {(9, "CONC001"), (10, "CONC002"), (16, "CONC001"),
              (30, "CONC002")}),
    "lock": (LCK, lambda p: {"lock_files": [p]},
             {(9, "LCK001"), (17, "LCK002"), (24, "LCK003"),
              (29, "LCK002")}),
    "future": (FUT, lambda p: {"future_files": [p]},
               {(8, "FUT001"), (9, "FUT001"), (11, "FUT002"),
                (22, "FUT003")}),
    "thread": (THR, lambda p: {"thread_files": [p]},
               {(9, "THR001"), (11, "THR001"), (15, "THR002")}),
    "resilience": (RES, lambda p: {"resilience_files": [p],
                                   "adversary_files": []},
                   {(4, "RES001"), (8, "RES001"), (12, "RES001")}),
    "resilience-adversary": (ADVERSARY,
                             lambda p: {"resilience_files": [],
                                        "adversary_files": [p]},
                             {(1, "RES002"), (3, "RES002"), (9, "RES002"),
                              (10, "RES002"), (11, "RES002")}),
    "telemetry": (METRICS, _tel_overrides,
                  {(2, "TEL002"), (3, "TEL002"), (4, "TEL002"),
                   (6, "TEL003"), (8, "TEL004"), (10, "TEL005"),
                   (12, "TEL006"), (13, "TEL007")}),
}


@pytest.mark.parametrize("case", sorted(NEAR_VERBATIM))
def test_near_verbatim_family_gives_the_references_lines_and_rules(
        case, tmp_path):
    text, overrides_for, want = NEAR_VERBATIM[case]
    family = case.split("-")[0]
    path, ref, port = _both(family, overrides_for, text, tmp_path)
    if family == "thread":       # TBW: each package's own budget and scope
        ref = [f for f in ref if f.rule.startswith("THR")]
        port = [f for f in port if f.rule.startswith("THR")]
    assert lines_rules(port, path) == lines_rules(ref, path) == want
    assert lines_rules(port) == lines_rules(port, path)   # tree clean


def test_tel001_on_the_sim_bus_gives_the_references_lines(tmp_path):
    path, ref, port = _both("telemetry", lambda p: {"sim_py": p}, SIM,
                            tmp_path, name="simulation.py")
    assert lines_rules(port, path) == lines_rules(ref, path) == {
        (2, "TEL001"), (3, "TEL001")}


@pytest.mark.parametrize("rule_line", [(CONC, "conc", "conc_files", 9),
                                       (FUT, "future", "future_files", 11)])
def test_inline_suppression_and_audit_as_the_reference(rule_line,
                                                       tmp_path):
    """A ``chainlint: disable=RULE`` drops the finding in both packages;
    the same comment on a line where the rule does not fire is stale in
    the port's audit (which scans the port's package)."""
    text, family, key, line = rule_line
    lines = text.splitlines()
    rule = {"conc": "CONC001", "future": "FUT002"}[family]
    lines[line - 1] += f"  # chainlint: disable={rule}"
    pkg = tmp_path / analysis.REPO_PACKAGE
    pkg.mkdir()
    path = pkg / "mod.py"
    path.write_text("\n".join(lines) + "\n")
    for run_all in (ref_analysis.run_all, analysis.run_all):
        kept = run_all(root=tmp_path, passes=[family],
                       overrides={key: [path]})
        assert (line, rule) not in lines_rules(kept)
    assert analysis.audit_suppressions(
        root=tmp_path, passes=[family], overrides={key: [path]}) == []
    lines[line] += f"  # chainlint: disable={rule}"
    path.write_text("\n".join(lines) + "\n")
    stale = analysis.audit_suppressions(
        root=tmp_path, passes=[family], overrides={key: [path]})
    assert len(stale) == 1 and f":{line + 1}: stale suppression" in stale[0]


# ---- families read for torch: twin fixtures --------------------------------


SYNC_JAX = textwrap.dedent("""\
    import jax.numpy as jnp
    import numpy as np


    class Miner:
        def mine_block(self):
            winner, count = self.backend.search(b"x", 20)
            if count:                                   # SYNC002
                return int(winner)                      # SYNC001
            return None

        def mine_chain(self, n):
            buf = jnp.zeros(8)
            host = np.asarray(buf)                      # SYNC001
            res = self.backend.search(b"x", 20)
            if res is None:                             # identity: clean
                return host
            return replicated_host_value(buf)           # the seam: clean


    class FusedMiner:
        def mine_chain(self, n):
            self._mine_span(n)

        def _mine_span(self, n):
            nonces, prev = self._fn(n)(b"x", n)
            while nonces[0]:                            # SYNC002
                nonces, prev = self._fn(n)(b"x", n)
            return prev.block_until_ready()             # SYNC001
    """)

SYNC_TORCH = textwrap.dedent("""\
    import torch
    import numpy as np


    class Miner:
        def mine_block(self):
            winner, count = self.backend.search(b"x", 20)
            if count:                                   # SYNC002
                return int(winner)                      # SYNC001
            return None

        def mine_chain(self, n):
            buf = torch.zeros(8, device=self.device)
            host = buf.cpu()                            # SYNC001
            res = self.backend.search(b"x", 20)
            if res is None:                             # identity: clean
                return host
            return winner_select(buf, 0)                # the seam: clean


    class FusedMiner:
        def mine_chain(self, n):
            self._mine_span(n)

        def _mine_span(self, n):
            nonces, prev = self._fn(n)(b"x", n)
            while nonces[0]:                            # SYNC002
                nonces, prev = self._fn(n)(b"x", n)
            return torch.cuda.synchronize()             # SYNC001


    class CudaBackend:
        def launch(self, header80, bits):
            launched = sweep_launch(header80, 0, 1, bits, device="cuda")
            return launched.result()                    # the seam: clean

        def search(self, header80, bits):
            host = torch.zeros(2, device="cpu")
            return self.launch(header80, bits), int(host[0])   # host: clean


    class ResilientBackend:
        def search_async(self, header80, bits):
            return self.search(header80, bits)

        def search(self, header80, bits):
            nonces = torch.empty(2, device="cuda")
            if isinstance(nonces, tuple):               # type test: clean
                return None
            return nonces
    """)

SYNC_WANT = {(8, "SYNC002"), (9, "SYNC001"), (14, "SYNC001"),
             (27, "SYNC002"), (29, "SYNC001")}


def test_sync_twins_fire_the_same_rules_at_the_same_lines(tmp_path):
    ref_path, port_path = tmp_path / "ref.py", tmp_path / "port.py"
    ref_path.write_text(SYNC_JAX)
    port_path.write_text(SYNC_TORCH)
    ref = ref_analysis.run_all(root=ROOT, passes=["sync"],
                               overrides={"sync_files": [ref_path]})
    port = analysis.run_all(root=ROOT, passes=["sync"],
                            overrides={"sync_files": [port_path]})
    assert lines_rules(ref) == lines_rules(port) == SYNC_WANT


WORLD_CALL = textwrap.dedent("""\
    class FusedMiner:
        def mine_chain(self, n):
            self._mine_span(n)

        def _mine_span(self, n):
            nonces, prev = self._fn(n)(b"x", n)
            if isinstance(nonces, _WorldCall):
                return nonces.wait()
            return prev


    class Miner:
        def mine_chain(self, n):
            return n

        def mine_block(self):
            return None
    """)


def test_isinstance_is_no_sync_for_the_port_only(tmp_path):
    """The reference's provenance rules read a type test of a device value
    as a branch on it (SYNC002); the port's do not: isinstance reads the
    Python object, never the tensor's data."""
    path = tmp_path / "fused.py"
    path.write_text(WORLD_CALL)
    ref = ref_analysis.run_all(root=ROOT, passes=["sync"],
                               overrides={"sync_files": [path]})
    assert lines_rules(ref) == {(7, "SYNC002")}
    stubs = textwrap.dedent("""\


        class CudaBackend:
            def launch(self):
                return None

            def search(self):
                return None


        class ResilientBackend:
            def search_async(self):
                return None

            def search(self):
                return None
        """)
    path.write_text(WORLD_CALL + stubs)
    assert analysis.run_all(root=ROOT, passes=["sync"],
                            overrides={"sync_files": [path]}) == []


HOT = textwrap.dedent("""\
    import time


    class Miner:
        def mine_block(self):
            return _sweep_impl(self)

        def mine_chain(self, n):
            for _ in range(n):
                self.mine_block()
                time.sleep(0.1)                 # HOT001: direct

    def _persist(data):
        with open("/tmp/chain.bin", "wb") as f:  # HOT001: transitive
            f.write(data)


    class FusedMiner:
        def mine_chain(self, n):
            self._mine_span(n)

        def _mine_span(self, n):
            return {program}(n)


    def _sweep_impl(self):
        return _persist(b"x")
    """)

HOT_TORCH_TAIL = textwrap.dedent("""\


    class CudaBackend:
        def launch(self, header80, bits):
            return self.search(header80, bits)

        def search(self, header80, bits):
            return header80


    class ResilientBackend:
        def search_async(self, header80, bits):
            return self.search(header80, bits)

        def search(self, header80, bits):
            return header80
    """)


def test_hotpath_twins_fire_the_same_rules_at_the_same_lines(tmp_path):
    ref_path, port_path = tmp_path / "ref.py", tmp_path / "port.py"
    ref_path.write_text(HOT.format(program="jax.jit(self._step)"))
    port_path.write_text(HOT.format(program="self._fn(n)")
                         + HOT_TORCH_TAIL)
    ref = ref_analysis.run_all(root=ROOT, passes=["hotpath"],
                               overrides={"hotpath_files": [ref_path]})
    port = analysis.run_all(root=ROOT, passes=["hotpath"],
                            overrides={"hotpath_files": [port_path]})
    assert lines_rules(ref) == lines_rules(port) == {(11, "HOT001"),
                                                     (14, "HOT001")}
    # Without the backends' entry points the port's lint says it checks
    # nothing for them, as the reference's does for a renamed miner.
    port_path.write_text(HOT.format(program="self._fn(n)"))
    missing = analysis.run_all(root=ROOT, passes=["hotpath", "sync"],
                               overrides={"hotpath_files": [port_path],
                                          "sync_files": [port_path]})
    assert {f.rule for f in missing} >= {"HOT002", "SYNC003"}
    assert sum(f.rule == "HOT002" for f in missing) == 4


def test_first_use_build_is_reachable_and_sanctioned_by_decision():
    """The native libraries' build at first use (core/build.py) is
    reachable from the fused miner through the memoized loaders; the port
    decides explicitly to sanction it as a seam."""
    from mpi_blockchain_tpu_torch.analysis.callgraph import CallGraph

    files = hotpath_lint._scoped_files(ROOT)
    graph, errors = CallGraph.from_files(ROOT, files)
    assert errors == []
    roots, missing = graph.resolve_roots(hotpath_lint.ENTRY_POINTS)
    assert missing == []
    unpruned = graph.reachable(roots)
    build = "mpi_blockchain_tpu_torch/core/build.py"
    assert any(q.startswith(build + "::") for q in unpruned)
    assert build in hotpath_lint.SANCTIONED_SEAMS
    pruned = graph.reachable(roots, prune=hotpath_lint._is_sanctioned)
    assert not any(q.startswith(build + "::") for q in pruned)


def _drift(src: pathlib.Path, tmp_path, pattern: str, repl: str,
           name: str | None = None) -> tuple[pathlib.Path, int]:
    """A copy of ``src`` with one regex drift; (path, line of the drift)."""
    text = src.read_text()
    m = re.search(pattern, text)
    assert m is not None, pattern
    out = tmp_path / (name or src.name)
    out.write_text(text[:m.start()] + re.sub(pattern, repl, m.group(0))
                   + text[m.end():])
    return out, text[:m.start()].count("\n") + 1


def test_header_twins_fire_hdr004_at_the_nonce_word_index(tmp_path):
    (tmp_path / "ref").mkdir()
    ref_sched, ref_line = _drift(
        REF / "ops" / "sha256_sched.py", tmp_path / "ref",
        r"NONCE_WORD_INDEX = 3", "NONCE_WORD_INDEX = 4")
    port_sched, port_line = _drift(
        PORT / "ops" / "sha256_sched.py", tmp_path,
        r"NONCE_WORD_INDEX = 3", "NONCE_WORD_INDEX = 4")
    ref = ref_analysis.run_all(root=ROOT, passes=["header"],
                               overrides={"sha_jnp": ref_sched})
    port = analysis.run_all(root=ROOT, passes=["header"],
                            overrides={"sha_sched": port_sched})
    assert lines_rules(ref) == {(ref_line, "HDR004")}
    assert lines_rules(port) == {(port_line, "HDR004")}


def test_header_twins_fire_hdr001_at_the_reordered_field(tmp_path):
    block = ("  uint32_t timestamp = 0;\n  uint32_t bits = 0;\n"
             "  uint32_t nonce = 0;\n")
    swapped = ("  uint32_t nonce = 0;\n  uint32_t timestamp = 0;\n"
               "  uint32_t bits = 0;\n")
    found = []
    for run_all, src, sub in (
            (ref_analysis.run_all, REF / "core" / "src", "ref"),
            (analysis.run_all, PORT / "core" / "csrc", "port")):
        text = (src / "chain.hpp").read_text()
        assert block in text
        (tmp_path / sub).mkdir()
        hpp = tmp_path / sub / "chain.hpp"
        hpp.write_text(text.replace(block, swapped))
        found.append(lines_rules(run_all(root=ROOT, passes=["header"],
                                         overrides={"chain_hpp": hpp})))
    assert found[0] == found[1]
    assert {r for _, r in found[0]} == {"HDR001"}


HEADER_TWIN_DRIFTS = {
    # set_nonce keeps one word too few
    "set_nonce": ("core_init", "core/__init__.py", "core/__init__.py",
                  r"header80\[:76\]", "header80[:72]"),
    # HeaderFields reads timestamp/bits/nonce one byte late
    "unpack": ("core_init", "core/__init__.py", "core/__init__.py",
               r'unpack_from\("<III", header80, 68\)',
               'unpack_from("<III", header80, 69)'),
}


@pytest.mark.parametrize("drift", sorted(HEADER_TWIN_DRIFTS))
def test_header_twins_fire_hdr004_at_the_codec_drift(drift, tmp_path):
    key, ref_rel, port_rel, pattern, repl = HEADER_TWIN_DRIFTS[drift]
    (tmp_path / "ref").mkdir()
    ref_src, ref_line = _drift(REF / ref_rel, tmp_path / "ref", pattern,
                               repl)
    port_src, port_line = _drift(PORT / port_rel, tmp_path, pattern, repl)
    ref = ref_analysis.run_all(root=ROOT, passes=["header"],
                               overrides={key: ref_src})
    port = analysis.run_all(root=ROOT, passes=["header"],
                            overrides={key: port_src})
    assert lines_rules(ref) == {(ref_line, "HDR004")}
    assert lines_rules(port) == {(port_line, "HDR004")}


def test_golden_test_slice_drift_fires_hdr004_in_both(tmp_path):
    (tmp_path / "ref").mkdir()
    pattern, repl = r"cand\[68:72\]", "cand[68:73]"
    ref_test, ref_line = _drift(ROOT / "tests" / "test_header_layout.py",
                                tmp_path / "ref", pattern, repl)
    port_test, port_line = _drift(
        ROOT / "tests" / "test_torch_header_layout.py", tmp_path, pattern,
        repl)
    ref = ref_analysis.run_all(root=ROOT, passes=["header"],
                               overrides={"header_test": ref_test})
    port = analysis.run_all(root=ROOT, passes=["header"],
                            overrides={"header_test": port_test})
    assert lines_rules(ref) == {(ref_line, "HDR004")}
    assert lines_rules(port) == {(port_line, "HDR004")}


CUDA_DRIFTS = {
    # the sweep's chunk-2 pad word moves: the nonce is no longer word 3
    "sweep_pad": (r"w\[4\] = 0x80000000u;", "w[5] = 0x80000000u;"),
    # the step writes the winner into another word
    "step_finalize": (r"m\[3\] = __byte_perm\(nonce",
                      "m[2] = __byte_perm(nonce"),
    # the step's template leaves another slot for the nonce
    "step_template": (r"__byte_perm\(bits, 0, 0x0123\), 0, 0x80000000u\}",
                      "__byte_perm(bits, 0, 0x0123), 0x80000000u, 0}"),
}


@pytest.mark.parametrize("drift", sorted(CUDA_DRIFTS))
def test_cuda_nonce_word_drift_fires_hdr004(drift, tmp_path):
    pattern, repl = CUDA_DRIFTS[drift]
    cu, line = _drift(PORT / "ops" / "csrc" / "sha256d_sweep.cu", tmp_path,
                      pattern, repl)
    port = analysis.run_all(root=ROOT, passes=["header"],
                            overrides={"cuda_src": cu})
    assert {r for _, r in lines_rules(port)} == {"HDR004"}
    assert min(ln for ln, _ in lines_rules(port)) <= line


def _drifted_capi(src: pathlib.Path, tmp_path) -> pathlib.Path:
    """The reference test's drift: cc_search loses its out-param, the
    difficulty's return widens, a cc_phantom export appears."""
    text = (src / "capi.cpp").read_text()
    drifted, n = re.subn(
        r"cc_search\([^)]*\)",
        "cc_search(const uint8_t* header80, uint64_t start_nonce,\n"
        "                   uint64_t count, uint32_t difficulty_bits)",
        text, count=1)
    assert n == 1
    drifted = drifted.replace("uint32_t cc_node_difficulty(",
                              "uint64_t cc_node_difficulty(")
    drifted = drifted.replace(
        '}  // extern "C"',
        'void cc_phantom(uint32_t x) { (void)x; }\n\n}  // extern "C"')
    tmp_path.mkdir(exist_ok=True)
    path = tmp_path / "capi.cpp"
    path.write_text(drifted)
    return path


def test_binding_twins_fire_the_same_rules_on_the_drifted_capi(tmp_path):
    ref_capi = _drifted_capi(REF / "core" / "src", tmp_path / "ref")
    port_capi = _drifted_capi(PORT / "core" / "csrc", tmp_path / "port")
    ref = ref_analysis.run_all(root=ROOT, passes=["binding"],
                               overrides={"capi": ref_capi})
    port = analysis.run_all(root=ROOT, passes=["binding"],
                            overrides={"capi": port_capi})
    assert {f.rule for f in ref} == {f.rule for f in port} == {
        "BIND001", "BIND002", "BIND004"}
    # The C side is the same file: its finding lands on the same line.
    assert {(f.line, f.rule) for f in ref if f.file == str(ref_capi)} == \
        {(f.line, f.rule) for f in port if f.file == str(port_capi)}
    by_rule = {f.rule: f.message for f in port}
    assert "cc_search" in by_rule["BIND002"]
    assert "cc_node_difficulty" in by_rule["BIND004"]
    assert "cc_phantom" in by_rule["BIND001"]


CU_EXTERN_DRIFTS = {
    # a width drift in the C interface: ctypes passes a 32-bit int
    "width": (r"int sha256d_sweep_launch\(const uint32_t\* ext, "
              r"unsigned long long base,",
              "int sha256d_sweep_launch(const uint32_t* ext, "
              "unsigned int base,", "BIND003"),
    # a parameter dropped
    "arity": (r"uint32_t\* tip_out, unsigned int height,\n\s*unsigned int "
              r"bits, void\* stream\) \{",
              "uint32_t* tip_out, unsigned int height,\n"
              "                              void* stream) {", "BIND002"),
    # a new export nobody binds
    "unbound": (r'\}  // extern "C"',
                'int sha256d_phantom(int x) { return x; }\n\n'
                '}  // extern "C"', "BIND001"),
}


@pytest.mark.parametrize("drift", sorted(CU_EXTERN_DRIFTS))
def test_drifted_cuda_extern_block_fires_its_bind_rule(drift, tmp_path):
    pattern, repl, rule = CU_EXTERN_DRIFTS[drift]
    cu, _ = _drift(PORT / "ops" / "csrc" / "sha256d_sweep.cu", tmp_path,
                   pattern, repl)
    port = analysis.run_all(root=ROOT, passes=["binding"],
                            overrides={"cuda_src": cu})
    assert {f.rule for f in port} == {rule}
    if drift == "unbound":
        # The sanitizer matrix does not cover the new entry either.
        san = analysis.run_all(root=ROOT, passes=["sanitizers"],
                               overrides={"cuda_src": cu})
        assert {f.rule for f in san} == {"SAN005"}
        assert "sha256d_phantom" in san[0].message


def test_pointer_declared_as_int_in_the_cuda_binding_fires_bind003(
        tmp_path):
    """A drifted argtype there cuts a pointer to 32 bits on the card."""
    binding, line = _drift(
        PORT / "ops" / "sha256_cuda.py", tmp_path,
        r"lib\.sha256d_block_step_launch\.argtypes = \[\n\s*ctypes\.c_void_p",
        "lib.sha256d_block_step_launch.argtypes = [\n        ctypes.c_int")
    port = analysis.run_all(root=ROOT, passes=["binding"],
                            overrides={"cuda_binding": binding})
    assert lines_rules(port) == {(line, "BIND003")}
    assert "sha256d_block_step_launch" in port[0].message


def test_cuda_binding_contract_covers_every_entry():
    """The live contract: every entry of the extern "C" block is declared
    in sha256_cuda.bind with the widths the port's convention allows."""
    cu = PORT / "ops" / "csrc" / "sha256d_sweep.cu"
    funcs = binding_contract.parse_extern_c_block(cu)
    argtypes, restypes, _ = binding_contract.parse_ctypes_assignments(
        PORT / "ops" / "sha256_cuda.py")
    assert set(funcs) == set(argtypes) and len(funcs) >= 11
    assert restypes["sha256d_sweep_resident_blocks"] == "c_longlong"
    assert funcs["sha256d_sweep_resident_blocks"].ret == "int64_t"


# ---- the port's CLI, once per family ---------------------------------------


@pytest.mark.parametrize("family", sorted(analysis.pass_families()))
def test_port_cli_runs_clean_per_family(family):
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.analysis",
         "--passes", family, "--audit-suppressions"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s) across 1 pass families" in proc.stderr
    assert "0 stale suppression(s)" in proc.stderr


def test_port_cli_json_jobs_and_since():
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.analysis",
         "--json", "--jobs", "4", "--audit-suppressions", "-q"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == [] and payload["stale_suppressions"] == []
    assert set(payload["pass_timings_ms"]) == set(analysis.pass_families())
    assert analysis.families_for_changed(
        ["mpi_blockchain_tpu_torch/resilience/dispatch.py"]) == [
        "telemetry", "resilience", "conc", "hotpath", "sync", "lock",
        "future", "thread", "trb"]
    assert analysis.families_for_changed(
        ["mpi_blockchain_tpu_torch/analysis/cparse.py"]) == \
        list(analysis.FAMILY_SCOPES)
    assert analysis.families_for_changed(["README.md"]) == []


def test_port_analysis_imports_only_the_standard_library():
    code = ("import sys\n"
            "import mpi_blockchain_tpu_torch.analysis as a\n"
            "a.pass_families()\n"
            "import mpi_blockchain_tpu_torch.analysis.__main__\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'torch', 'numpy', 'mpi_blockchain_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_reference_root_ratchets_are_untouched_by_the_port():
    assert thread_lint.BASELINE_PATH == \
        "mpi_blockchain_tpu_torch/analysis/WAITBUDGET.json"
    committed = json.loads((ROOT / thread_lint.BASELINE_PATH).read_text())
    assert committed["writer"] == thread_lint.MOVER
    assert all(p.startswith("mpi_blockchain_tpu_torch/")
               for p in committed["scope"])


# ---- the port's wait budget ------------------------------------------------


@pytest.fixture
def budget_copy(tmp_path):
    path = tmp_path / "WAITBUDGET.json"
    shutil.copyfile(ROOT / thread_lint.BASELINE_PATH, path)
    return path


def test_wait_budget_refuses_to_move_up(budget_copy):
    data = json.loads(budget_copy.read_text())
    data["static_wait_sites"] -= 1
    budget_copy.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    before = budget_copy.read_bytes()
    findings = analysis.run_all(root=ROOT, passes=["thread"],
                                overrides={"waitbudget_json": budget_copy})
    assert [f.rule for f in findings] == ["TBW001"]
    assert thread_lint.MOVER in findings[0].message
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.analysis",
         "--rebaseline-waits", "--override",
         f"waitbudget_json={budget_copy}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "refusing to rebaseline upward" in proc.stderr
    assert budget_copy.read_bytes() == before


def test_wait_budget_ratchets_down_and_the_mover_rewrites_it(budget_copy):
    committed = (ROOT / thread_lint.BASELINE_PATH).read_bytes()
    data = json.loads(budget_copy.read_text())
    data["static_wait_sites"] += 5
    data["sites"] = []
    budget_copy.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    notes = []
    assert analysis.run_all(root=ROOT, passes=["thread"], notes=notes,
                            overrides={"waitbudget_json": budget_copy}) == []
    assert any("below the budget" in n for n in notes)
    old, new, _ = thread_lint.rebaseline_waits(
        ROOT, {"waitbudget_json": budget_copy})
    assert (old, new) == (data["static_wait_sites"],
                          data["static_wait_sites"] - 5)
    assert budget_copy.read_bytes() == committed
    # The mover rewrites the file in full; on this tree it is idempotent.
    budget_copy.write_text("{}\n")
    assert analysis.run_all(root=ROOT, passes=["thread"],
                            overrides={"waitbudget_json": budget_copy}
                            )[0].rule == "TBW002"
    thread_lint.write_budget(ROOT, {"waitbudget_json": budget_copy})
    assert budget_copy.read_bytes() == committed


def test_wait_budget_sites_name_their_seams():
    data = json.loads((ROOT / thread_lint.BASELINE_PATH).read_text())
    assert data["static_wait_sites"] == len(data["sites"])
    assert {s["file"] for s in data["sites"]} <= set(thread_lint.WAIT_SEAMS)
    empty = analysis.run_all(root=ROOT, passes=["thread"],
                             overrides={"wait_files": [], "thread_files": []})
    assert [f.rule for f in empty] == ["TBW003"]


# ---- sanitizers (static here; the matrix runs on the card) -----------------


DEVICE_NOT_SUPPORTED = """\
========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported \
Devices" section of the sanitizer documentation
=========
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" \
on CUDA API call to cudaStreamCreate.
=========     Saved host backtrace up to driver entry point at error
=========
FAIL cudaStreamCreate: unknown error
========= Target application returned an error
========= ERROR SUMMARY: 2 errors
"""

OUT_OF_BOUNDS = """\
========= COMPUTE-SANITIZER
========= Invalid __global__ atomic of size 8 bytes
=========     at sha256d_sweep_kernel<1, false, false>(SweepArgs, unsigned \
int *, unsigned long long *)+0x1a0 in sha256d_sweep.cu:330
=========     by thread (0,0,0) in block (0,0,0)
=========     Address 0x7f0000000008 is out of bounds
=========
========= Invalid __global__ write of size 4 bytes
=========     at block_step_kernel<false>(...)+0x40 in sha256d_sweep.cu:600
=========
========= ERROR SUMMARY: 2 errors
"""


def test_sanitizer_reports_parse_into_verdicts():
    unusable = sanitizers.parse_report(DEVICE_NOT_SUPPORTED)
    assert unusable["tool_error"].startswith("Error: Device not supported")
    assert unusable["summary"] and unusable["errors"] == 1
    oob = sanitizers.parse_report(OUT_OF_BOUNDS)
    assert oob["tool_error"] is None and oob["errors"] == 2
    assert oob["by_kernel"] == {"sha256d_sweep": 1, "sha256d_block_step": 1,
                                "ext_symbol_copy": 0, "other": 0}
    race = sanitizers.parse_report(
        "========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, "
        "0 warnings)\n")
    assert race["summary"] and race["errors"] == 0


def test_sanitizer_pass_notes_a_missing_tool_and_checks_coverage(
        tmp_path, monkeypatch):
    monkeypatch.setattr(sanitizers, "find_nvcc", lambda: None)
    notes = []
    assert analysis.run_all(root=ROOT, passes=["sanitizers"],
                            notes=notes) == []
    assert any("nvcc not found" in n for n in notes)
    assert sanitizers.run_matrix(ROOT)["status"] == "no_nvcc"
    driver, line = _drift(PORT / sanitizers.DRIVER_SOURCE, tmp_path,
                          r"sha256d_sweep_block_threads\(\)",
                          "kBlock")
    found = analysis.run_all(root=ROOT, passes=["sanitizers"],
                             overrides={"sanitize_driver": driver})
    assert [(f.rule, "sha256d_sweep_block_threads" in f.message)
            for f in found] == [("SAN005", True)]
    missing = analysis.run_all(
        root=ROOT, passes=["sanitizers"],
        overrides={"sanitize_driver": tmp_path / "nope.cu"})
    assert [f.rule for f in missing] == ["SAN001"]


@pytest.mark.cuda
def test_sanitizer_matrix_on_the_card():
    """The driver's known answers hold on the card; every tool that can
    check there reports no error and catches its poisoned run."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = sanitizers.run_matrix(ROOT)
    assert result["status"] in ("ok", "tool_unusable"), result["reason"]
    assert result["plain"]["rc"] == 0
    assert result["plain"]["cases_failed"] == 0
    for key, v in result["poisoned"].items():
        assert v["errors"] >= 1, key


# ---- the faults the port's passes found, repaired --------------------------


class _CardStub(MinerBackend):
    """A rung whose started search stays "on the card" until ``gate``."""
    name = "stub"

    def __init__(self):
        self.gate, self.polled = threading.Event(), threading.Event()

    def search(self, header80, difficulty_bits, start_nonce=0,
               max_count=1 << 32):
        return SearchResult(None, None, max_count)

    def launch(self, header80, difficulty_bits, start_nonce=0,
               max_count=1 << 32):
        def finish():
            return SearchResult(None, None, max_count)

        def ready():
            self.polled.set()
            return self.gate.is_set()
        finish.ready = ready
        return finish


def test_ladder_lock_is_not_held_across_a_wait_on_the_card():
    """LCK002 at resilience/dispatch.py: a consume that waits for its sweep
    on the card must not hold the ladder lock, or every other taker (an
    issue on another thread) stalls behind the sweep."""
    stub = _CardStub()
    backend = ResilientBackend([("stub", lambda: stub)])
    first = backend.search_async(bytes(80), 8, 0, 1)
    consumer = threading.Thread(
        target=lambda: first.result(timeout=30), daemon=True)
    consumer.start()
    assert stub.polled.wait(10)
    issued = threading.Event()
    second = []

    def issue():
        second.append(backend.search_async(bytes(80), 8, 1, 1))
        issued.set()
    threading.Thread(target=issue, daemon=True).start()
    issued_while_waiting = issued.wait(2.0)
    stub.gate.set()
    consumer.join(10)
    assert issued_while_waiting
    assert first.result(timeout=5).hashes_tried == 1
    assert second[0].result(timeout=5).hashes_tried == 1


def test_bench_cpu_rank_counter_goes_through_rank_counter(monkeypatch):
    """TEL003 at bench_lib.py: the per-rank counter is labelled through
    ``rank_counter``, as the reference's bench_cpu does."""
    calls = {}
    for mod, key in ((bench_lib, "port"), (ref_bench, "ref")):
        seen = calls.setdefault(key, [])
        real = mod.rank_counter

        def spy(name, *a, _real=real, _seen=seen, **kw):
            _seen.append((name, kw.get("rank"), kw.get("backend")))
            return _real(name, *a, **kw)
        monkeypatch.setattr(mod, "rank_counter", spy)
        mod.bench_cpu(seconds=0.02, n_miners=2, chunk=1 << 10)
    assert sorted(calls["port"]) == sorted(calls["ref"]) == [
        ("bench_rank_hashes_total", 0, "cpu"),
        ("bench_rank_hashes_total", 1, "cpu")]
