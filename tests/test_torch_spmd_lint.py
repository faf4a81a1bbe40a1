"""The port's SPMD pass (``mpi_blockchain_tpu_torch.analysis.spmd_lint``)
against the reference's (``mpi_blockchain_tpu.analysis.spmd_lint``).

Twin fixtures — the JAX form for the reference, its ``torch.distributed``
form for the port, line for line — must fire the same rule ids at the same
lines. The reference's vocabulary misses torch's spelling of rank
(``get_rank``), so on the torch form of a rank-conditional collective it
raises nothing; the port raises SPMD001. SPMD002 has no port counterpart
(gloo collectives carry no axis name). The live port is clean, and the
live elastic file's ``guarded_collective`` idiom is recognized.
"""
import pathlib
import re
import textwrap

import pytest

from mpi_blockchain_tpu.analysis import spmd_lint as ref_spmd
from mpi_blockchain_tpu_torch import analysis
from mpi_blockchain_tpu_torch.analysis import spmd_lint

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESH_PY = ROOT / "mpi_blockchain_tpu" / "parallel" / "mesh.py"
ELASTIC = ROOT / "mpi_blockchain_tpu_torch" / "resilience" / "elastic.py"


def _write(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    return path


def ref_findings(tmp_path, text, elastic=False):
    path = _write(tmp_path, text, "ref_mod.py")
    key = "elastic_files" if elastic else "spmd_files"
    other = "spmd_files" if elastic else "elastic_files"
    return ref_spmd.run_spmd_lint(ROOT, overrides={
        key: [path], other: [], "mesh_py": MESH_PY,
        "jax_files": []})


def port_findings(tmp_path, text, elastic=False):
    path = _write(tmp_path, text, "port_mod.py")
    key = "elastic_files" if elastic else "spmd_files"
    other = "spmd_files" if elastic else "elastic_files"
    return spmd_lint.run_spmd_lint(ROOT, overrides={key: [path],
                                                    other: []})


def line_rules(findings):
    return sorted((f.line, f.rule) for f in findings)


# Each pair: (JAX form for the reference, torch form for the port,
# expected (line, rule) in both).
TWINS = {
    "rank_conditional_and_swallowed_init": ("""\
        import jax


        def broken_winner(count):
            if jax.process_index() == 0:
                total = jax.lax.psum(count, "miners")
            else:
                total = 0
            return total


        def swallowed_init():
            try:
                jax.distributed.initialize()
            except Exception:
                return None


        def fine(x):
            try:
                y = jax.lax.psum(x, "miners")
            except Exception:
                raise
            return y
        """, """\
        import torch.distributed as dist


        def broken_winner(count):
            if dist.get_rank() == 0:
                total = dist.all_reduce(count)
            else:
                total = 0
            return total


        def swallowed_init():
            try:
                dist.init_process_group("gloo")
            except Exception:
                return None


        def fine(x):
            try:
                y = dist.all_reduce(x)
            except Exception:
                raise
            return y
        """, [(6, "SPMD001"), (14, "SPMD003")]),
    "wrapper_propagates": ("""\
        import jax


        def winner_select(c):
            return jax.lax.psum(c, "miners")


        def driver(c, rank):
            if rank == 0:
                return winner_select(c)
            return 0
        """, """\
        import torch.distributed as dist


        def select(c):
            return dist.all_reduce(c)


        def driver(c, rank):
            if rank == 0:
                return select(c)
            return 0
        """, [(10, "SPMD001")]),
    "rendezvous_under_swallowing_try": ("""\
        from mpi_blockchain_tpu.parallel.distributed import init_distributed


        def bring_up(coordinator, n, i):
            try:
                return init_distributed(coordinator, n, i)
            except Exception:
                return None
        """, """\
        from mpi_blockchain_tpu_torch.parallel.distributed import init_distributed


        def bring_up(coordinator, n, i):
            try:
                return init_distributed(coordinator, n, i)
            except Exception:
                return None
        """, [(6, "SPMD003")]),
    "reraising_handler_is_clean": ("""\
        import jax


        def cleanup_then_raise(x, writer):
            try:
                return jax.lax.psum(x, "miners")
            except BaseException:
                writer.abort()
                raise
        """, """\
        import torch.distributed as dist


        def cleanup_then_raise(x, writer):
            try:
                return dist.all_reduce(x)
            except BaseException:
                writer.abort()
                raise
        """, []),
    "retry_in_handler": ("""\
        import jax


        def retry_alone(x):
            try:
                return jax.lax.psum(x, "miners")
            except RuntimeError:
                return jax.lax.psum(x, "miners")
        """, """\
        import torch.distributed as dist


        def retry_alone(x):
            try:
                return dist.all_reduce(x)
            except RuntimeError:
                return dist.all_reduce(x)
        """, [(6, "SPMD003"), (8, "SPMD003")]),
    "bare_from_import": ("""\
        from jax.distributed import initialize


        def join(rank):
            if rank == 0:
                initialize()


        def harmless(engine):
            engine.initialize()
        """, """\
        from torch.distributed import barrier


        def join(rank):
            if rank == 0:
                barrier()


        def harmless(engine):
            engine.barrier()
        """, [(6, "SPMD001")]),
    "syntax_error": ("def broken(:\n", "def broken(:\n", [(1, "SPMD000")]),
}


@pytest.mark.parametrize("case", sorted(TWINS))
def test_twins_fire_the_same_rules_at_the_same_lines(case, tmp_path):
    jax_text, torch_text, want = TWINS[case]
    assert line_rules(ref_findings(tmp_path, jax_text)) == want
    assert line_rules(port_findings(tmp_path, torch_text)) == want


def test_get_rank_guard_fires_spmd001_where_the_reference_sees_nothing(
        tmp_path):
    fixture = """\
        import torch.distributed as dist


        def rank_zero_only(t):
            if dist.get_rank() == 0:
                dist.all_reduce(t)
        """
    assert ref_findings(tmp_path, fixture) == []
    port = port_findings(tmp_path, fixture)
    assert line_rules(port) == [(6, "SPMD001")]
    assert "get_rank" in port[0].message and "all_reduce" in port[0].message


@pytest.mark.parametrize("test,line", [
    ("dist.get_rank(group) == 0", 6), ("group.rank() != 0", 6),
    ("self.rank == 0", 6), ("is_main", 6), ("process_id == 1", 6)])
def test_torch_rank_tests_guard_collectives(test, line, tmp_path):
    findings = port_findings(tmp_path, f"""\
        import torch.distributed as dist


        def step(self, t, group, is_main, process_id):
            if {test}:
                dist.broadcast(t, 0)
        """)
    assert line_rules(findings) == [(line, "SPMD001")]


def test_names_derived_from_a_rank_test_are_rank_tests(tmp_path):
    findings = port_findings(tmp_path, """\
        import torch.distributed as dist


        def last_rank_gathers(t, rows):
            last = dist.get_rank() == dist.get_world_size() - 1
            tail = last and t is not None
            if tail:
                dist.all_gather(rows, t)
            if dist.get_world_size() > 1:
                dist.all_gather(rows, t)
        """)
    # The world's size alone is the same on every rank: no finding.
    assert line_rules(findings) == [(8, "SPMD001")]


def test_non_collectives_with_collective_names_are_not_flagged(tmp_path):
    findings = port_findings(tmp_path, """\
        import functools
        import torch


        def rank_local_math(rank, xs, idx):
            if rank == 0:
                total = functools.reduce(lambda a, b: a + b, xs)
                picked = torch.gather(xs, 0, idx)
                return total, picked
            return None
        """)
    assert findings == []


def test_aliased_module_and_group_api_are_collectives(tmp_path):
    findings = port_findings(tmp_path, """\
        import torch.distributed as tdist
        from torch import distributed as d2


        def f(rank, t):
            if rank:
                tdist.all_reduce(t)
                d2.new_group([0, 1])
        """)
    assert line_rules(findings) == [(7, "SPMD001"), (8, "SPMD001")]


def test_inline_suppression_and_the_cli(tmp_path):
    text = textwrap.dedent(TWINS["rank_conditional_and_swallowed_init"][1])
    suppressed = text.replace(
        "total = dist.all_reduce(count)",
        "total = dist.all_reduce(count)  # chainlint: disable=SPMD001")
    path = tmp_path / "mod.py"
    path.write_text(suppressed)
    findings = analysis.run_all(root=ROOT, passes=["spmd"], overrides={
        "spmd_files": [path], "elastic_files": []})
    assert line_rules(findings) == [(14, "SPMD003")]
    from mpi_blockchain_tpu_torch.analysis.__main__ import (OVERRIDE_KEYS,
                                                            main)
    assert {"spmd_files", "elastic_files"} <= set(OVERRIDE_KEYS)
    assert main(["--passes", "spmd", "-q", "--override",
                 f"spmd_files={path}"]) == 1


# ---- SPMD004: the elastic file ---------------------------------------------


ELASTIC_TWINS = {
    "unguarded_collectives": ("""\
        import jax
        from mpi_blockchain_tpu.parallel.mesh import make_miner_mesh
        from mpi_blockchain_tpu.resilience.elastic import guarded_collective


        def naked_winner(count):
            return jax.lax.psum(count, "miners")


        def naked_rebuild(n):
            return make_miner_mesh(n)


        def guarded_rebuild(n):
            return guarded_collective(lambda: make_miner_mesh(n),
                                      site="mesh.rebuild")
        """, """\
        import torch.distributed as dist
        from mpi_blockchain_tpu_torch.parallel.distributed import init_distributed
        from mpi_blockchain_tpu_torch.resilience.elastic import guarded_collective


        def naked_winner(count):
            return dist.all_reduce(count)


        def naked_rebuild(n):
            return init_distributed("127.0.0.1:1", n, 0)


        def guarded_rebuild(n):
            return guarded_collective(lambda: init_distributed("h:1", n, 0),
                                      site="mesh.rebuild")
        """, [(7, "SPMD004"), (11, "SPMD004")]),
    "one_hop_rendezvous_idiom": ("""\
        import jax
        from mpi_blockchain_tpu.resilience.elastic import \\
            guarded_collective


        def _rendezvous(c):
            return jax.lax.psum(c, "miners")


        def shrink(c):
            return guarded_collective(lambda: _rendezvous(c),
                                      site="winner_select")
        """, """\
        import torch.distributed as dist
        from mpi_blockchain_tpu_torch.resilience.elastic import \\
            guarded_collective


        def _rendezvous(c):
            return dist.all_reduce(c)


        def shrink(c):
            return guarded_collective(lambda: _rendezvous(c),
                                      site="winner_select")
        """, []),
    "eager_guard_argument": ("""\
        import jax
        from mpi_blockchain_tpu.resilience.elastic import \\
            guarded_collective


        def _rendezvous(c):
            return jax.lax.psum(c, "miners")


        def shrink(c):
            return guarded_collective(_rendezvous(c),
                                      site="winner_select")


        def direct(c):
            return guarded_collective(
                jax.lax.pmin(c, "miners"))
        """, """\
        import torch.distributed as dist
        from mpi_blockchain_tpu_torch.resilience.elastic import \\
            guarded_collective


        def _rendezvous(c):
            return dist.all_reduce(c)


        def shrink(c):
            return guarded_collective(_rendezvous(c),
                                      site="winner_select")


        def direct(c):
            return guarded_collective(
                dist.barrier())
        """, [(7, "SPMD004"), (17, "SPMD004")]),
    "elastic_files_exempt_from_spmd_001_003": ("""\
        import jax
        from mpi_blockchain_tpu.resilience.elastic import \\
            guarded_collective


        def recover(c, rank):
            try:
                if rank == 0:
                    return guarded_collective(
                        lambda: jax.lax.psum(c, "miners"))
            except Exception:
                return None
        """, """\
        import torch.distributed as dist
        from mpi_blockchain_tpu_torch.resilience.elastic import \\
            guarded_collective


        def recover(c, rank):
            try:
                if rank == 0:
                    return guarded_collective(
                        lambda: dist.all_reduce(c))
            except Exception:
                return None
        """, []),
}


@pytest.mark.parametrize("case", sorted(ELASTIC_TWINS))
def test_elastic_twins_fire_the_same_rules_at_the_same_lines(case,
                                                             tmp_path):
    jax_text, torch_text, want = ELASTIC_TWINS[case]
    assert line_rules(ref_findings(tmp_path, jax_text, elastic=True)) == want
    assert line_rules(port_findings(tmp_path, torch_text,
                                    elastic=True)) == want


def test_one_hop_idiom_rearms_on_one_unguarded_call_site(tmp_path):
    clean = textwrap.dedent(
        ELASTIC_TWINS["one_hop_rendezvous_idiom"][1])
    leaky = clean + textwrap.dedent("""\


        def sidestep(c):
            return _rendezvous(c)
        """)
    assert line_rules(port_findings(tmp_path, leaky, elastic=True)) == [
        (7, "SPMD004")]


def test_disable_file_suppresses_spmd004(tmp_path):
    text = textwrap.dedent(ELASTIC_TWINS["unguarded_collectives"][1])
    path = tmp_path / "elastic_mod.py"
    path.write_text("# chainlint: disable-file=SPMD004\n" + text)
    assert analysis.run_all(root=ROOT, passes=["spmd"], overrides={
        "elastic_files": [path], "spmd_files": []}) == []


def test_the_live_port_is_clean_and_scoped_to_its_world_code():
    assert spmd_lint.run_spmd_lint(ROOT) == []
    rels = {str(p.relative_to(ROOT))
            for p in spmd_lint._scoped_files(ROOT)}
    pkg = "mpi_blockchain_tpu_torch"
    assert {f"{pkg}/parallel/mesh.py", f"{pkg}/parallel/distributed.py",
            f"{pkg}/models/fused.py", f"{pkg}/models/miner.py",
            f"{pkg}/backend/cuda.py", f"{pkg}/cli.py",
            f"{pkg}/tools/world_turns.py"} <= rels
    assert spmd_lint._default_elastic_files(ROOT) == [ELASTIC]


def test_the_live_elastic_idiom_is_recognized_as_guarded(tmp_path):
    """The elastic file's searcher build is no gloo rendezvous, so the live
    file is trivially clean; read as one (``get_backend`` spelled as the
    port's ``init_distributed``), its ``guarded_collective(lambda: ...)``
    sites still pass, and dropping one lambda fires SPMD004 where the
    rendezvous runs."""
    text = ELASTIC.read_text()
    assert text.count("return get_backend(") == 1
    as_rendezvous = text.replace("return get_backend(",
                                 "return init_distributed(")
    assert port_findings(tmp_path, as_rendezvous, elastic=True) == []
    eager = re.sub(r"guarded_collective\(\s*lambda: self\._rendezvous",
                   "guarded_collective(self._rendezvous", as_rendezvous,
                   count=1)
    assert eager != as_rendezvous
    rendezvous_line = next(
        i for i, ln in enumerate(eager.splitlines(), 1)
        if "return init_distributed(" in ln)
    assert line_rules(port_findings(tmp_path, eager, elastic=True)) == [
        (rendezvous_line, "SPMD004")]


def test_the_vocabulary_sees_every_live_collective_of_the_scope():
    """The live port's 0 findings mean something: the pass sees each of
    the world code's collectives and rendezvous (the reference's
    vocabulary sees none of the torch ones)."""
    import ast

    seen = {}
    for path in spmd_lint._scoped_files(ROOT):
        tree = ast.parse(path.read_text())
        vocab = spmd_lint._Vocabulary(tree)
        ops = sorted(op for node in ast.walk(tree)
                     if isinstance(node, ast.Call)
                     and (op := vocab.op(node)) is not None)
        if ops:
            seen[str(path.relative_to(ROOT / "mpi_blockchain_tpu_torch"))] = ops
    assert seen == {
        "backend/cuda.py": ["winner_select"],
        "cli.py": ["all_gather", "init_distributed"],
        "models/fused.py": ["winner_select"],
        "parallel/distributed.py": ["init_process_group"],
        "parallel/mesh.py": ["all_reduce", "all_reduce"],
        "tools/world_turns.py": ["init_process_group", "winner_select",
                                 "winner_select"],
    }
