"""The port's SHD003 (``mpi_blockchain_tpu_torch.analysis.shard_lint``)
against the reference's (``mpi_blockchain_tpu.analysis.shard_lint``), and
the fused world's round plan, the cross-function case the rule's
per-function taint cannot see.

Twin fixtures — the JAX form for the reference, its ``torch.distributed``
form for the port, line for line — must fire SHD003 at the same lines:
a rank into the size of a tensor, into a reshape or view, into the trip
count of a loop that enters a collective, and ``world.index()`` as a
producer; rank arithmetic on the host fires in neither. The reference's
static-argument sink has no port form. The live port raises nothing and
its pass sees every rank producer of the scope; a mutated copy of
``models/fused.py`` fires.

The round plan (``models.fused.world_slices``): every rank of a world
enters the same number of winner-selects and the ranks' slices tile
[0, cap), over the whole range of worlds, batches and caps; before the
repair a world of 3 ranks at 2^24 with ``max_rounds=1000`` gave its ranks
86, 85 and 85 rounds, and rank 0 waited alone in its last all-reduce.
"""
import ast
import pathlib
import textwrap

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from mpi_blockchain_tpu.analysis import run_all as ref_run_all
from mpi_blockchain_tpu.analysis import shard_lint as ref_shard
from mpi_blockchain_tpu_torch import analysis
from mpi_blockchain_tpu_torch.analysis import shard_lint
from mpi_blockchain_tpu_torch.models import fused
from mpi_blockchain_tpu_torch.ops import sha256_block

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "mpi_blockchain_tpu_torch"
FUSED = PKG / "models" / "fused.py"
NONCE_SPACE = 1 << 32
NOT_FOUND = 0xFFFFFFFF


def _write(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    return path


def ref_findings(tmp_path, text):
    path = _write(tmp_path, text, "ref_mod.py")
    return ref_shard.run_shard_lint(ROOT, overrides={"shard_files": [path]})


def port_findings(tmp_path, text):
    path = _write(tmp_path, text, "port_mod.py")
    return shard_lint.run_shard_lint(ROOT, overrides={"shard_files": [path]})


def line_rules(findings):
    return sorted((f.line, f.rule) for f in findings)


# Each pair: (JAX form for the reference, torch form for the port,
# expected (line, rule) in both).
TWINS = {
    "shape": ("""\
        import jax
        import jax.numpy as jnp


        def launch(base):
            rank = jax.process_index()
            buf = jnp.zeros(rank + 4)
            return base, buf
        """, """\
        import torch
        import torch.distributed as dist


        def launch(base):
            rank = dist.get_rank()
            buf = torch.zeros(rank + 4)
            return base, buf
        """, [(7, "SHD003")]),
    "shape_keyword": ("""\
        import jax
        import numpy as np


        def launch(base):
            width = jax.process_index() * 2
            return np.empty(shape=width)
        """, """\
        import torch
        import torch.distributed as dist


        def launch(base):
            width = dist.get_rank() * 2
            return torch.empty(size=width)
        """, [(7, "SHD003")]),
    "reshape": ("""\
        import jax


        def split(x):
            rank = jax.process_index()
            return x.reshape(rank + 1, -1)
        """, """\
        import torch.distributed as dist


        def split(x, group):
            rank = dist.get_rank(group)
            return x.view(rank + 1, -1)
        """, [(6, "SHD003")]),
    "trip_count": ("""\
        import jax
        import jax.numpy as jnp


        def rounds(count, axis_name):
            rank = jax.process_index()
            for _ in range(rank + 1):
                count = jax.lax.psum(count, axis_name)
            return count
        """, """\
        import torch.distributed as dist
        from mpi_blockchain_tpu_torch.parallel.mesh import winner_select


        def rounds(count, group):
            rank = dist.get_rank(group)
            for _ in range(rank + 1):
                count = winner_select(count, 0xFFFFFFFF, group)
            return count
        """, [(7, "SHD003")]),
    "trip_count_through_a_local_function": ("""\
        import jax


        @jax.jit
        def step(count):
            return count + 1


        def rounds(count, world):
            for _ in range(world.index()):
                count = step(count)
            return count
        """, """\
        import torch.distributed as dist


        def step(count):
            dist.all_reduce(count)
            return count


        def rounds(count, world):
            for _ in range(world.index()):
                count = step(count)
            return count
        """, [(10, "SHD003")]),
    "world_index_producer": ("""\
        import jax.numpy as jnp


        def stripe(world, width):
            return jnp.arange(world.index() * width)
        """, """\
        import torch


        def stripe(world, width):
            return torch.arange(world.index() * width)
        """, [(5, "SHD003")]),
    "rank_in_host_math": ("""\
        import jax
        import jax.numpy as jnp


        def stripe_base(width):
            rank = jax.process_index()
            start = rank * width
            log = [start]
            for _ in range(rank):
                log.append(start)
            return jnp.uint32(start)
        """, """\
        import torch
        import torch.distributed as dist


        def stripe_base(width):
            rank = dist.get_rank()
            start = rank * width
            log = [start]
            for _ in range(rank):
                log.append(start)
            return torch.tensor(start)
        """, []),
    "syntax_error": ("def broken(:\n", "def broken(:\n", [(1, "SHD000")]),
}


@pytest.mark.parametrize("case", sorted(TWINS))
def test_twins_fire_the_same_rules_at_the_same_lines(case, tmp_path):
    jax_text, torch_text, want = TWINS[case]
    assert line_rules(ref_findings(tmp_path, jax_text)) == want
    assert line_rules(port_findings(tmp_path, torch_text)) == want


def test_messages_name_the_source_and_the_sink(tmp_path):
    shape, view, loop = (port_findings(tmp_path, TWINS[c][1])[0].message
                         for c in ("shape", "reshape", "trip_count"))
    assert "'rank'" in shape and "'torch.zeros'" in shape
    assert "'.view()'" in view
    assert "trip count" in loop and "world_slices" in loop
    index = port_findings(tmp_path, TWINS["world_index_producer"][1])
    assert "world.index" in index[0].message


def test_get_rank_is_a_producer_the_reference_does_not_see(tmp_path):
    """The reference's vocabulary lacks torch's spelling of the rank."""
    torch_text = TWINS["shape"][1]
    assert ref_findings(tmp_path, torch_text) == []
    assert line_rules(port_findings(tmp_path, torch_text)) == [(7, "SHD003")]


def test_self_index_inside_a_world_class_is_a_producer(tmp_path):
    text = """\
        import torch


        class ElasticWorld:
            def stripe(self, width):
                return torch.arange(self.index() * width)


        class Catalog:
            def stripe(self, width):
                return torch.arange(self.index() * width)
        """
    assert line_rules(port_findings(tmp_path, text)) == [(6, "SHD003")]


def test_a_loop_that_enters_no_collective_is_clean(tmp_path):
    findings = port_findings(tmp_path, """\
        import functools
        import torch
        import torch.distributed as dist


        def local_work(xs):
            rank = dist.get_rank()
            for _ in range(rank):
                xs = functools.reduce(lambda a, b: a + b, [xs, xs])
                xs = torch.gather(xs, 0, xs)
            return xs
        """)
    assert findings == []


BAD_SHD003 = textwrap.dedent("""\
    import functools

    import jax
    import jax.numpy as jnp


    @functools.partial(jax.jit, static_argnames=("n_rounds",))
    def sweep(base, n_rounds):
        return base * n_rounds


    def launch(base):
        rank = jax.process_index()
        out = sweep(base, n_rounds=rank + 1)
        buf = jnp.zeros(rank + 4)
        for _ in range(rank):
            out = sweep(out, n_rounds=2)
        return out, buf
    """)

BAD_SHD003_TORCH = textwrap.dedent("""\
    import functools

    import torch
    import torch.distributed as dist


    @functools.cache
    def sweep(base, n_rounds):
        return base * n_rounds


    def launch(base, group):
        rank = dist.get_rank(group)
        out = sweep(base, n_rounds=rank + 1)
        buf = torch.zeros(rank + 4)
        for _ in range(rank):
            out = dist.all_reduce(out)
        return out, buf
    """)


def test_the_static_argument_sink_is_the_by_design_difference(tmp_path):
    """The reference fires on a rank into a traced function's static
    argument (line 14); the port has no traced functions with static
    arguments, so the same line of the torch form is host code and clean,
    and its other two sinks fire as the reference's."""
    ref = line_rules(ref_findings(tmp_path, BAD_SHD003))
    port = line_rules(port_findings(tmp_path, BAD_SHD003_TORCH))
    assert ref == [(14, "SHD003"), (15, "SHD003"), (16, "SHD003")]
    assert port == [(15, "SHD003"), (16, "SHD003")]
    static = [f for f in ref_findings(tmp_path, BAD_SHD003) if f.line == 14]
    assert "static argument 'n_rounds'" in static[0].message


def test_the_live_port_is_clean_and_sees_every_rank_producer():
    assert shard_lint.run_shard_lint(ROOT) == []
    seen = {}
    for path in shard_lint._default_files(ROOT):
        found = shard_lint.rank_producers(ast.parse(path.read_text()))
        if found:
            lines = path.read_text().splitlines()
            assert all(p.split(".")[-1] in lines[n - 1] for n, p in found)
            seen[str(path.relative_to(PKG))] = [p for _, p in found]
    assert seen == {
        "backend/cuda.py": ["dist.get_rank"],
        "cli.py": ["dist.get_rank", "dist.get_rank"],
        "models/fused.py": ["dist.get_rank"],
        "parallel/distributed.py": ["dist.get_rank"],
        "resilience/elastic.py": ["self.index"],
    }


def test_the_scope_is_the_spmd_passs_and_the_elastic_file():
    rels = {str(p.relative_to(PKG)) for p in shard_lint._default_files(ROOT)}
    assert {"parallel/mesh.py", "parallel/distributed.py", "models/fused.py",
            "models/miner.py", "backend/cuda.py", "cli.py",
            "tools/world_turns.py", "resilience/elastic.py"} <= rels
    assert analysis.FAMILY_SCOPES["shard"] == analysis.FAMILY_SCOPES["spmd"]
    assert analysis.RULE_FAMILIES["SHD"] == "shard"
    assert "shard" in analysis.pass_families()


def test_a_mutated_fused_py_fires(tmp_path):
    text = FUSED.read_text()
    anchor = "        slices = world_slices("
    assert text.count(anchor) == 1
    mutated = text.replace(anchor, (
        "        for _ in range(dist.get_rank(group) + 1):\n"
        "            winner_select(0, 0xFFFFFFFF, group)\n" + anchor))
    path = tmp_path / "fused.py"
    path.write_text(mutated)
    line = mutated.splitlines().index(
        "        for _ in range(dist.get_rank(group) + 1):") + 1
    findings = shard_lint.run_shard_lint(ROOT, overrides={
        "shard_files": [path]})
    assert line_rules(findings) == [(line, "SHD003")]


def test_suppression_override_and_the_cli_as_the_reference(tmp_path):
    torch_text = textwrap.dedent(TWINS["shape"][1])
    jax_text = textwrap.dedent(TWINS["shape"][0])
    for text, sink, run in (
            (torch_text, "torch.zeros(rank + 4)", analysis.run_all),
            (jax_text, "jnp.zeros(rank + 4)", ref_run_all)):
        path = tmp_path / "mod.py"
        path.write_text(text.replace(
            sink, sink + "  # chainlint: disable=SHD003"))
        assert run(root=ROOT, passes=["shard"],
                   overrides={"shard_files": [path]}) == []
        path.write_text(text)
        assert line_rules(run(root=ROOT, passes=["shard"], overrides={
            "shard_files": [path]})) == [(7, "SHD003")]
    from mpi_blockchain_tpu_torch.analysis.__main__ import (OVERRIDE_KEYS,
                                                            main)
    assert "shard_files" in OVERRIDE_KEYS
    path.write_text(torch_text)
    assert main(["--passes", "shard", "-q", "--override",
                 f"shard_files={path}"]) == 1


# ---- the fused world's round plan ------------------------------------------


def _plans(n_miners, batch_pow2, max_rounds):
    cap = fused.sweep_cap(batch_pow2, max_rounds, n_miners)
    return cap, [fused.world_slices(i, n_miners, batch_pow2, cap)
                 for i in range(n_miners)]


@settings(max_examples=300, deadline=None)
@given(n_miners=st.integers(1, 8), batch_pow2=st.integers(0, 32),
       max_rounds=st.none() | st.integers(1, NONCE_SPACE))
@example(n_miners=3, batch_pow2=24, max_rounds=1000)
@example(n_miners=5, batch_pow2=24, max_rounds=1000)
@example(n_miners=2, batch_pow2=32, max_rounds=1)
def test_every_rank_has_the_same_rounds_and_the_slices_tile_the_cap(
        n_miners, batch_pow2, max_rounds):
    cap, plans = _plans(n_miners, batch_pow2, max_rounds)
    batch = 1 << batch_pow2
    rounds = {len(p) for p in plans}
    assert len(rounds) == 1
    (n_rounds,) = rounds
    assert n_rounds * n_miners * batch >= cap > (n_rounds - 1) * n_miners \
        * batch or cap == n_rounds == 0

    def starts(r):
        return [p.start(r) for p in plans]

    # Rounds before the last are whole (starts grow with r, so the second
    # to last standing whole means every earlier one is); the last holds
    # the slices that start below cap, lowest ranks first.
    if n_rounds >= 2:
        assert None not in starts(n_rounds - 2)
    if n_rounds:
        last = starts(n_rounds - 1)
        held = [s for s in last if s is not None]
        assert last == held + [None] * (n_miners - len(held))
        assert ((n_rounds - 1) * n_miners + len(held)) * batch == cap
    # Within a round the slices are B apart from the round's first nonce,
    # so no two overlap, and every one ends at or below cap.
    for r in {0, n_rounds // 2, n_rounds - 1} - {-1}:
        for i, s in enumerate(starts(r)):
            assert s is None or (s == (r * n_miners + i) * batch
                                 and s + batch <= cap)
    if cap // batch <= 4096:
        got = sorted(s for r in range(n_rounds) for s in starts(r)
                     if s is not None)
        assert got == list(range(0, cap, batch))


def _world_selects(monkeypatch, n_miners, batch_pow2, max_rounds):
    """Each rank's winner-selects and slices over one block of a world
    whose slices find nothing, rank after rank in this process (the sweep
    and the select stubbed: what is counted is the plan's)."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: n_miners)
    launched, selects = [], []
    monkeypatch.setattr(sha256_block, "slice_launch",
                        lambda scratch, base, count, bits: launched[-1]
                        .append((base, count)) or (lambda: (0, NOT_FOUND)))
    monkeypatch.setattr(fused, "winner_select",
                        lambda count, best, group: selects[-1].append(
                            (count, best)) or (count, best))
    prev = torch.zeros(8, dtype=torch.uint32)
    data = torch.from_numpy(np.arange(8, dtype=np.uint32)).reshape(1, 8)
    for rank in range(n_miners):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=rank: r)
        launched.append([])
        selects.append([])
        fn = fused.make_fused_miner(1, batch_pow2, 64, kernel="torch",
                                    device="cpu", max_rounds=max_rounds,
                                    n_miners=n_miners, group=object())
        call, _ = fn(prev, data, 0)
        assert call.wait() == [NOT_FOUND]
    return selects, launched


@pytest.mark.parametrize("n_miners,rounds", [(3, 86), (5, 52)])
def test_every_rank_of_a_world_enters_every_winner_select(
        monkeypatch, n_miners, rounds):
    selects, launched = _world_selects(monkeypatch, n_miners, 24, 1000)
    assert [len(s) for s in selects] == [rounds] * n_miners
    # A rank with no slice in the last round launched nothing and brought
    # the neutral pair; the launched slices tile the nonce space.
    assert [len(slices) for slices in launched] == \
        [rounds] + [rounds - 1] * (n_miners - 1)
    assert all(s[-1] == (0, NOT_FOUND) for s in selects)
    assert sorted(b for slices in launched for b, _ in slices) == \
        list(range(0, NONCE_SPACE, 1 << 24))
    assert {c for slices in launched for _, c in slices} == {1 << 24}
