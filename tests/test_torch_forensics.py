"""The port's forensics reader against the reference's, on the CPU.

The dumps come from the port's own ``sim --events-dump`` (the reference's
bytes for the same run): the config-5 bus at two seeds, and the
adversarial scenario preset, whose dump carries the ``attack_*``
vocabulary. On each, the port's ``analyze_dump``, Chrome trace and
``forensics`` CLI output (``--json``, the human report and ``--trace``)
must equal the reference's exactly; the trace differs only in the
``metadata.source`` string, which names the package that wrote it. An
unreadable dump exits 2 in both.
"""
import contextlib
import io
import json

import pytest

from mpi_blockchain_tpu import forensics as ref_forensics
from mpi_blockchain_tpu.forensics import __main__ as ref_forensics_cli
from mpi_blockchain_tpu_torch import cli, forensics, telemetry
from mpi_blockchain_tpu_torch.forensics import __main__ as forensics_cli
from mpi_blockchain_tpu_torch.forensics import merge, trace_export

SIM = ["sim", "--backend", "cpu", "--blocks", "4", "--partition-steps",
       "10", "--drop-rate", "10", "--groups", "3"]
DUMPS = {
    "bus_seed3": SIM + ["--seed", "3"],
    "bus_seed7": SIM + ["--seed", "7"],
    "adversarial": ["sim", "--preset", "adversarial-smoke"],
}


def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dumps")
    out = {}
    for name, argv in DUMPS.items():
        telemetry.reset()
        path = tmp / f"{name}.json"
        rc, _ = _run(cli.main, argv + ["--events-dump", str(path)])
        assert rc == 0, name
        out[name] = path
    return out


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_analyze_dump_equals_the_references(dumps, name):
    dump = forensics.load_causal_dump(dumps[name])
    got = forensics.analyze_dump(dump)
    want = ref_forensics.analyze_dump(ref_forensics.load_causal_dump(
        dumps[name]))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["fork_tree"]["blocks"] and got["convergence"]["converged"]
    assert bool(got["attack_audit"]) == (name == "adversarial")


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_chrome_trace_equals_the_references(dumps, name):
    dump = forensics.load_causal_dump(dumps[name])
    got = forensics.to_chrome_trace(forensics.merge_events(dump))
    want = ref_forensics.to_chrome_trace(ref_forensics.merge_events(dump))
    assert got["metadata"].pop("source") == \
        "mpi_blockchain_tpu_torch.forensics"
    assert want["metadata"].pop("source") == "mpi_blockchain_tpu.forensics"
    assert got == want
    # A process row for every node of the dump.
    rows = {e["args"]["name"] for e in got["traceEvents"]
            if e["ph"] == "M"}
    assert rows == {f"node {n}" for n in dump["nodes"]}


@pytest.mark.parametrize("name", sorted(DUMPS))
@pytest.mark.parametrize("mode", [["--json"], []], ids=["json", "human"])
def test_cli_output_equals_the_references(dumps, tmp_path, name, mode):
    p_trace, r_trace = tmp_path / "p.json", tmp_path / "r.json"
    rc, got = _run(forensics_cli.main, ["--events", str(dumps[name]),
                                        "--trace", str(p_trace), *mode])
    ref_rc, want = _run(ref_forensics_cli.main,
                        ["--events", str(dumps[name]),
                         "--trace", str(r_trace), *mode])
    assert rc == ref_rc == 0
    assert got == want and got
    trace = json.loads(p_trace.read_text())
    ref_trace = json.loads(r_trace.read_text())
    trace["metadata"].pop("source")
    ref_trace["metadata"].pop("source")
    assert trace == ref_trace


@pytest.mark.parametrize("content", [None, "{not json", '{"version": 1}',
                                     '{"nodes": []}'],
                         ids=["missing", "not_json", "no_nodes",
                              "nodes_not_a_map"])
def test_unreadable_dump_exits_2_as_the_references(tmp_path, capsys,
                                                   content):
    path = tmp_path / "bad.json"
    if content is not None:
        path.write_text(content)
    assert forensics_cli.main(["--events", str(path)]) == 2
    err = capsys.readouterr().err
    assert ref_forensics_cli.main(["--events", str(path)]) == 2
    assert err == capsys.readouterr().err
    assert err.startswith("forensics: cannot read events dump")


def test_merge_order_and_node_keys_equal_the_references():
    """Numeric node ids first by value, named pseudo-nodes after; ties in
    Lamport time broken by node, then by seq."""
    dump = {"nodes": {
        "bus": [{"node": "bus", "lamport": 2, "seq": 0, "kind": "drop"}],
        "10": [{"node": 10, "lamport": 1, "seq": 0, "kind": "mine",
                "hash": "b", "prev": "a", "height": 1}],
        "2": [{"node": 2, "lamport": 1, "seq": 1, "kind": "mine",
               "hash": "c", "prev": "a", "height": 1},
              {"node": 2, "lamport": 1, "seq": 0, "kind": "send",
               "hash": "c"}]}}
    got = forensics.merge_events(dump)
    assert got == ref_forensics.merge_events(dump)
    assert [(e["node"], e["seq"]) for e in got] == \
        [(2, 0), (2, 1), (10, 0), ("bus", 0)]
    assert forensics.node_order(dump) == \
        ref_forensics.node_order(dump) == ["2", "10", "bus"]
    assert [trace_export._pid(n) for n in ("bus", 0, "7")] == [0, 1, 8]
    tree = forensics.build_fork_tree(got)
    assert tree == ref_forensics.build_fork_tree(got)
    assert tree["fork_points"] == {"a": ["b", "c"]}
    assert merge.causal_sort_key({}) == (0, (1, 0, "None"), 0)
