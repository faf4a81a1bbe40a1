"""The port's three budget ratchets: collective sites (SBD), host-device
transfers (TRB) and the sweep's per-nonce ALU operators (OPB).

Each mirrors the reference's ratchet tests (``tests/test_analysis.py``,
``test_opbudget_*``, ``test_trb_*``, ``test_sbd_*``): a grown census fires
001, a missing or malformed budget 002, an empty scope or a renamed entry
003; a rebaseline refuses to move a budget up and ratchets it down; the
CLI's refusal exits 2. The committed static censuses, and the whole of the
collective budget (its traced section runs here, in a one-process gloo
world), reproduce byte for byte. The host census is 155 on both packages'
``extend_midstate``. The traced transfer and op censuses are taken on the
card: those checks are marked ``cuda`` and skip here.
"""
import json
import pathlib
import subprocess
import sys

import pytest

from mpi_blockchain_tpu.analysis import opbudget as ref_opbudget
from mpi_blockchain_tpu_torch import analysis
from mpi_blockchain_tpu_torch.analysis import (opbudget, shard_budget,
                                               transfer_budget)
from mpi_blockchain_tpu_torch.analysis.__main__ import OVERRIDE_KEYS

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mpi_blockchain_tpu_torch"
CU = PORT / "ops" / "csrc" / "sha256d_sweep.cu"

FAMILIES = {
    "sbd": (shard_budget, "shardbudget_json", "shard_files",
            "static_collective_sites", "rebaseline_shards",
            "--rebaseline-shards"),
    "trb": (transfer_budget, "transferbudget_json", "transfer_files",
            "static_transfer_sites", "rebaseline_transfers",
            "--rebaseline-transfers"),
    "opbudget": (opbudget, "opbudget_json", None, "static_alu_ops",
                 "rebaseline", "--rebaseline"),
}


def committed(module) -> dict:
    return json.loads((ROOT / module.BASELINE_PATH).read_text())


def budget_copy(tmp_path, module, **change) -> pathlib.Path:
    data = committed(module)
    data.update(change)
    path = tmp_path / module.BASELINE_NAME
    path.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    return path


def run_family(family, **overrides):
    return analysis.run_all(root=ROOT, passes=[family], overrides=overrides)


def cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.analysis", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def rules(findings):
    return [f.rule for f in findings]


def require_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the traced census is taken on "
                    "the card")


# ---- shared ratchet contract ----------------------------------------------


def test_the_four_families_are_registered_and_wired():
    families = analysis.pass_families()
    assert len(families) == 15
    assert {"spmd", "opbudget", "trb", "sbd"} <= set(families)
    for prefix, family in (("SPMD", "spmd"), ("OPB", "opbudget"),
                           ("TRB", "trb"), ("SBD", "sbd")):
        assert analysis.RULE_FAMILIES[prefix] == family
    for family, (module, *_rest) in FAMILIES.items():
        assert module.BASELINE_PATH in analysis.FAMILY_SCOPES[family]
        assert module.BASELINE_PATH == \
            f"mpi_blockchain_tpu_torch/analysis/{module.BASELINE_NAME}"
        assert committed(module)["writer"] == module.MOVER
    assert {"opbudget_json", "kernel_src", "host_src",
            "transferbudget_json", "transfer_files", "shardbudget_json",
            "shard_files", "spmd_files", "elastic_files"} <= \
        set(OVERRIDE_KEYS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_live_gate_is_armed_and_green(family):
    notes = []
    assert analysis.run_all(root=ROOT, passes=[family], notes=notes) == []
    assert not any("below the budget" in n for n in notes), notes


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grown_census_fires_001(family, tmp_path):
    module, key, _, count, _, _ = FAMILIES[family]
    low = budget_copy(tmp_path, module, **{count: 1})
    findings = run_family(family, **{key: low})
    prefix = {"sbd": "SBD", "trb": "TRB", "opbudget": "OPB"}[family]
    assert rules(findings) == [f"{prefix}001"]
    assert module.MOVER in findings[0].message


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_missing_or_malformed_budget_fires_002(family, tmp_path):
    module, key, _, count, _, _ = FAMILIES[family]
    prefix = {"sbd": "SBD", "trb": "TRB", "opbudget": "OPB"}[family]
    bad = tmp_path / "bad.json"
    bad.write_text("{oops")
    nokey = budget_copy(tmp_path, module)
    data = json.loads(nokey.read_text())
    del data[count]
    nokey.write_text(json.dumps(data))
    untraced = tmp_path / "untraced.json"
    data = committed(module)
    del data["traced"]
    untraced.write_text(json.dumps(data))
    boolean = tmp_path / "bool.json"
    boolean.write_text(json.dumps({**committed(module), count: True}))
    for path in (tmp_path / "nope.json", bad, nokey, untraced, boolean):
        assert rules(run_family(family, **{key: path})) == [f"{prefix}002"]


@pytest.mark.parametrize("family", ["sbd", "trb"])
def test_empty_scope_fires_003(family):
    _, _, files, _, _, _ = FAMILIES[family]
    prefix = family.upper()
    assert rules(run_family(family, **{files: []})) == [f"{prefix}003"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rebaseline_refuses_upward_and_the_cli_exits_2(family, tmp_path):
    module, key, _, count, fn, flag = FAMILIES[family]
    low = budget_copy(tmp_path, module, **{count: 1})
    before = low.read_bytes()
    with pytest.raises(ValueError, match="refusing to rebaseline upward"):
        getattr(module, fn)(ROOT, {key: low})
    proc = cli(flag, "--override", f"{key}={low}")
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "refused" in proc.stderr and "upward" in proc.stderr
    assert low.read_bytes() == before


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rebaseline_ratchets_down_to_the_committed_bytes(family, tmp_path):
    module, key, _, count, fn, _ = FAMILIES[family]
    high = budget_copy(tmp_path, module, **{count: 10 ** 6})
    notes = []
    assert analysis.run_all(root=ROOT, passes=[family], notes=notes,
                            overrides={key: high}) == []
    assert any("below the budget" in n for n in notes)
    old, new, path = getattr(module, fn)(ROOT, {key: high})
    assert (old, new) == (10 ** 6, committed(module)[count])
    # The traced section is preserved: the file is the committed one.
    assert path.read_bytes() == (ROOT / module.BASELINE_PATH).read_bytes()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_rebaseline_requires_a_valid_budget(family, tmp_path):
    module, key, _, _, fn, _ = FAMILIES[family]
    with pytest.raises(ValueError, match="no valid baseline to amend"):
        getattr(module, fn)(ROOT, {key: tmp_path / "missing.json"})


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cli_pass_family_fires_on_a_lowered_budget(family, tmp_path):
    module, key, _, count, _, _ = FAMILIES[family]
    low = budget_copy(tmp_path, module, **{count: 1})
    proc = cli("--passes", family, "--override", f"{key}={low}")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    prefix = {"sbd": "SBD", "trb": "TRB", "opbudget": "OPB"}[family]
    assert f"{prefix}001" in proc.stdout


# ---- SBD: collective sites -------------------------------------------------


def test_sbd_static_census_is_the_winner_selects_collectives():
    data = committed(shard_budget)
    assert data["static_by_site"] == {"all_reduce": 2, "winner_select": 2}
    total, by_label, sites, errors = shard_budget.static_collective_census(
        ROOT, [ROOT / p for p in shard_budget.SHARD_SCOPE])
    assert (total, by_label, sites, errors) == (
        data["static_collective_sites"], data["static_by_site"],
        data["sites"], [])
    assert data["scope"] == list(shard_budget.SHARD_SCOPE)


def test_sbd_traced_census_pins_two_int64_all_reduces_a_round():
    traced = committed(shard_budget)["traced"]
    assert set(traced) == {"cuda_world", "fused_world"}
    for flavor in traced.values():
        assert flavor["collective_total"] == 2
        assert flavor["payload_bytes"] == 16
        assert [(c["op"], c["reduce_op"], c["dtypes"], c["bytes"])
                for c in flavor["sequence"]] == [
            ("allreduce_", "SUM", ["int64"], 8),
            ("allreduce_", "MIN", ["int64"], 8)]


def test_sbd_host_gather_on_the_round_fails_the_gate(tmp_path):
    mesh = (PORT / "parallel" / "mesh.py").read_text()
    grown = mesh.replace(
        "    return int(total.item()), int(least.item())",
        "    rows = [torch.zeros_like(t)]\n"
        "    dist.all_gather(rows, t, group=group)\n"
        "    return int(total.item()), int(least.item())")
    assert grown != mesh
    path = tmp_path / "mesh.py"
    path.write_text(grown)
    files = [path] + [ROOT / p for p in shard_budget.SHARD_SCOPE[1:]]
    findings = run_family("sbd", shard_files=files)
    assert rules(findings) == ["SBD001"]
    assert "delta +1" in findings[0].message
    assert "all_gather×1" in findings[0].message


def test_sbd_mover_reproduces_the_committed_budget_byte_for_byte(tmp_path):
    out = tmp_path / "SHARDBUDGET.json"
    proc = subprocess.run(
        [sys.executable, "-m",
         "mpi_blockchain_tpu_torch.analysis.shard_budget", "--write",
         "--device", "cpu", "--baseline", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == \
        (ROOT / shard_budget.BASELINE_PATH).read_bytes()


def test_sbd_check_flags_a_round_that_grew_a_collective(tmp_path):
    data = committed(shard_budget)
    data["traced"]["fused_world"]["collective_total"] = 1
    path = tmp_path / "SHARDBUDGET.json"
    path.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m",
         "mpi_blockchain_tpu_torch.analysis.shard_budget", "--check",
         "--device", "cpu", "--baseline", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 1, proc.stderr
    assert "RATCHET INCREASE" in proc.stderr and "fused_world" in \
        proc.stderr


# ---- TRB: transfers --------------------------------------------------------


def test_trb_committed_static_census_reproduces():
    data = committed(transfer_budget)
    static = transfer_budget.static_section(ROOT)
    assert static == {k: data[k] for k in static}
    assert data["static_by_site"]["read_result"] == 2
    assert data["scope"] == list(transfer_budget.SWEEP_SCOPE)


@pytest.mark.parametrize("call,label", [
    ("t.item()", ".item()"), ("t.tolist()", ".tolist()"),
    ("t.cpu()", ".cpu()"), ("t.numpy()", ".numpy()"),
    ("t.to(device)", ".to(device)"), ("t.to(device='cuda')", ".to(device)"),
    ("t.to(torch.int64)", None), ("dst.copy_(src)", None),
    ("dst.copy_(src, non_blocking=True)", ".copy_(across devices)"),
    ("dst.copy_(src.pin_memory())", ".copy_(across devices)"),
    ("torch.cuda.synchronize()", ".synchronize()"),
    ("event.synchronize()", ".synchronize()"),
    ("read_result(out)", "read_result"),
    ("sweep_launch(ext, 0, 1, 8, device=d).result()",
     "LaunchedSweep.result"),
    ("launched.result()", "LaunchedSweep.result"),
    ("future.result()", None), ("np.asarray(ext)", None)])
def test_trb_site_labels_read_for_torch(call, label, tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("launched = sweep_launch(ext, 0, 1, 8, device=d)\n"
                   f"{call}\n")
    total, by_label, sites, _ = transfer_budget.static_transfer_census(
        tmp_path, [src])
    want = {label: 1} if label else {}
    assert by_label == want
    assert [s["line"] for s in sites] == ([2] if label else [])


def test_trb_extra_read_back_on_the_sweep_path_fails_the_gate(tmp_path):
    cuda = (PORT / "backend" / "cuda.py").read_text()
    grown = cuda.replace("            def read() -> tuple[int, int]:\n",
                         "            launched.out.cpu()\n"
                         "            def read() -> tuple[int, int]:\n")
    assert grown != cuda
    path = tmp_path / "cuda.py"
    path.write_text(grown)
    files = [path if p.endswith("backend/cuda.py") else ROOT / p
             for p in transfer_budget.SWEEP_SCOPE]
    findings = run_family("trb", transfer_files=files)
    assert rules(findings) == ["TRB001"]


def test_trb_traced_census_is_one_8_byte_read_back_a_search():
    traced = committed(transfer_budget)["traced"]
    per_search = traced["per_search"]["memcpy"]
    dtoh = {k: v for k, v in per_search.items() if "DtoH" in k}
    assert list(dtoh.values()) == [{"bytes": 8, "count": 1}]
    assert not any("HtoD" in k for k in per_search)
    call = traced["fused"]["per_call"]
    k = traced["fused"]["blocks_per_call"]
    assert [v for n, v in call.items() if "DtoH" in n] == [
        {"bytes": 4 * k, "count": 1}]


def test_trb_check_fails_on_a_drifted_trace(monkeypatch, capsys):
    data = committed(transfer_budget)
    monkeypatch.setattr(transfer_budget, "trace_transfer_census",
                        lambda: data["traced"])
    assert transfer_budget.check_budget(ROOT) == 0
    assert "reproduces" in capsys.readouterr().err
    drifted = json.loads(json.dumps(data["traced"]))
    row = next(iter(drifted["per_search"]["memcpy"].values()))
    row["count"] += 1
    monkeypatch.setattr(transfer_budget, "trace_transfer_census",
                        lambda: drifted)
    assert transfer_budget.check_budget(ROOT) == 1
    assert "drifted" in capsys.readouterr().err


def test_trb_mover_refuses_to_write_a_traced_section_without_a_card(
        tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mover would take the census")
    out = tmp_path / "TRANSFERBUDGET.json"
    for module in ("transfer_budget", "opbudget"):
        proc = subprocess.run(
            [sys.executable, "-m",
             f"mpi_blockchain_tpu_torch.analysis.{module}", "--write",
             "--baseline", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2 and "CUDA device" in proc.stderr
        assert not out.exists()


def test_sbd_movers_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mover would take the census")
    out = tmp_path / "SHARDBUDGET.json"
    for args in (["--write", "--baseline", str(out)], ["--check"]):
        proc = subprocess.run(
            [sys.executable, "-m",
             "mpi_blockchain_tpu_torch.analysis.shard_budget", *args],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2, proc.stderr
        assert "no CUDA device" in proc.stderr and "--device cpu" in \
            proc.stderr
    assert not out.exists()


@pytest.mark.cuda
def test_trb_check_reproduces_on_the_card():
    require_card()
    proc = subprocess.run(
        [sys.executable, "-m",
         "mpi_blockchain_tpu_torch.analysis.transfer_budget", "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == committed(transfer_budget)["traced"]


# ---- OPB: the per-nonce ALU census -----------------------------------------


def test_opb_committed_static_census_reproduces():
    data = committed(opbudget)
    static = opbudget.static_section(ROOT)
    assert static == {k: data[k] for k in static}
    assert data["static_components"] == opbudget.static_kernel_census(CU)


def test_opb_host_census_is_155_on_both_packages():
    for src in (ROOT / "mpi_blockchain_tpu" / "ops" / "sha256_sched.py",
                PORT / "ops" / "sha256_sched.py"):
        assert opbudget.static_alu_census(src, "extend_midstate") == 155
        assert ref_opbudget.static_alu_census(src, "extend_midstate") == 155
    assert committed(opbudget)["static_host_alu_ops"] == 155


def test_opb_inflated_kernel_fires_opb001_at_the_entry(tmp_path):
    src = CU.read_text()
    inflated = src.replace("  return g ^ (e & (f ^ g));",
                           "  return (g ^ (e & (f ^ g))) ^ (e & f) ^ (e & f);")
    assert inflated != src
    path = tmp_path / "sha256d_sweep.cu"
    path.write_text(inflated)
    findings = run_family("opbudget", kernel_src=path)
    assert rules(findings) == ["OPB001"]
    # ch runs twice a round over 124 rounds: 4 more operators each time.
    assert f"{committed(opbudget)['static_alu_ops'] + 4 * 124} >" in \
        findings[0].message
    line = next(i for i, ln in enumerate(inflated.splitlines(), 1)
                if "void sha256d_h01(" in ln)
    assert findings[0].line == line


def test_opb_renamed_entry_fires_opb003(tmp_path):
    path = tmp_path / "sha256d_sweep.cu"
    path.write_text(CU.read_text().replace("sha256d_h01", "sha256d_h01_v2"))
    assert rules(run_family("opbudget", kernel_src=path)) == ["OPB003"]


CENSUS_FIXTURE = """\
constexpr int kN = 4;

// A comment with an operator: a + b.
__device__ __forceinline__ uint32_t rot(uint32_t x) {
  return __funnelshift_r(x, x, 3);
}

template <int kFirst>
__device__ __forceinline__ void walk(uint32_t (&w)[8]) {
#pragma unroll
  for (int r = kFirst; r < 8; ++r) w[r] = w[r - 1] ^ rot(w[r - 2]);
}

template <int kMode>
__device__ __forceinline__ uint32_t pick(uint32_t x) {
  if (kMode == 0) return x + 1;
  return x * 3 + kN * 2;
}

__device__ __forceinline__ uint32_t rolled(uint32_t x, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) x = x ^ (x << 1);
  const uint32_t* p = kN > 2 ? &x : nullptr;
  return *p + walk<6>(p);
}
"""


def test_opb_cuda_census_rules(tmp_path):
    path = tmp_path / "k.cu"
    path.write_text(CENSUS_FIXTURE)
    census = opbudget.CudaCensus(path)
    assert census.func_cost("rot") == 1            # one intrinsic
    # A template bound takes the call's value; subscripts cost nothing.
    assert census.func_cost("walk", (2,)) == 6 * 2   # 6 trips, ^ and rot
    assert census.func_cost("walk", (7,)) == 1 * 2
    # Every operator token counts: no branch is chosen, nothing folds.
    assert census.func_cost("pick", (0,)) == census.func_cost("pick", (1,)) \
        == 5
    # A loop whose trips are not literal counts its header and body once;
    # pointer declarators and dereferences are not operators; a call with
    # a literal template argument adds that instantiation's census.
    assert census.func_cost("rolled") == 2 + 2 + 1 + 1 + 2 * 2
    assert census.func_cost("absent") is None


def test_opb_hoist_registers_as_decrease_not_noise(tmp_path):
    kernel = ("template <bool kExt>\n"
              "__device__ void sha256d_h01(uint32_t ms, uint32_t base,\n"
              "                            uint32_t& h0) {\n"
              "  {body}\n"
              "}\n"
              "template <int kMode>\n"
              "__device__ bool qualifies(uint32_t h0, uint32_t lim) {\n"
              "  return h0 < lim;\n"
              "}\n")
    kern, host = tmp_path / "k.cu", tmp_path / "host.py"
    kern.write_text(kernel.replace("{body}",
                                   "h0 = ms + base + ms + base + base;"))
    fat = sum(opbudget.static_kernel_census(kern).values())
    kern.write_text(kernel.replace("{body}", "h0 = ms + base;"))
    thin = sum(opbudget.static_kernel_census(kern).values())
    assert (fat, thin) == (5, 2)
    host.write_text("def extend_midstate(ms, tail):\n"
                    "    return ms + tail + ms + tail\n")
    budget = budget_copy(tmp_path, opbudget, static_alu_ops=fat,
                         static_host_alu_ops=3)
    notes = []
    assert analysis.run_all(root=ROOT, passes=["opbudget"], notes=notes,
                            overrides={"opbudget_json": budget,
                                       "kernel_src": kern,
                                       "host_src": host}) == []
    assert any("below the budget" in n for n in notes)
    host.write_text("def renamed(ms, tail):\n    return ms\n")
    findings = run_family("opbudget", opbudget_json=budget, kernel_src=kern,
                          host_src=host)
    assert rules(findings) == ["OPB003"] and "host" in findings[0].message
    host.write_text("def extend_midstate(ms, tail):\n    return ms + tail\n")
    notes = []
    analysis.run_all(root=ROOT, passes=["opbudget"], notes=notes,
                     overrides={"opbudget_json": budget, "kernel_src": kern,
                                "host_src": host})
    assert any("host per-template census 1" in n for n in notes)


def test_opb_check_compares_the_loop_census_only_on_its_release(
        monkeypatch, capsys):
    traced = committed(opbudget)["traced"]
    monkeypatch.setattr(opbudget, "trace_loop_census", lambda: traced)
    assert opbudget.check_budget(ROOT) == 0
    assert "reproduces" in capsys.readouterr().err
    other = {**traced, "nvcc_release": "99.9, V99.9.1"}
    monkeypatch.setattr(opbudget, "trace_loop_census", lambda: other)
    assert opbudget.check_budget(ROOT) == 1
    err = capsys.readouterr().err
    assert "99.9, V99.9.1" in err and traced["nvcc_release"] in err
    drifted = json.loads(json.dumps(traced))
    row = drifted["classes"]["1"]
    row["loop_census"]["LOP3"] = row["loop_census"].get("LOP3", 0) + 1
    monkeypatch.setattr(opbudget, "trace_loop_census", lambda: drifted)
    assert opbudget.check_budget(ROOT) == 1
    assert "drifted" in capsys.readouterr().err


def test_opb_traced_section_covers_every_class():
    traced = committed(opbudget)["traced"]
    assert sorted(traced["classes"]) == ["0", "1", "2", "3", "4"]
    for cls, row in traced["classes"].items():
        assert opbudget.difficulty_class(row["difficulty_bits"]) == int(cls)
        assert row["loop_instructions"] == sum(row["loop_census"].values())
        assert 0 < row["alu_only"] < row["loop_instructions"]


@pytest.mark.cuda
def test_opb_check_reproduces_on_the_card():
    require_card()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_blockchain_tpu_torch.analysis.opbudget",
         "--check"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == committed(opbudget)["traced"]


def test_the_port_budgets_are_not_the_references():
    for module in (shard_budget, transfer_budget, opbudget):
        data = committed(module)
        ref = json.loads((ROOT / module.BASELINE_NAME).read_text())
        assert data != ref
        assert all(str(v).startswith("mpi_blockchain_tpu_torch/")
                   for v in data.get("scope", []))
