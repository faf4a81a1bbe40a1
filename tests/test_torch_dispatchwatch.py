"""The port's compile census against the reference's, on the CPU.

The census API keeps the reference's shapes: ``record_compile``,
``compile_scope``, ``note_cache``, ``compile_census``, ``recompiles``,
``compile_snapshot`` and ``clear_compiles`` give equal results for the
same emits (the reference's ``backend_compile`` stage is the port's
``program`` or ``nvcc``). What feeds it is the port's: an ``nvcc`` build
that ran (not one that found the library up to date), each load of the
library, and the first use of each k-block program of the fused miner.
"""
import os
import pathlib
import stat

import pytest
import torch

from mpi_blockchain_tpu import dispatchwatch as ref_dw
from mpi_blockchain_tpu import telemetry as ref_telemetry
from mpi_blockchain_tpu_torch import dispatchwatch as dw
from mpi_blockchain_tpu_torch import telemetry
from mpi_blockchain_tpu_torch.config import MinerConfig
from mpi_blockchain_tpu_torch.core.build import build_shared
from mpi_blockchain_tpu_torch.models.fused import FusedMiner
from mpi_blockchain_tpu_torch.ops import sha256_cuda

torch.set_num_threads(1)


def _reset():
    for tel, mod in ((telemetry, dw), (ref_telemetry, ref_dw)):
        tel.reset()
        tel.set_telemetry_disabled(False)
        mod.clear_compiles()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _story(mod, compile_stage: str) -> list:
    """The same emits in either package; ``compile_stage`` is the stage
    that counts as a compile there."""
    out = [mod.current_site(), mod.compile_snapshot(), mod.recompiles()]
    with mod.compile_scope(site="backend"):
        out.append(mod.current_site())
        with mod.compile_scope(site="fused"):
            out.append(mod.current_site())
        out.append(mod.current_site())
    out.append(mod.current_site())
    mod.record_compile(site="backend", stage=compile_stage, duration_s=0.25)
    mod.record_compile(site="backend", stage="load")
    mod.record_compile(site="fused", stage=compile_stage, duration_s=0.5)
    mod.note_cache(site="backend", entries=1)
    mod.note_cache(site="fused", entries=1)
    out += [mod.compile_census(), mod.recompiles()]
    mod.record_compile(site="fused", stage=compile_stage)
    mod.record_compile(site="unscoped", stage=compile_stage)
    mod.record_compile(site="unscoped", stage=compile_stage)
    out += [mod.recompiles(),
            [{k: v for k, v in e.items() if k != "t"}
             for e in mod.compile_events_tail()],
            sorted(mod.compile_snapshot())]
    mod.clear_compiles()
    out.append(mod.compile_snapshot())
    return out


def _renamed(value, old: str, new: str):
    """``value`` with every ``old`` stage key renamed to ``new``."""
    if isinstance(value, dict):
        return {(new if k == old else k): _renamed(v, old, new)
                for k, v in value.items()}
    if isinstance(value, list):
        return [_renamed(v, old, new) for v in value]
    return new if value == old else value


@pytest.mark.parametrize("stage", ["program", "nvcc"])
def test_census_api_matches_the_reference(stage):
    got = _story(dw, stage)
    want = _renamed(_story(ref_dw, "backend_compile"), "backend_compile",
                    stage)
    assert got == want
    census = got[7]
    assert list(census) == ["backend", "fused"]
    assert census["backend"]["compiles"] == 1
    assert census["backend"]["compile_ms"] == 250.0
    assert census["backend"]["stages"] == {stage: 1, "load": 1}
    assert got[8] == 0 and got[9] == 2
    snap = telemetry.default_registry().snapshot()
    assert {m["labels"]["site"]: m["value"]
            for m in snap["compiles_total"]} == {"backend": 1, "fused": 2,
                                                 "unscoped": 2}


def test_kill_switch_reduces_the_census_to_flag_checks():
    telemetry.set_telemetry_disabled(True)
    with dw.compile_scope(site="fused"):
        assert dw.current_site() == dw.UNSCOPED_SITE
    dw.record_compile(site="fused", duration_s=1.0)
    dw.note_cache(site="fused", entries=5)
    assert dw.compile_census() == {} and dw.compile_events_tail() == []
    assert dw.compile_snapshot() == {}
    telemetry.set_telemetry_disabled(False)
    assert dw.compile_census() == {}


def _fake_compiler(tmp_path: pathlib.Path) -> str:
    """A "compiler" that writes its -o argument and counts its runs."""
    script = tmp_path / "fake-nvcc"
    script.write_text("#!/bin/sh\n"
                      "while [ \"$1\" != \"-o\" ]; do shift; done\n"
                      f"echo run >> {tmp_path / 'runs'}\n"
                      "echo built > \"$2\"\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_shared_calls_on_build_only_when_the_compiler_ran(tmp_path):
    nvcc = _fake_compiler(tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    out = tmp_path / "lib.so"
    seen = []
    for _ in range(2):
        build_shared([nvcc], [src], [], out, on_build=seen.append)
    assert len(seen) == 1 and seen[0] >= 0.0
    os.utime(src, (out.stat().st_mtime + 10, out.stat().st_mtime + 10))
    build_shared([nvcc], [src], [], out, on_build=seen.append)
    assert len(seen) == 2
    assert (tmp_path / "runs").read_text().count("run") == 2


def test_the_kernel_librarys_nvcc_builds_and_loads_are_in_the_census(
        tmp_path, monkeypatch):
    monkeypatch.setattr(sha256_cuda, "find_nvcc",
                        lambda: _fake_compiler(tmp_path))
    monkeypatch.setattr(sha256_cuda, "BUILD_DIR", tmp_path / "build")
    sha256_cuda.build()
    sha256_cuda.build()                 # up to date: no compile
    site = dw.compile_census()[sha256_cuda.COMPILE_SITE]
    assert site["compiles"] == 1 and site["stages"] == {"nvcc": 1}
    monkeypatch.setattr(sha256_cuda, "build", lambda: tmp_path / "x.so")
    monkeypatch.setattr(sha256_cuda, "bind", lambda path: object())
    sha256_cuda._lib.__wrapped__()
    site = dw.compile_census()[sha256_cuda.COMPILE_SITE]
    assert site["stages"] == {"nvcc": 1, "load": 1}
    assert site["compiles"] == 1 and dw.recompiles() == 0


def test_each_k_block_program_is_one_compile_of_the_fused_site():
    fm = FusedMiner(MinerConfig(difficulty_bits=8, n_blocks=5,
                                batch_pow2=8, device="cpu"),
                    blocks_per_call=2)
    fm.mine_chain()                     # calls of k 2, 2 and 1
    fm._fn(2)
    site = dw.compile_census()["fused"]
    assert site["compiles"] == site["cache_entries"] == 2
    assert site["stages"] == {"program": 2}
    assert dw.recompiles() == 0
    gauge = [m for m in telemetry.default_registry().snapshot()[
        "trace_cache_entries"] if m["labels"]["site"] == "fused"]
    assert gauge[0]["value"] == 2


def test_recompile_storm_reads_the_ports_census(monkeypatch):
    from mpi_blockchain_tpu_torch.chainwatch.rules import RecompileStorm

    monkeypatch.setenv("MPIBT_CHAINWATCH_RECOMPILE_WARMUP", "1")
    r = RecompileStorm()
    assert r.evaluate({}) is None           # nothing compiled: quiet
    dw.record_compile(site="fused")
    assert r.evaluate({}) is None           # the anchor
    assert r.evaluate({}) is None           # warmup
    for _ in range(2):
        dw.record_compile(site="fused")
        detail = r.evaluate({})
    assert detail == {"compiles_total": 3, "grown": 1, "allowed": 0,
                      "sites": {"fused": 3}}
