"""SAN rules — the CUDA library under compute-sanitizer.

The reference's SAN pass checks that its tsan/asan/ubsan matrix over the
C++ core exists (its ``core/Makefile``) and runs cppcheck/clang-tidy when
installed. The port's C++ core is a byte-identical copy of that core,
which the reference's matrix already covers. The port's own native code
is the CUDA library ``ops/csrc/sha256d_sweep.cu`` (the sweep kernel, the
fused step kernel and the copy of ext into the ``__constant__`` symbol),
so the port's SAN rules hold that library:

  SAN001  the sanitizer driver ``ops/csrc/sanitize_main.cu`` is missing
          — the matrix has nothing to run (the reference's id: the
          matrix must exist).
  SAN005  an entry of the library's ``extern "C"`` interface that the
          driver never calls — the matrix does not cover it.
  SAN006  compute-sanitizer's memcheck, racecheck, synccheck or
          initcheck reported errors running the driver (one finding per
          tool, anchored at the kernel its reports name).
  SAN007  the driver's known answers disagree (a case printed FAIL) or it
          crashed, under no tool or under one.
  SAN008  a poisoned run was not reported: the driver's sweep into a
          result buffer one word short under memcheck, or into one never
          reset under initcheck, came back clean — the tool checks
          nothing on this machine.

SAN005 is static and runs everywhere. SAN006-SAN008 are card-only: they
run where ``nvcc`` is found (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``,
``PATH``), ``compute-sanitizer`` beside it, and a CUDA device. Where the
tool is absent, or reports that it cannot check here (its own
``Error:`` record, such as "Device not supported", in place of a report
on the program), the pass gives a note rather than a finding, as the
reference does for a missing cppcheck.

The driver is standalone CUDA C++ (it includes the library's source and
links the core's ``sha256.cpp`` for the host's known answers), built by
``nvcc`` into the package's git-ignored ``build/``, so it starts fast
under a tool. ``python -m mpi_blockchain_tpu_torch.analysis.sanitizers``
runs the matrix and prints its verdicts as JSON (chip_smoke phase 16 b).
This module imports only the standard library.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

from . import DOC, REPO_PACKAGE, Finding, rel_path
from .cparse import parse_extern_c_block, strip_comments

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
#: The poisoned runs: (tool, driver mode) pairs that must be reported.
POISONS = (("memcheck", "short"), ("initcheck", "uninit"))
#: What a report names for each part of the library it covers.
KERNELS = {"sha256d_sweep": "sha256d_sweep_kernel",
           "sha256d_block_step": "block_step_kernel",
           "ext_symbol_copy": "cudaMemcpyToSymbol"}

DRIVER_SOURCE = "ops/csrc/sanitize_main.cu"
LIBRARY_SOURCE = "ops/csrc/sha256d_sweep.cu"
CORE_SOURCES = ("core/csrc/sha256.cpp", "core/csrc/sha256.hpp")
DRIVER_BINARY = "build/sanitize_sha256d"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo"]
#: Seconds one run of the driver may take under a tool.
RUN_TIMEOUT_S = 600.0
#: The driver's exit code when it finds no CUDA device.
NO_DEVICE_RC = 3


def find_nvcc() -> str | None:
    """``nvcc`` under ``$CUDA_HOME``, ``/usr/local/cuda`` or on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc")


def find_sanitizer(nvcc: str | None) -> str | None:
    """``compute-sanitizer`` beside ``nvcc`` (the toolkit's ``bin/`` or its
    ``compute-sanitizer/`` directory)."""
    if nvcc is None:
        return None
    bindir = pathlib.Path(nvcc).resolve().parent
    for candidate in (bindir / "compute-sanitizer",
                      bindir.parent / "compute-sanitizer"
                      / "compute-sanitizer"):
        if candidate.is_file() and os.access(candidate, os.X_OK):
            return str(candidate)
    return None


def _sources(root: pathlib.Path) -> list[pathlib.Path]:
    pkg = root / REPO_PACKAGE
    return [pkg / DRIVER_SOURCE, pkg / LIBRARY_SOURCE,
            *(pkg / s for s in CORE_SOURCES)]


def build_driver(root: pathlib.Path, nvcc: str) -> pathlib.Path:
    """Builds the driver unless it is newer than every source; the binary
    is replaced atomically, so concurrent builders never see half of one.
    Raises RuntimeError with the compiler's output when nvcc fails."""
    pkg = root / REPO_PACKAGE
    out = pkg / DRIVER_BINARY
    sources = _sources(root)
    if out.is_file() and all(out.stat().st_mtime >= s.stat().st_mtime
                             for s in sources):
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(pkg / DRIVER_SOURCE),
           str(pkg / CORE_SOURCES[0])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building the sanitizer driver "
                f"(rc {proc.returncode}): "
                f"{(proc.stderr or proc.stdout)[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_SUMMARY_RE = re.compile(r"ERROR SUMMARY:\s*(\d+)\s+error")
_RACE_SUMMARY_RE = re.compile(r"RACECHECK SUMMARY:.*?\((\d+)\s+error")
_PREFIX = "========="
#: Record headers in which the tool reports on itself, not on the
#: program: it could not attach to the device or the process.
_TOOL_ERRORS = ("Error:", "Internal Sanitizer Error")
_NOT_RECORDS = ("ERROR SUMMARY", "RACECHECK SUMMARY", "COMPUTE-SANITIZER",
                "Target application returned an error")


def parse_report(text: str) -> dict:
    """A tool's verdict from its output: ``summary`` (whether it printed
    its summary line), ``tool_error`` (the first record in which the tool
    reports that it cannot check: the device is not supported, it could
    not attach), ``errors`` (the program errors it reported: records
    other than the tool's own), ``by_kernel`` (those records naming each
    part of the library; ``other`` for the rest) and ``first`` (the first
    program error's header line)."""
    m = _SUMMARY_RE.search(text) or _RACE_SUMMARY_RE.search(text)
    records: list[list[str]] = []
    for line in text.splitlines():
        if not line.startswith(_PREFIX):
            continue
        body = line[len(_PREFIX):]
        stripped = body.strip()
        if not stripped:
            continue
        if body.startswith(" ") and not body.startswith("  ") and \
                not stripped.startswith(_NOT_RECORDS):
            records.append([stripped])
        elif records:
            records[-1].append(stripped)
    tool = [r[0].split(". ")[0].rstrip(".") + "."
            for r in records if r[0].startswith(_TOOL_ERRORS)]
    program = [r for r in records if not r[0].startswith(_TOOL_ERRORS)]
    by_kernel = {name: 0 for name in KERNELS}
    by_kernel["other"] = 0
    for rec in program:
        blob = "\n".join(rec)
        name = next((k for k, needle in KERNELS.items() if needle in blob),
                    "other")
        by_kernel[name] += 1
    return {"summary": m is not None,
            "tool_error": tool[0] if tool else None,
            "errors": len(program),
            "by_kernel": by_kernel,
            "first": program[0][0] if program else None}


def run_driver(driver: pathlib.Path, sanitizer: str | None = None,
               tool: str | None = None, poison: str | None = None,
               timeout: float = RUN_TIMEOUT_S) -> dict:
    """One run of the driver, under ``tool`` when given. The process runs
    in its own session and is killed with its children on a timeout."""
    cmd = [str(driver)] + (["--poison", poison] if poison else [])
    if tool is not None:
        cmd = [sanitizer, "--tool", tool, "--print-limit", "20", *cmd]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
        timed_out = False
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        timed_out = True
    verdict = {"tool": tool, "poison": poison, "rc": proc.returncode,
               "timed_out": timed_out,
               "cases_failed": len(re.findall(r"(?m)^FAIL ", out)),
               "cases_passed": len(re.findall(r"(?m)^ok ", out)),
               "tail": out[-1500:]}
    if tool is not None:
        verdict.update(parse_report(out))
        verdict["usable"] = verdict["summary"] and not \
            verdict["tool_error"] and not timed_out
    return verdict


def run_matrix(root: pathlib.Path | None = None,
               tools=TOOLS, poisons=POISONS) -> dict:
    """The whole matrix: the driver plain, under each tool, and each
    poisoned run of a tool that can check here. ``status``:

    * ``ok`` — every tool ran, with no program error and no failed case,
      and every poisoned run was reported;
    * ``errors`` — a tool reported program errors, a case failed (under a
      tool or plain), or a poisoned run came back clean;
    * ``tool_unusable`` — no errors, but a tool could not check here (its
      own error: the device is not supported, it could not attach);
    * ``no_nvcc``, ``no_tool``, ``no_device`` — the matrix could not run.

    ``reason`` says why for the last four."""
    from . import default_root

    root = root if root is not None else default_root()
    nvcc = find_nvcc()
    sanitizer = find_sanitizer(nvcc)
    result: dict = {"nvcc": nvcc, "sanitizer": sanitizer, "clean": {},
                    "poisoned": {}, "plain": None, "status": "ok",
                    "reason": ""}
    if nvcc is None:
        result.update(status="no_nvcc", reason="nvcc not found")
        return result
    if sanitizer is None:
        result.update(status="no_tool",
                      reason=f"compute-sanitizer not found beside {nvcc}")
        return result
    driver = build_driver(root, nvcc)
    result["driver"] = rel_path(driver, root)
    plain = run_driver(driver)
    result["plain"] = plain
    if plain["rc"] == NO_DEVICE_RC:
        result.update(status="no_device", reason="no CUDA device")
        return result
    for tool in tools:
        result["clean"][tool] = run_driver(driver, sanitizer, tool)
    for tool, mode in poisons:
        if result["clean"][tool]["usable"]:
            result["poisoned"][f"{tool}:{mode}"] = run_driver(
                driver, sanitizer, tool, poison=mode)
    usable = [v for v in result["clean"].values() if v["usable"]]
    unusable = {tool: v["tool_error"] or f"rc {v['rc']}, no summary"
                for tool, v in result["clean"].items() if not v["usable"]}
    if (plain["rc"] != 0 or plain["cases_failed"]
            or any(v["errors"] or v["rc"] != 0 or v["cases_failed"]
                   for v in usable)
            or any(not v["errors"] for v in result["poisoned"].values())):
        result["status"] = "errors"
    elif unusable:
        result["status"] = "tool_unusable"
    if unusable:
        by_error: dict[str, list[str]] = {}
        for tool, why in unusable.items():
            by_error.setdefault(why, []).append(tool)
        result["reason"] = "; ".join(
            f"{'/'.join(tools)}: {why}" for why, tools in by_error.items())
    return result


def kernel_verdicts(result: dict) -> dict[str, dict[str, int | str]]:
    """{part of the library: {tool: program errors its reports name, or
    why the tool could not check}} over the clean runs."""
    def verdict(tool: str, name: str):
        v = result["clean"].get(tool)
        if v is None:
            return "not run"
        if not v["usable"]:
            return f"not checked: {v['tool_error'] or 'no summary'}"
        return v["by_kernel"][name]
    return {name: {tool: verdict(tool, name) for tool in TOOLS}
            for name in KERNELS}


# ---- the pass ---------------------------------------------------------------


def _kernel_line(cu: pathlib.Path, needle: str) -> int:
    """Line of the first mention of ``needle`` in the library's code."""
    try:
        text = strip_comments(cu.read_text(errors="replace"))
    except OSError:
        return 1
    i = text.find(needle)
    return text.count("\n", 0, i) + 1 if i >= 0 else 1


def _check_coverage(findings, driver: pathlib.Path, cu: pathlib.Path,
                    root: pathlib.Path) -> None:
    """SAN005: every entry of the library's C interface is called by the
    driver."""
    called = set(re.findall(r"\b(\w+)\s*\(",
                            strip_comments(driver.read_text(
                                errors="replace"))))
    cu_rel = rel_path(cu, root)
    for name, fn in sorted(parse_extern_c_block(cu).items()):
        if name not in called:
            findings.append(Finding(
                cu_rel, fn.line, "SAN005",
                f"{name} is an entry of the library's C interface that the "
                f"sanitizer driver {rel_path(driver, root)} never calls — "
                f"compute-sanitizer's matrix does not cover it; add a "
                f"case with a known answer ({DOC} §SAN)"))


def _dynamic(findings, notes, root: pathlib.Path, driver_src: pathlib.Path,
             cu: pathlib.Path) -> None:
    """SAN006-SAN008 from one run of the matrix; a tool that cannot check
    here is a note."""
    def note(msg: str) -> None:
        if notes is not None:
            notes.append(f"sanitizers: {msg}")

    try:
        result = run_matrix(root)
    except RuntimeError as e:       # the driver did not build
        findings.append(Finding(rel_path(driver_src, root), 1, "SAN007",
                                str(e)))
        return
    if result["status"] in ("no_nvcc", "no_tool", "no_device"):
        note(f"{result['reason']}; SAN006-SAN008 skipped")
        return
    if result["reason"]:
        note(f"compute-sanitizer ({result['sanitizer']}) cannot check "
             f"here ({result['reason']}); SAN006-SAN008 skipped for those "
             f"tools")
    src_rel, cu_rel = rel_path(driver_src, root), rel_path(cu, root)
    usable = {tool: v for tool, v in result["clean"].items()
              if v["usable"]}
    for label, v in [("no tool", result["plain"])] + list(usable.items()):
        crashed = v["rc"] not in (0, None) and not v.get("errors")
        if crashed or v["cases_failed"]:
            findings.append(Finding(
                src_rel, 1, "SAN007",
                f"the sanitizer driver under {label}: rc {v['rc']}, "
                f"{v['cases_failed']} case(s) FAIL"
                f"{' (timed out)' if v['timed_out'] else ''}: "
                f"{v['tail'].strip().splitlines()[-3:]}"))
    for tool, v in usable.items():
        if not v["errors"]:
            continue
        named = {k: n for k, n in v["by_kernel"].items() if n}
        where = next((k for k in KERNELS if named.get(k)), None)
        findings.append(Finding(
            cu_rel if where else src_rel,
            _kernel_line(cu, KERNELS[where]) if where else 1, "SAN006",
            f"compute-sanitizer --tool {tool} reported {v['errors']} "
            f"error(s) running the driver (records by part: {named}); "
            f"first: {v['first']} ({DOC} §SAN)"))
    for key, v in result["poisoned"].items():
        if not v["errors"]:
            findings.append(Finding(
                src_rel, 1, "SAN008",
                f"the poisoned run {key} came back with no error "
                f"(rc {v['rc']}): compute-sanitizer checks nothing on this "
                f"machine ({DOC} §SAN)"))


def run_sanitizers(root: pathlib.Path, overrides=None,
                   notes=None) -> list[Finding]:
    overrides = overrides or {}
    pkg = root / REPO_PACKAGE
    driver = pathlib.Path(overrides.get("sanitize_driver",
                                        pkg / DRIVER_SOURCE))
    cu = pathlib.Path(overrides.get("cuda_src", pkg / LIBRARY_SOURCE))
    findings: list[Finding] = []
    if not driver.is_file():
        findings.append(Finding(
            rel_path(driver, root), 1, "SAN001",
            f"the sanitizer driver is missing — compute-sanitizer's "
            f"matrix ({'/'.join(TOOLS)}) over {rel_path(cu, root)} has "
            f"nothing to run ({DOC} §SAN)"))
        return findings
    _check_coverage(findings, driver, cu, root)
    if "sanitize_driver" in overrides or "cuda_src" in overrides:
        # A drift fixture: the static rules only (the matrix runs the
        # checkout's driver, not a fixture).
        return findings
    _dynamic(findings, notes, root, driver, cu)
    return findings


def main(argv=None) -> int:
    """Runs the matrix and prints it as one JSON object: rc 0 when every
    tool ran clean and every poison was reported, 1 on errors, 2 when the
    matrix could not run in full (no nvcc, no tool, no device, a tool
    that cannot check here)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.analysis.sanitizers",
        description="compute-sanitizer's memcheck, racecheck, synccheck "
                    "and initcheck over the CUDA library's driver, and "
                    "the poisoned runs that prove the tools check")
    parser.add_argument("--root", type=pathlib.Path, default=None)
    args = parser.parse_args(argv)
    try:
        result = run_matrix(args.root)
    except RuntimeError as e:
        print(json.dumps({"status": "build_failed", "reason": str(e)}))
        return 1
    if result["clean"]:
        result["kernels"] = kernel_verdicts(result)
    print(json.dumps(result, sort_keys=True))
    return {"ok": 0, "errors": 1}.get(result["status"], 2)


if __name__ == "__main__":
    sys.exit(main())
