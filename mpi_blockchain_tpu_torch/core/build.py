"""Builds the port's native libraries at first use.

Both libraries land in ``mpi_blockchain_tpu_torch/build/`` (git-ignored):

* ``libchaincore.so`` -- the C++ chain core in ``core/csrc/`` (g++);
* ``libsha256d_sweep.so`` -- the CUDA sweep kernel in ``ops/csrc/`` (nvcc,
  see ``ops/sha256_cuda.py``).

A library is rebuilt when it is missing or older than one of its sources.
Each build writes to a private temporary name and is renamed into place,
so processes that build at the same time never load a half-written file.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import threading

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "build"
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_CORE_SOURCES = ("sha256.cpp", "chain.cpp", "capi.cpp")
_CORE_HEADERS = ("sha256.hpp", "chain.hpp")


def build_log(out: pathlib.Path) -> pathlib.Path:
    """Where ``build_shared`` keeps the compiler's output for ``out``."""
    return out.with_name(out.name + ".log")


def build_shared(command: list[str], sources: list[pathlib.Path],
                 headers: list[pathlib.Path], out: pathlib.Path
                 ) -> pathlib.Path:
    """Runs ``command -o out sources...`` unless ``out`` is newer than
    every source and header, and keeps the compiler's output of a build
    that succeeds in ``build_log(out)``. Raises RuntimeError with the
    compiler's output when the build fails."""
    if out.exists():
        built = out.stat().st_mtime
        if all(p.stat().st_mtime <= built for p in (*sources, *headers)):
            return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([*command, "-o", str(tmp),
                               *(str(s) for s in sources)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {out.name} failed "
                               f"({' '.join(command)}):\n{proc.stderr}")
        build_log(out).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def ensure_built() -> pathlib.Path:
    """Compiles ``libchaincore.so`` if missing or out of date."""
    return build_shared(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"],
        [CSRC / s for s in _CORE_SOURCES],
        [CSRC / h for h in _CORE_HEADERS],
        BUILD_DIR / "libchaincore.so")
