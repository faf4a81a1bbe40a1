"""The ctypes binding of the CUDA library matches its C interface.

Every function in the ``extern "C"`` block of ``ops/csrc/sha256d_sweep.cu``
must get ``argtypes`` and ``restype`` from ``sha256_cuda.bind``, with one
ctypes type per C parameter of the matching kind: a pointer passed without
argtypes is cut to 32 bits, and a 64-bit count to an int. No card and no
compiler are needed: ``ctypes.CDLL`` is replaced by a recorder.
"""
import ctypes
import re
import types

import pytest

from mpi_blockchain_tpu_torch.ops import sha256_cuda

# C type (const and parameter names stripped) -> the ctypes types that
# carry it.
_POINTER = (ctypes.c_void_p,)
_SCALARS = {
    "int": (ctypes.c_int,),
    "unsigned int": (ctypes.c_uint32, ctypes.c_uint),
    "unsigned long long": (ctypes.c_uint64, ctypes.c_ulonglong),
    "long long": (ctypes.c_longlong, ctypes.c_int64),
}


def exported_functions(source: str) -> dict[str, tuple[str, list[str]]]:
    """name -> (return type, parameter types) of every function defined in
    the ``extern "C" { ... }`` block of ``source``."""
    block = source[source.index('extern "C" {'):]
    block = re.sub(r"//[^\n]*", "", block)
    found = {}
    for m in re.finditer(r"^([A-Za-z_][\w ]*?[\w*]+)\s*\n?\s*"
                         r"\b(\w+)\(([^)]*)\)\s*\{", block, re.M):
        ret, name, params = m.group(1).strip(), m.group(2), m.group(3)
        types_ = []
        for p in filter(None, (p.strip() for p in params.split(","))):
            p = re.sub(r"\bconst\b", "", p)
            p = re.sub(r"\w+$", "", p.strip()).strip()    # the name
            types_.append(" ".join(p.split()))
        found[name] = (" ".join(ret.split()), types_)
    return found


def _accepts(c_type: str, ctype) -> bool:
    """Whether ``ctype`` carries an argument of the C type ``c_type``."""
    c_type = re.sub(r"\bconst\b", "", c_type)
    if "*" in c_type:
        if c_type.replace(" ", "") == "char*":
            return ctype is ctypes.c_char_p
        return ctype in _POINTER or isinstance(ctype, type) and issubclass(
            ctype, ctypes._Pointer)
    return ctype in _SCALARS[" ".join(c_type.split())]


class _Recorder:
    """Stands in for ``ctypes.CDLL``: each attribute is a namespace that
    keeps what ``bind`` sets on it."""

    def __init__(self, path):
        self.path, self.fns = path, {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, types.SimpleNamespace())


@pytest.fixture
def bound(monkeypatch):
    monkeypatch.setattr(ctypes, "CDLL", _Recorder)
    return sha256_cuda.bind("libsha256d_sweep.so")


def test_the_parser_reads_the_c_interface():
    funcs = exported_functions(sha256_cuda.SOURCE.read_text())
    assert funcs["sha256d_sweep_block_threads"] == ("int", [])
    assert funcs["sha256d_sweep_error_string"] == ("const char*", ["int"])
    ret, params = funcs["sha256d_block_step_repeat"]
    assert ret == "int" and len(params) == 10
    assert params[0] == "int" and params[8] == "void*"
    assert funcs["sha256d_sweep_launch"][1][1] == "unsigned long long"
    assert funcs["sha256d_fused_enqueue"][1][-3:] == \
        ["void* *", "void* *", "void*"]


def binding_problems(funcs: dict, fns: dict) -> list[str]:
    """What ``bind``'s declarations (``fns``) get wrong about the C
    functions ``funcs``."""
    problems = sorted(f"{name} is not exported"
                      for name in set(fns) - set(funcs))
    for name, (ret, params) in funcs.items():
        fn = fns.get(name)
        if fn is None or not hasattr(fn, "argtypes") \
                or not hasattr(fn, "restype"):
            problems.append(f"{name} lacks argtypes or restype")
            continue
        if len(fn.argtypes) != len(params):
            problems.append(f"{name} takes {len(params)} arguments, bound "
                            f"with {len(fn.argtypes)}")
            continue
        problems += [f"{name} argument {i}: {c_type} bound as {ctype}"
                     for i, (c_type, ctype) in enumerate(zip(params,
                                                             fn.argtypes))
                     if not _accepts(c_type, ctype)]
        if not _accepts(ret, fn.restype):
            problems.append(f"{name} returns {ret}, bound as {fn.restype}")
    return problems


def test_every_exported_function_is_declared_with_matching_types(bound):
    funcs = exported_functions(sha256_cuda.SOURCE.read_text())
    assert set(funcs) == {
        "sha256d_sweep_launch", "sha256d_sweep_launch_ext_symbol",
        "sha256d_block_step_launch", "sha256d_block_step_repeat",
        "sha256d_fused_enqueue", "sha256d_sweep_occupancy",
        "sha256d_sweep_resident_blocks", "sha256d_sweep_block_threads",
        "sha256d_sweep_error_string"}
    assert binding_problems(funcs, bound.fns) == []


def test_a_missing_or_wrong_declaration_is_caught(bound):
    funcs = exported_functions(sha256_cuda.SOURCE.read_text())
    fns = bound.fns
    fns["sha256d_block_step_repeat"].argtypes = \
        fns["sha256d_block_step_repeat"].argtypes[:-1]
    fns["sha256d_sweep_launch"].argtypes[1] = ctypes.c_int
    del fns["sha256d_sweep_block_threads"].argtypes
    fns["sha256d_sweep_resident_blocks"].restype = ctypes.c_int
    assert binding_problems(funcs, fns) == [
        "sha256d_sweep_launch argument 1: unsigned long long bound as "
        f"{ctypes.c_int}",
        "sha256d_block_step_repeat takes 10 arguments, bound with 9",
        f"sha256d_sweep_resident_blocks returns long long, bound as "
        f"{ctypes.c_int}",
        "sha256d_sweep_block_threads lacks argtypes or restype"]
