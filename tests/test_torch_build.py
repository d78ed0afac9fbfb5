"""The ctypes signatures of the kernel library (ttts_tpu_torch/ops/cuda/
_build.py `_SIGNATURES`) against the C entry points of ttts_tpu_torch/csrc/
*.cu, without nvcc: every `extern "C" int ttts_*` entry point has a
signature of its parameter count and types, with the stream last, and every
signature names an entry point that exists. A mismatch would pass garbage
arguments on the card; ctypes cannot see it."""

import ctypes
import re

import pytest

from ttts_tpu_torch.ops.cuda import _build

ENTRY = re.compile(r'extern\s+"C"\s+int\s+(ttts_\w+)\s*\(([^)]*)\)', re.S)


def _entry_points() -> dict:
    """{name: [C parameter declarations]} over every source."""
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in ENTRY.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


def _ctype(decl: str):
    """The ctypes type a C parameter declaration must be passed as."""
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


ENTRY_POINTS = _entry_points()


def test_every_signature_has_a_source():
    assert sorted(_build._SIGNATURES) == sorted(ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_signature_matches_the_entry_point(name):
    params = ENTRY_POINTS[name]
    assert params[-1] == "void* stream", f"{name}: the stream is not last"
    assert tuple(map(_ctype, params)) == _build._SIGNATURES[name], name
