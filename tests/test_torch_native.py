"""The ctypes binding of the port's CUDA kernels against their C entry points.

``native.library()`` declares each entry point's argument types by hand; a
declaration that disagrees with the C signature in ``csrc/`` passes wrong
arguments without any error. Both sides are read here without a card: the
C signatures from the sources, the declarations from ``library()`` run on a
stand-in for the compiled library.
"""

import ctypes
import pathlib
import re
import types

import pytest

from marconet_tpu_torch import native

CSRC = pathlib.Path(native.__file__).resolve().parent / "csrc"
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _entry_points():
    """{name: [ctypes type of each parameter]} of every extern "C" function."""
    found = {}
    pattern = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in pattern.findall(src.read_text()):
            types_ = []
            for param in params.split(","):
                ctype = " ".join(param.split()[:-1]).replace(" *", "*")
                types_.append(C_TYPES[ctype])
            assert name not in found, f"{name} defined twice"
            found[name] = types_
    return found


ENTRY_POINTS = _entry_points()


class _FakeLib:
    def __init__(self, path):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, types.SimpleNamespace())


@pytest.fixture(scope="module")
def declared():
    """The function declarations ``native.library()`` makes."""
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "build", lambda: ("unused.so", 0.0))
    mp.setattr(native.ctypes, "CDLL", _FakeLib)
    try:
        lib = native.library.__wrapped__()
    finally:
        mp.undo()
    return lib.functions


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_declaration_matches_c_signature(declared, name):
    assert name in declared, f"{name} is not declared in native.library()"
    assert declared[name].argtypes == ENTRY_POINTS[name]
    assert declared[name].restype is ctypes.c_int


def test_every_declaration_has_a_c_entry_point(declared):
    assert ENTRY_POINTS, "no extern \"C\" entry point found in csrc/"
    assert set(declared) == set(ENTRY_POINTS)
