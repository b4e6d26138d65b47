"""The kernel library's C interface against its ctypes bindings, on the CPU.

`kernels/_build.py` binds every entry point of `csrc/*.cu` by name with the
argument types of `_SIGNATURES`; ctypes checks none of them against the C
prototype, so a slip in arity or type only shows as a wrong result or a
crash on the card. These tests read the prototypes from the sources (no
nvcc needed) and hold the bindings to them, and hold `csrc/` to the one
flat directory of sources and shared headers that `_build` compiles.
"""

import ctypes
import re

import pytest

from cadx_tpu_torch.kernels import _build

_PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(cadx_\w+)\s*\(([^)]*)\)')
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", "", text, flags=re.S))


def _ctype(param: str):
    """The ctypes type of one C parameter: a pointer of any kind is
    c_void_p, the scalars as `_SCALARS` maps them."""
    param = " ".join(param.split())
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split() if w != "const"][:-1]  # the name dropped
    return _SCALARS[" ".join(words)]


def _prototypes() -> dict:
    """Entry point -> the ctypes lists of its prototypes in `csrc/*.cu` (a
    definition, and any declaration another source makes of it)."""
    found: dict = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _PROTOTYPE.findall(_strip_comments(src.read_text())):
            found.setdefault(name, []).append(
                (src.name, [_ctype(p) for p in params.split(",")]))
    return found


def test_every_entry_point_is_bound_and_nothing_else():
    assert set(_prototypes()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_binding_matches_the_prototype(name):
    prototypes = _prototypes().get(name)
    assert prototypes, f"no prototype of {name} in csrc/*.cu"
    for src, argtypes in prototypes:
        assert argtypes == list(_build._SIGNATURES[name]), (
            f"{name} in {src}: the C prototype takes {argtypes}, "
            f"_SIGNATURES binds {_build._SIGNATURES[name]}")


def test_every_header_is_included():
    text = "\n".join(_strip_comments(p.read_text()) for p in _build.CSRC.glob("*.cu"))
    included = set(re.findall(r'#include\s+"([^"]+)"', text))
    for header in sorted(_build.CSRC.glob("*.cuh")):
        assert header.name in included, f"{header.name} is included by no source"


def test_csrc_is_one_flat_directory():
    assert [p.name for p in _build.CSRC.iterdir() if p.is_dir()] == []
    assert {p.suffix for p in _build.CSRC.iterdir()} <= {".cu", ".cuh"}
    assert {p.name for p in _build._sources()} == {
        p.name for p in _build.CSRC.iterdir()}
