"""Build and load the port's CUDA kernels.

All of `csrc/*.cu` is compiled with one nvcc call for sm_90a (Hopper)
into a shared library with a plain C interface, under
`build/cadx_tpu_torch/` at the repository root, at first use. The
library's name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses it. It is loaded with ctypes;
every pointer and the stream are passed as `c_void_p`, and every entry
point returns `cudaGetLastError()`, which `check` turns into an error.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cadx_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (pointers, ints, the stream last)
_SIGNATURES = {
    "cadx_equalize_hist": (_P, _P, _I, _I, _I, _P),
    "cadx_largest_obj": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "cadx_pectoral_tail": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcadx_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def check_input(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """A kernel takes a contiguous (B, H, W) CUDA tensor of one dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (B, H, W) {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
