"""Build and load the port's CUDA kernels.

Each of `csrc/*.cu` is compiled by its own nvcc process for sm_90a
(Hopper), all at once, and the objects are linked into the one shared
library of the port, with a plain C interface, under
`build/cadx_tpu_torch/` at the repository root, at first use (on an H100
host ~11 s for fifteen sources, the longest conv_leaky's template
instances; one nvcc call over six sources took ~12.3 s). The headers
`csrc/*.cuh` hold the device code that several sources share. The
library's name carries a hash of the sources, the headers and the flags,
so an edit rebuilds and an unchanged tree reuses it. It is loaded with
ctypes; `_SIGNATURES` gives each entry point its argument types: every
pointer and the stream `c_void_p`, element strides `c_longlong`. Every
entry point returns `cudaGetLastError()`, which `check` turns into an
error.

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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# entry point -> argument types (pointers, ints, the stream last)
_SIGNATURES = {
    "cadx_equalize_hist": (_P, _P, _P, _I, _I, _I, _P),
    "cadx_largest_obj": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "cadx_pectoral_tail": (_P,) * 8 + (_I,) * 8 + (_P,),
    "cadx_ccl": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "cadx_largest_component_mask": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "cadx_watershed_pair": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P),
    "cadx_watershed_packed": (_P,) * 6 + (_I,) * 9 + (_P,),
    "cadx_conv_leaky": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "cadx_conv_leaky_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "cadx_pool": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "cadx_pool_backward": (_P,) * 4 + (_I,) * 8 + (_L,) * 4 + (_P,),
    "cadx_upsample_nearest": (_P, _P, _I, _I, _I, _I, _I, _P),
    "cadx_batchnorm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "cadx_batchnorm_train": (_P,) * 10 + (_I,) * 6 + (_P,),
    "cadx_batchnorm_train_backward": (_P,) * 11 + (_I,) * 6 + (_P,),
    "cadx_jet_blend": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "cadx_gradcam_tail": (_P,) * 10 + (_I,) * 7 + (_L,) * 8 + (_I,) * 3 + (_F, _P),
    "cadx_cleaner_front": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "cadx_largest_component_seeded": (_P, _P, _P, _I, _I, _I, _I, _P),
    "cadx_flood_from": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "cadx_adam_step": (_P,) * 5 + (_I,) + (_F,) * 8 + (_P, _P),
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


def _run(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")


def build() -> Path:
    """Compile `csrc/*.cu` unless a library for these sources exists: one
    nvcc per source, all started together, then one link."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc, *compile_flags, "-I", str(CSRC), "-c", "-o", obj,
                         str(src)])
        _run(cmds)
        tmp = os.path.join(tmpdir, lib.name)
        _run([[nvcc, *NVCC_FLAGS, "-o", tmp, *objs]])
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


def check_input(t: torch.Tensor, dtype: torch.dtype, name: str, ndim: int = 3) -> None:
    """A kernel takes a contiguous CUDA tensor of one dtype and rank: (B, H,
    W) unless `ndim` says otherwise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-dimensional {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
