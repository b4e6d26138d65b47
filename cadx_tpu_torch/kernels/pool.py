"""Non-overlapping window max and mean — CUDA kernel and its plain PyTorch
version.

Replaces `cadx_tpu/kernels/nn_kernels.py::max_pool_pallas` and
`avg_pool_pallas` (their `_pool_pallas`, `pl.pallas_call` at :93): the
forward of the classifier's tie-semantics max pool and of the U-Net's
2x2 pools. Source: `csrc/pool.cu`, one kernel templated on the element
type (float32, bfloat16) and the mode.

Layout: (..., H, W) planes, contiguous (NCHW in the port), output (...,
H // s, W // s) with the trailing rows and columns dropped. One thread per
output element; a warp reads s rows of 32*s neighbouring elements and
writes 32 neighbouring outputs. Max is exact in any order; mean sums the
window in float32 in raster order and multiplies by the float32
reciprocal of s*s (what XLA compiles JAX's mean to), which the plain
version repeats, so the two agree bit for bit. Bound: bytes, each input
element read once and each output written once, at the card's memory
rate (3.35 TB/s on an H100 SXM); e.g. the 2x2 pool after the advanced
classifier's first layer at B=32 (268 MB in, 67 MB out) cannot take less
than 0.10 ms.
"""

from __future__ import annotations

import numpy as np
import torch

from cadx_tpu_torch.kernels import _build

SOURCE = "cadx_tpu_torch/csrc/pool.cu"
REPLACES = "cadx_tpu/kernels/nn_kernels.py:93"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"max": 0, "mean": 1}


def pool_reference(x: torch.Tensor, size: int, mode: str = "max") -> torch.Tensor:
    """Plain version: crop to multiples of `size`, reshape, then the
    window max, or the float32 window sum in raster order times the
    float32 reciprocal of s*s."""
    h, w = x.shape[-2:]
    oh, ow = h // size, w // size
    xr = x[..., :oh * size, :ow * size].reshape(*x.shape[:-2], oh, size, ow, size)
    if mode == "max":
        return xr.amax(dim=(-3, -1))
    acc = xr[..., 0, :, 0].to(torch.float32)
    for i in range(size):
        for j in range(size):
            if i or j:
                acc = acc + xr[..., i, :, j].to(torch.float32)
    return (acc * float(np.float32(1.0) / np.float32(size * size))).to(x.dtype)


def pool(x: torch.Tensor, size: int, mode: str = "max") -> torch.Tensor:
    """(..., H, W) float32 or bfloat16 -> (..., H // size, W // size)
    window max ("max") or mean ("mean"). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if mode not in _MODES:
        raise ValueError(f"pool: mode must be 'max' or 'mean', got {mode!r}")
    if size < 1:
        raise ValueError(f"pool: size must be >= 1, got {size}")
    if x.device.type == "cpu":
        return pool_reference(x, size, mode)
    if x.device.type != "cuda":
        raise ValueError(f"pool: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES or x.ndim < 2 or not x.is_contiguous():
        raise ValueError(f"pool: expected a contiguous (..., H, W) float32 or "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    h, w = x.shape[-2:]
    out = torch.empty((*x.shape[:-2], h // size, w // size), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        lib = _build.load()
        rc = lib.cadx_pool(x.data_ptr(), out.data_ptr(), x.numel() // (h * w), h, w,
                           size, _MODES[mode], _DTYPES[x.dtype],
                           _build.stream_ptr(x.device))
        _build.check(rc, "cadx_pool")
        pool.launches += 1
    return out


pool.launches = 0
