"""Non-overlapping window max and mean, and the max pool's backward — CUDA
kernels and their plain PyTorch versions.

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

The max pool's backward (`pool_backward`, same source) replaces no
`pallas_call`: JAX leaves that VJP to XLA (`cadx_tpu/ops/pool.py`'s
`_max_pool_ties_bwd`, `reduce_window`'s VJP for the first-maximum rule).
It reads x (the tensor the forward pooled), the pooled max and the
upstream g once and writes dx once, zero in the dropped rows and columns:
g goes to every element equal to its window max ("ties") or to the first
one in raster order ("first"); a NaN window gets none, -0.0 ties with
+0.0. dx holds g's bits or +0, so the kernel is bit-exact to the plain
version (`pool_backward_reference`, the tensor ops the port ran before:
a compare, a cumsum over each window for "first", a select). g may come
in any strides (the classifier's last pool gets a channels-last view of
the head's gradient). Bound: bytes, x and dx once each and the max and g
once each, 10 bytes a pooled-input element at s=2 in float32: the U-Net's
four pools at B=8 (134.2 M, 67.1 M, 33.6 M and 16.8 M elements) cannot
take less than 0.751 ms, the classifier's two at B=32 0.300 ms. At s=2 a
thread takes a 16-byte chunk of a window row pair's two rows (4 windows
in float32, 8 in bfloat16): every access of a warp is contiguous. A
4-D x in channels-last order (the U-Net's first skip: cuDNN's output
where the first conv reads an NHWC view) is read in that order and dx
written in it, the channel fastest across a warp (at s=2 a thread takes
8 neighbouring windows of one channel, so that its max and g are whole
16-byte loads): the forward pools a contiguous copy, which then dies with
the forward instead of being held for the backward.
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


def windows(x: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W) -> (..., oh, ow, size * size), the cropped windows in
    raster order."""
    h, w = x.shape[-2:]
    oh, ow = h // size, w // size
    xr = x[..., :oh * size, :ow * size].reshape(*x.shape[:-2], oh, size, ow, size)
    return xr.movedim(-3, -2).reshape(*x.shape[:-2], oh, ow, size * size)


def unwindow(core: torch.Tensor, like: torch.Tensor, size: int) -> torch.Tensor:
    """Inverse of `windows`, zero in the dropped rows and columns."""
    *lead, oh, ow, _ = core.shape
    core = core.reshape(*lead, oh, ow, size, size).movedim(-2, -3)
    out = torch.zeros_like(like)
    out[..., :oh * size, :ow * size] = core.reshape(*lead, oh * size, ow * size)
    return out


def pool_backward_reference(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                            size: int, first: bool) -> torch.Tensor:
    """Plain version of the max pool's backward: g to every element equal
    to its window max (first False) or to the first in raster order."""
    hit = windows(x, size) == out[..., None]
    if first:
        hit = hit & (torch.cumsum(hit.to(torch.int32), dim=-1) == 1)
    core = torch.where(hit, g[..., None], torch.zeros((), dtype=g.dtype, device=g.device))
    return unwindow(core.to(x.dtype), x, size)


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


def backward_routed(x: torch.Tensor) -> bool:
    """Whether `pool_backward` launches the kernel for a max pool of x: a
    CUDA float32 or bfloat16 tensor."""
    return x.device.type == "cuda" and x.dtype in _DTYPES


def channels_last(x: torch.Tensor) -> bool:
    """A 4-D x in channels-last order and not contiguous: `pool_backward`
    reads it as it is."""
    return (x.ndim == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def pool_backward(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, size: int,
                  first: bool) -> torch.Tensor:
    """dx of `pool(x, size, "max")` = out for the upstream gradient g (out's
    shape, any strides): g to every window maximum, or to the first in
    raster order where `first`. CPU tensors take the plain version; CUDA
    tensors (x contiguous or `channels_last`, out contiguous, all three of
    x's dtype, float32 or bfloat16) launch the kernel or raise. dx has x's
    layout."""
    if size < 1:
        raise ValueError(f"pool_backward: size must be >= 1, got {size}")
    if x.device.type == "cpu":
        return pool_backward_reference(x, out, g, size, first)
    if x.device.type != "cuda":
        raise ValueError(f"pool_backward: expected a CUDA tensor, got {x.device}")
    if x.ndim < 2:
        raise ValueError(f"pool_backward: expected (..., H, W), got {tuple(x.shape)}")
    h, w = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    pooled = (*lead, h // size, w // size)
    nhwc = channels_last(x)
    if (x.dtype not in _DTYPES or not (x.is_contiguous() or nhwc) or not out.is_contiguous()
            or tuple(out.shape) != pooled or tuple(g.shape) != pooled
            or out.dtype != x.dtype or g.dtype != x.dtype
            or out.device != x.device or g.device != x.device):
        raise ValueError(
            f"pool_backward: expected a contiguous or channels-last float32 or bfloat16 x, "
            f"a contiguous out and a g of shape {pooled} on its device and of its dtype, got "
            f"x {x.dtype} {tuple(x.shape)}, out {out.dtype} {tuple(out.shape)}, g {g.dtype} "
            f"{tuple(g.shape)}")
    dx = torch.empty_like(x)
    if dx.numel():
        c = lead[-1] if lead else 1
        n = x.numel() // (h * w * c)
        g4 = g.reshape(n, c, h // size, w // size)
        lib = _build.load()
        rc = lib.cadx_pool_backward(x.data_ptr(), out.data_ptr(), g4.data_ptr(), dx.data_ptr(),
                                    n, c, h, w, size, int(first), _DTYPES[x.dtype], int(nhwc),
                                    *g4.stride(), _build.stream_ptr(x.device))
        _build.check(rc, "cadx_pool_backward")
        pool_backward.launches += 1
    return dx


pool_backward.launches = 0
