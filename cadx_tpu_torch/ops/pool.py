"""Pooling and nearest upsampling with the reference's gradients.

Port of `cadx_tpu/ops/pool.py`, in the port's (B, C, H, W) layout (any
leading dims; the window runs over the last two). The forwards run the
hand-written kernels of `kernels/pool.py` and `kernels/upsample.py` (their
plain versions on CPU tensors); the backwards are plain tensor ops, as
JAX computes them in XLA. Windows are non-overlapping and trailing rows
and columns that do not fill one are dropped; they get zero gradient.

- `max_pool_ties`: the classifier's pool. Its backward gives the full
  upstream gradient to every element equal to its window max (the
  reference's switches, no 1/n split), as the JAX custom VJP does.
- `max_pool_first`: the U-Net's pool (JAX `_max_pool_plain`, a
  `reduce_window` max). Its backward sends the gradient to the first
  maximum of each window in raster order, as the `reduce_window` VJP and
  `F.max_pool2d` do.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels.pool import pool
from cadx_tpu_torch.kernels.upsample import upsample_nearest as _upsample_kernel


def _windows(x: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W) -> (..., oh, ow, size * size), the cropped windows in
    raster order."""
    h, w = x.shape[-2:]
    oh, ow = h // size, w // size
    xr = x[..., :oh * size, :ow * size].reshape(*x.shape[:-2], oh, size, ow, size)
    return xr.movedim(-3, -2).reshape(*x.shape[:-2], oh, ow, size * size)


def _unwindow(core: torch.Tensor, like: torch.Tensor, size: int) -> torch.Tensor:
    """Inverse of `_windows`, zero in the dropped rows and columns."""
    *lead, oh, ow, _ = core.shape
    core = core.reshape(*lead, oh, ow, size, size).movedim(-2, -3)
    out = torch.zeros_like(like)
    out[..., :oh * size, :ow * size] = core.reshape(*lead, oh * size, ow * size)
    return out


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size: int, first: bool):
        out = pool(x.contiguous(), size, "max")
        ctx.save_for_backward(x, out)
        ctx.size, ctx.first = size, first
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        hit = _windows(x, ctx.size) == out[..., None]
        if ctx.first:
            hit = hit & (torch.cumsum(hit.to(torch.int32), dim=-1) == 1)
        core = torch.where(hit, g[..., None], torch.zeros((), dtype=g.dtype,
                                                          device=g.device))
        return _unwindow(core.to(x.dtype), x, ctx.size), None, None


class _AvgPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size: int):
        ctx.size = size
        ctx.save_for_backward(x)
        return pool(x.contiguous(), size, "mean")

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        n = ctx.size * ctx.size
        core = (g / n)[..., None].expand(*g.shape, n)
        return _unwindow(core.to(x.dtype), x, ctx.size), None


class _Upsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor: int):
        ctx.factor = factor
        return _upsample_kernel(x.contiguous(), factor)

    @staticmethod
    def backward(ctx, g):
        f = ctx.factor
        h, w = g.shape[-2] // f, g.shape[-1] // f
        return g.reshape(*g.shape[:-2], h, f, w, f).sum(dim=(-3, -1)), None


def max_pool_ties(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """(..., H, W) -> (..., H // size, W // size) window max; the gradient
    goes in full to every tied maximum."""
    return _MaxPool.apply(x, size, False)


def max_pool_first(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """The same forward; the gradient goes to the first maximum of each
    window in raster order."""
    return _MaxPool.apply(x, size, True)


def max_pool_with_switches(x: torch.Tensor, size: int = 2):
    """(pooled, switches): switches has x's shape and is True at every
    element equal to its window max (False in the dropped remainder)."""
    out = pool(x.contiguous(), size, "max")
    hit = _windows(x, size) == out[..., None]
    return out, _unwindow(hit, torch.zeros_like(x, dtype=torch.bool), size)


def avg_pool(x: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Non-overlapping window mean (reference ImageSegmentation.average_pool)."""
    return _AvgPool.apply(x, size)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor; the gradient is
    the sum over each factor x factor window."""
    return _Upsample.apply(x, factor)
