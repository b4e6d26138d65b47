"""Pooling and nearest upsampling with the reference's gradients.

Port of `cadx_tpu/ops/pool.py`, in the port's (B, C, H, W) layout (any
leading dims; the window runs over the last two). The forwards run the
hand-written kernels of `kernels/pool.py` and `kernels/upsample.py`, and
so does the max pools' backward (`pool_backward`); each takes its plain
version on CPU tensors. The other backwards are plain tensor ops, as JAX
computes them in XLA. Windows are non-overlapping and trailing rows and
columns that do not fill one are dropped; they get zero gradient. The
counter `pool_bwd_kernel` counts the max pools whose backward the graph
records on the card with an input the backward kernel takes: a node
recorded, to be one launch of that kernel if the loss reaches it.

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

from cadx_tpu_torch.kernels.pool import (backward_routed, channels_last, pool, pool_backward,
                                         unwindow, windows)
from cadx_tpu_torch.kernels.upsample import upsample_nearest as _upsample_kernel
from cadx_tpu_torch.utils.profiling import count


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size: int, first: bool):
        xc = x.contiguous()
        out = pool(xc, size, "max")
        # a channels-last x is read as it is: its contiguous copy dies here
        ctx.save_for_backward(x if channels_last(x) else xc, out)
        ctx.size, ctx.first = size, first
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return pool_backward(x, out, g, ctx.size, ctx.first), None, None


def _max_pool(x: torch.Tensor, size: int, first: bool) -> torch.Tensor:
    # autograd runs a CUDA node's backward on its own thread, outside the
    # caller's spans: count the kernel's backward here, where the graph
    # records the node
    if backward_routed(x) and x.requires_grad and torch.is_grad_enabled():
        count("pool_bwd_kernel")
    return _MaxPool.apply(x, size, first)


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
        return unwindow(core.to(x.dtype), x, ctx.size), None


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
    return _max_pool(x, size, False)


def max_pool_first(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """The same forward; the gradient goes to the first maximum of each
    window in raster order."""
    return _max_pool(x, size, True)


def max_pool_with_switches(x: torch.Tensor, size: int = 2):
    """(pooled, switches): switches has x's shape and is True at every
    element equal to its window max (False in the dropped remainder)."""
    out = pool(x.contiguous(), size, "max")
    hit = windows(x, size) == out[..., None]
    return out, unwindow(hit, torch.zeros_like(x, dtype=torch.bool), size)


def avg_pool(x: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Non-overlapping window mean (reference ImageSegmentation.average_pool)."""
    return _AvgPool.apply(x, size)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor; the gradient is
    the sum over each factor x factor window."""
    return _Upsample.apply(x, factor)
