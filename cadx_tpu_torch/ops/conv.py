"""Convolution and LeakyReLU.

Port of `cadx_tpu/ops/conv.py`. Inside the port's modules convolutions
run in PyTorch's layout, (B, C, H, W) activations and (O, I, kh, kw)
weights; `convert.py` turns the JAX package's HWIO kernels into it.
`conv2d_leaky`, the classifier's conv block, runs the hand-written kernel
of `kernels/conv_leaky.py` forward; its backward is the conv transposes
of `torch.nn.grad` with TF32 off, as JAX computes them in XLA. On
bfloat16 operands (the classifiers' opt-in mixed precision) it runs the
kernel's bfloat16 form, and the backward computes the transposes in
bfloat16 (float32 sums, bf16 results), as XLA does for JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cadx_tpu_torch.kernels.conv_leaky import conv_leaky, conv_leaky_bf16
from cadx_tpu_torch.precision import full_fp32


def _pad(padding: str, k: int) -> int:
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    return 0 if padding == "VALID" else k // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *,
           padding: str = "VALID") -> torch.Tensor:
    """Stride-1 conv. x: (B, C, H, W), weight: (F, C, kh, kw), bias:
    (F,). `padding` is "VALID" or "SAME" (k // 2 for odd k)."""
    return F.conv2d(x, weight, bias, padding=_pad(padding, weight.shape[-1]))


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """where(x > 0, x, alpha * x): z == 0 takes the alpha branch."""
    return torch.where(x > 0, x, alpha * x)


class _ConvLeaky(torch.autograd.Function):
    """Forward: the conv_leaky kernel (its plain version on the CPU), its
    bfloat16 form where x is bfloat16. Backward: dz = where(z > 0, g,
    alpha g), read off the output (y > 0 iff z > 0 for alpha >= 0), then
    the conv transposes; in bfloat16, alpha g is rounded (alpha a bf16
    scalar) and the bias gradient sums dz in float32."""

    @staticmethod
    def forward(ctx, x, w, b, alpha: float, pad: int):
        if x.dtype == torch.bfloat16:
            y = conv_leaky_bf16(x, w.to(torch.bfloat16), b, alpha, pad)
        else:
            y = conv_leaky(x, w, b, alpha, pad)
        ctx.save_for_backward(x, w, y)
        ctx.alpha, ctx.pad = alpha, pad
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        if y.dtype == torch.bfloat16:
            g = g.to(torch.bfloat16)
            dz = torch.where(y > 0, g, g * torch.tensor(ctx.alpha, dtype=torch.bfloat16))
            dx = dw = db = None
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, w.to(torch.bfloat16), dz,
                                                padding=ctx.pad).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x, w.shape, dz,
                                                 padding=ctx.pad).to(w.dtype)
            if ctx.needs_input_grad[2]:
                db = dz.to(torch.float32).sum(dim=(0, 2, 3))
            return dx, dw, db, None, None
        dz = torch.where(y > 0, g, ctx.alpha * g)
        dx = dw = db = None
        with full_fp32():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, w.to(dz.dtype), dz,
                                                padding=ctx.pad).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x.to(dz.dtype), w.shape, dz,
                                                 padding=ctx.pad).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = dz.sum(dim=(0, 2, 3))
        return dx, dw, db, None, None


def conv2d_leaky(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 alpha: float = 0.01, padding: str = "VALID") -> torch.Tensor:
    """Fused stride-1 conv + bias + LeakyReLU, float32, or bfloat16 where x
    is bfloat16 (weight cast to it, bias float32, output bfloat16). x: (B,
    C, H, W), weight: (F, C, k, k), bias: (F,); "SAME" zero-pads k // 2.
    Runs the conv_leaky kernel on a CUDA tensor and its plain version on a
    CPU tensor; differentiable in x, weight and bias."""
    if alpha < 0:
        raise ValueError(f"conv2d_leaky: alpha must be >= 0, got {alpha}")
    return _ConvLeaky.apply(x, weight, bias, float(alpha),
                            _pad(padding, weight.shape[-1]))
