"""Convolution and LeakyReLU.

Port of `cadx_tpu/ops/conv.py`. Inside the port's modules convolutions
run in PyTorch's layout, (B, C, H, W) activations and (O, I, kh, kw)
weights; `convert.py` turns the JAX package's HWIO kernels into it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *,
           padding: str = "VALID") -> torch.Tensor:
    """Stride-1 conv. x: (B, C, H, W), weight: (F, C, kh, kw), bias:
    (F,). `padding` is "VALID" or "SAME" (k // 2 for odd k)."""
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    pad = 0 if padding == "VALID" else weight.shape[-1] // 2
    return F.conv2d(x, weight, bias, padding=pad)


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """where(x > 0, x, alpha * x): z == 0 takes the alpha branch."""
    return torch.where(x > 0, x, alpha * x)
