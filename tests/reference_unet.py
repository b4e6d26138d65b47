"""Plain PyTorch reference of Ronneberger's U-Net for the CPU tests.

Ronneberger, Fischer and Brox (2015, arXiv:1505.04597, Fig. 1), as the
port's `UNetConfig(up="transpose")` runs it: per encoder level two SAME 3x3
convs + bias + ReLU, then a 2x2 max pool (torch's `F.max_pool2d`, whose
gradient goes to the first maximum of each window in raster order); a
bottleneck of two more; per decoder level a 2x2, stride-2 up-convolution +
bias (2f -> f channels), concatenated (up first) with the level's skip,
then two 3x3 convs + ReLU; a 1x1 head, then a sigmoid. The Dice + BCE loss
is `train/segmentation.py::dice_bce_loss`'s definition, and `adam` is one
Adam update in optax's order. Weights are a dict keyed by the port's
parameter names. Imports nothing of the port or of JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _double(params: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    for j in (1, 2):
        x = torch.relu(F.conv2d(x, params[f"{prefix}.conv{j}.weight"],
                                params[f"{prefix}.conv{j}.bias"], padding=1))
    return x


def unet(params: dict, x: torch.Tensor, levels: int, sigmoid: bool = True) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, out, H, W); `levels` encoder levels."""
    skips = []
    for i in range(levels):
        x = _double(params, f"enc.{i}", x)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = _double(params, "bottleneck", x)
    for i, skip in enumerate(reversed(skips)):
        up = F.conv_transpose2d(x, params[f"up.{i}.weight"], params[f"up.{i}.bias"], stride=2)
        x = _double(params, f"dec.{i}", torch.cat([up, skip], dim=1))
    x = F.conv2d(x, params["head.weight"], params["head.bias"])
    return torch.sigmoid(x) if sigmoid else x


def dice_bce(params: dict, x: torch.Tensor, y: torch.Tensor, levels: int,
             bce_weight: float = 0.5, eps: float = 1e-6) -> torch.Tensor:
    """Weighted BCE + soft Dice of the clipped sigmoid; x, y (B, C, H, W)."""
    p = torch.clamp(unet(params, x, levels), eps, 1 - eps)
    bce = (-(y * torch.log(p) + (1 - y) * torch.log(1 - p))).mean()
    inter = (p * y).sum(dim=(1, 2, 3))
    dice = (2 * inter + eps) / (p.sum(dim=(1, 2, 3)) + y.sum(dim=(1, 2, 3)) + eps)
    return bce_weight * bce + (1 - bce_weight) * (1 - dice.mean())


def adam(params: dict, grads: dict, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> dict:
    """The parameters after Adam's first step from zero moments."""
    c1 = float(np.float32(1) - np.float32(b1))
    c2 = float(np.float32(1) - np.float32(b2))
    out = {}
    for k, p in params.items():
        g = grads[k]
        m_hat = (1 - b1) * g / c1
        v_hat = (1 - b2) * g * g / c2
        out[k] = p - lr * (m_hat / (torch.sqrt(v_hat) + eps))
    return out
