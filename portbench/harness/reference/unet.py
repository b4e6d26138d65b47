"""Plain PyTorch reference of Ronneberger's U-Net and its Dice + BCE loss.

The network of Ronneberger, Fischer and Brox (2015, arXiv:1505.04597,
Fig. 1) as the configuration runs it: per encoder level two 3x3 convs +
bias + ReLU and a 2x2 max pool; a bottleneck of two more; per decoder
level a 2x2, stride-2 up-convolution + bias that halves the channels,
concatenated (up first) with the level's skip, then two 3x3 convs + ReLU;
a 1x1 head and a sigmoid. Convs pad SAME (k // 2). The pool's gradient
goes to the first maximum of each window in raster order (an argmax and
a scatter here). The loss is the port's `dice_bce_loss`: the sigmoid
clipped to [eps, 1 - eps], the batch mean of the pixels' BCE weighted by
`bce_weight`, plus one minus the batch mean of the per-sample soft Dice.

Parameters are plain tensors in a dict keyed by the port's parameter
names (`param_shapes`), in the port's order. `Precision` (`model.py`)
fixes the arithmetic of every conv: float32 with TF32 off, or the TF32
control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import FP32, Precision


def param_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, in the port's `named_parameters`
    order: enc.i, bottleneck, dec.i (conv1, conv2: weight, bias), head,
    up.i (weight (C, F, 2, 2), bias)."""
    feats = cfg["features"]
    out = []

    def double(prefix, cin, f):
        for j, c in ((1, cin), (2, f)):
            out.extend([(f"{prefix}.conv{j}.weight", (f, c, 3, 3)),
                        (f"{prefix}.conv{j}.bias", (f,))])

    cin = cfg["in_channels"]
    for i, f in enumerate(feats[:-1]):
        double(f"enc.{i}", cin, f)
        cin = f
    double("bottleneck", cin, feats[-1])
    dec = list(reversed(feats[:-1]))
    for i, f in enumerate(dec):
        double(f"dec.{i}", 2 * f, f)
    out.extend([("head.weight", (cfg["out_channels"], dec[-1], 1, 1)),
                ("head.bias", (cfg["out_channels"],))])
    cin = feats[-1]
    for i, f in enumerate(dec):
        out.extend([(f"up.{i}.weight", (cin, f, 2, 2)), (f"up.{i}.bias", (f,))])
        cin = f
    return out


class _MaxPoolFirst(torch.autograd.Function):
    """2x2 window max; the gradient goes to the first maximum of each
    window in raster order."""

    @staticmethod
    def forward(ctx, x):
        b, c, h, w = x.shape
        win = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
        win = win.reshape(b, c, h // 2, w // 2, 4)
        first = win.argmax(dim=-1, keepdim=True)    # the first of equal maxima
        ctx.save_for_backward(first)
        ctx.shape = x.shape
        return win.gather(-1, first).squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        (first,) = ctx.saved_tensors
        b, c, h, w = ctx.shape
        core = torch.zeros((b, c, h // 2, w // 2, 4), dtype=g.dtype, device=g.device)
        core.scatter_(-1, first, g.unsqueeze(-1))
        return core.reshape(b, c, h // 2, w // 2, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(
            b, c, h, w)


def _conv(x, params, name, p: Precision):
    w = params[name + ".weight"]
    return F.conv2d(p.rnd(x), p.rnd(w), params[name + ".bias"], padding=w.shape[-1] // 2)


def _double(x, params, prefix, p: Precision):
    x = torch.relu(_conv(x, params, prefix + ".conv1", p))
    return torch.relu(_conv(x, params, prefix + ".conv2", p))


def forward(params: dict, cfg: dict, x: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """(B, C, H, W) -> (B, out_channels, H, W) probabilities (the sigmoid)."""
    levels = len(cfg["features"]) - 1
    skips = []
    for i in range(levels):
        x = _double(x, params, f"enc.{i}", p)
        skips.append(x)
        x = _MaxPoolFirst.apply(x)
    x = _double(x, params, "bottleneck", p)
    for i, skip in enumerate(reversed(skips)):
        up = F.conv_transpose2d(p.rnd(x), p.rnd(params[f"up.{i}.weight"]),
                                params[f"up.{i}.bias"], stride=2)
        x = _double(torch.cat([up, skip], dim=1), params, f"dec.{i}", p)
    return torch.sigmoid(_conv(x, params, "head", p))


def dice_bce_loss(params: dict, cfg: dict, x: torch.Tensor, y: torch.Tensor,
                  p: Precision = FP32, eps: float = 1e-6) -> torch.Tensor:
    """x, y: (B, C, H, W); the weighted BCE + soft Dice of the clipped
    sigmoid, both batch means of per-sample terms."""
    prob = torch.clamp(forward(params, cfg, x, p), eps, 1 - eps)
    bce = (-(y * torch.log(prob) + (1 - y) * torch.log(1 - prob))).mean()
    inter = (prob * y).sum(dim=(1, 2, 3))
    denom = prob.sum(dim=(1, 2, 3)) + y.sum(dim=(1, 2, 3))
    dice = 1.0 - ((2 * inter + eps) / (denom + eps)).mean()
    w = cfg["training"]["bce_weight"]
    return w * bce + (1 - w) * dice
