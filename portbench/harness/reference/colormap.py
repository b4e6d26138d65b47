"""cv2 COLORMAP_JET as exact integer ramps, and the blends around it.

A frozen copy of the port's plain `ops/colormap.py` (itself a port of
`cadx_tpu/ops/colormap.py`. Each BGR channel of cv2's JET table is
piecewise linear in the level with integer slopes, so lut[i] = y0 + sum_j
ds_j * max(i - b_j, 0) reproduces every entry. The JAX package derives the
ramps from cv2 at run time; the port carries the same constants (taken
from cv2's table) so it needs no cv2. `jet_lut_bgr` is the (256, 3) table
they make, which the jet_blend and gradcam_tail kernels keep in constant
memory. `add_weighted` is cv2.addWeighted and `normalize_to_u8` the
reference saliency scaling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# (y0 per channel, ((breakpoint, slope change), ...) per channel), BGR
_JET_Y0 = (128, 0, 0)
_JET_TERMS = (
    ((0, 4), (31, -1), (32, -3), (95, -1), (96, -3), (158, -1), (159, 4),
     (160, 1)),
    ((32, 4), (95, -1), (96, -3), (159, -3), (160, -1), (223, 4)),
    ((95, 2), (96, 2), (159, -3), (160, -1), (223, -3), (224, -1)),
)


def apply_jet(gray_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 -> (..., H, W, 3) uint8 BGR, cv2.applyColorMap(JET)."""
    i = gray_u8.to(torch.int32)
    chans = []
    for y0, terms in zip(_JET_Y0, _JET_TERMS):
        acc = torch.full_like(i, y0)
        for b, ds in terms:
            acc = acc + ds * torch.clamp_min(i - b, 0)
        chans.append(acc)
    return torch.stack(chans, dim=-1).to(torch.uint8)


@functools.cache
def jet_lut_bgr() -> np.ndarray:
    """OpenCV COLORMAP_JET as a (256, 3) uint8 BGR table, from the ramps."""
    return apply_jet(torch.arange(256, dtype=torch.uint8)).numpy()


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                 gamma: float = 0.0) -> torch.Tensor:
    """cv2.addWeighted: saturate(round(a*alpha + b*beta + gamma)) as uint8,
    rounding half to even."""
    out = a.to(torch.float32) * alpha + b.to(torch.float32) * beta + gamma
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def normalize_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Min-max to [0, 255] uint8: (x - min) / (max - min + 1e-8) * 255,
    truncated (explainability.py:73-74)."""
    x = x.to(torch.float32)
    lo, hi = x.amin(), x.amax()
    return ((x - lo) / (hi - lo + 1e-8) * 255.0).to(torch.uint8)
