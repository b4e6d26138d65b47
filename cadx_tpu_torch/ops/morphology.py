"""Rectangular erode / dilate / opening with cv2's border rules.

Port of `cadx_tpu/ops/morphology.py` for (B, H, W) images. Min and max
are exact, so a padded max-pool gives the same values as the JAX van Herk
scans. Out-of-image pixels never win: +inf for erode, -inf for dilate.
`median_blur` is not on the ported slice and is not here yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _composed_window(ksize: int, iterations: int) -> tuple[int, int]:
    """n iterations of a k-wide element anchored at k//2 compose into one
    window of width n*(k-1)+1 anchored at n*(k//2)."""
    return (ksize - 1) * iterations + 1, (ksize // 2) * iterations


def _window_max(x: torch.Tensor, k: int, lo: int) -> torch.Tensor:
    """Max over rows [i-lo, i+k-1-lo] and the same columns, -inf outside."""
    if k == 1:
        return x
    hi = k - 1 - lo
    xp = F.pad(x[:, None], (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(F.max_pool2d(xp, (k, 1), stride=1), (1, k), stride=1)[:, 0]


def erode(img: torch.Tensor, ksize: int = 3, iterations: int = 1) -> torch.Tensor:
    k, lo = _composed_window(ksize, iterations)
    x = img.to(torch.float32)
    return (-_window_max(-x, k, lo)).to(img.dtype)


def dilate(img: torch.Tensor, ksize: int = 3, iterations: int = 1) -> torch.Tensor:
    k, lo = _composed_window(ksize, iterations)
    x = img.to(torch.float32)
    return _window_max(x, k, lo).to(img.dtype)


def opening(img: torch.Tensor, ksize: int, iterations: int = 1) -> torch.Tensor:
    """MORPH_OPEN: erode then dilate."""
    return dilate(erode(img, ksize, iterations), ksize, iterations)
