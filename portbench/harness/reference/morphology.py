"""Rectangular erode / dilate / opening with cv2's border rules.

A frozen copy of the port's plain `ops/morphology.py` (itself a port of
`cadx_tpu/ops/morphology.py` for (B, H, W) images. Min and max
are exact, so a padded max-pool gives the same values as the JAX van Herk
scans. Out-of-image pixels never win: +inf for erode, -inf for dilate.
`median_blur` is the k x k median with replicated borders (cv2.medianBlur).
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


def closing(img: torch.Tensor, ksize: int, iterations: int = 1) -> torch.Tensor:
    """MORPH_CLOSE: dilate then erode."""
    return erode(dilate(img, ksize, iterations), ksize, iterations)


def median_blur(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """k x k median of each (H, W) image of a (B, H, W) batch, borders
    replicated (cv2.medianBlur), through float32 and back to the input's
    dtype as JAX does: the k*k shifted views sorted along a new axis. Odd
    ksize only."""
    if ksize % 2 != 1 or ksize < 1:
        raise ValueError("median_blur requires an odd ksize >= 1")
    pad = ksize // 2
    h, w = img.shape[-2:]
    x = F.pad(img.to(torch.float32)[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]
    views = [x[:, i:i + h, j:j + w] for i in range(ksize) for j in range(ksize)]
    stack = torch.stack(views, dim=-1)
    return torch.sort(stack, dim=-1).values[..., (ksize * ksize) // 2].to(img.dtype)


def median_blur3(img: torch.Tensor) -> torch.Tensor:
    """cv2.medianBlur(img, 3)."""
    return median_blur(img, 3)
