"""Synthetic mammograms for smoke runs, without jax.

The same generator as `bench.py::synthetic_mammograms`: a textured
breast disc at the right edge, a bright pectoral wedge in the top-right
corner and one saturated square artifact, uint8, from a numpy seed.
"""

from __future__ import annotations

import numpy as np


def synthetic_mammograms(batch: int, hw: int, seed: int = 0) -> np.ndarray:
    """(batch, hw, hw) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    out = np.zeros((batch, hw, hw), np.uint8)
    for i in range(batch):
        cx = hw - 1
        r = hw // 2
        breast = ((xx - cx) ** 2 + (yy - hw // 2) ** 2) < r * r
        tissue = (110 + rng.normal(0, 25, (hw, hw))).clip(40, 185).astype(np.uint8)
        img = np.zeros((hw, hw), np.uint8)
        img[breast] = tissue[breast]
        wedge = ((hw - 1 - xx) + yy) < hw // 4
        img[wedge] = np.maximum(img[wedge], 230)
        ay, ax_ = rng.integers(0, hw // 2), rng.integers(0, hw // 4)
        img[ay : ay + 6, ax_ : ax_ + 6] = 255
        out[i] = img
    return out
