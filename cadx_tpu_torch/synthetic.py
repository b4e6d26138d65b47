"""Synthetic mammograms for smoke runs, without jax, from a numpy seed.

`synthetic_mammograms` is the generator of `bench.py`: square uint8
images with a textured breast disc at the right edge, a bright pectoral
wedge in the top-right corner and one saturated square artifact.
`synthetic_native_mammogram` makes one upload at native depth and any
shape, for the serving path.
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


def synthetic_native_mammogram(h: int, w: int, seed: int = 0,
                               dtype=np.uint16, top: int = 60000) -> np.ndarray:
    """(h, w) mammogram at native depth and shape: a half-ellipse breast at
    the right edge with textured tissue, a bright pectoral wedge in the
    top-right corner, zero background (as in CBIS-DDSM crops). The test
    suite's generator with the ellipse drawn in numpy."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), dtype)
    yy, xx = np.mgrid[0:h, 0:w]
    ax, ay = int(w * 0.7), int(h * 0.45)
    breast = (((xx - (w - 1)) / ax) ** 2 + ((yy - h // 2) / ay) ** 2 <= 1.0) & (xx <= w - 1)
    tissue = (top * 0.45 + rng.normal(0, top * 0.1, (h, w))).clip(
        top * 0.15, top * 0.75).astype(dtype)
    img[breast] = tissue[breast]
    wedge = ((w - 1 - xx) / w + yy / h) < 0.25
    img[wedge] = np.maximum(img[wedge], dtype(top * 0.9))
    return img
