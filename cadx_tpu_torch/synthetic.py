"""Synthetic mammograms for smoke runs, without jax, from a numpy seed.

`synthetic_mammograms` is the generator of `bench.py`: square uint8
images with a textured breast disc at the right edge, a bright pectoral
wedge in the top-right corner and one saturated square artifact.
`synthetic_native_mammogram` makes one upload at native depth and any
shape, for the serving path. `tile_edge_cases` makes the 0/200 images
that break a CCL which labels tiles first and joins them afterwards;
`equalize_edge_cases` the uint8 batches that break an equalize kernel.
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


def equalize_edge_cases(seed: int = 0) -> dict:
    """Name -> (B, H, W) uint8 batch, the inputs that break an equalize
    kernel: mammograms with a zero background (about half the pixels in
    one bin, `synthetic_mammograms` at 64²), an all-zero image, one level
    (the image passes through), one nonzero pixel, a 0-255 ramp, a
    "narrow" image whose LUT entries land on .5 (1,024 pixels: 514 at
    level 10, then levels whose (cdf - cdf_min) * 255 / 510 is 0.5, 1.5,
    ..., 50.5, rounded half to even, and the rest at level 62), and an
    odd-n batch (3, 37, 53) of noise whose images 1 and 2 start off a
    16-byte boundary."""
    rng = np.random.default_rng(seed)
    narrow = np.concatenate([np.full(514, 10), [11], np.repeat(np.arange(12, 62), 2),
                             np.full(409, 62)]).astype(np.uint8)
    one_pixel = np.zeros((1, 40, 40), np.uint8)
    one_pixel[0, 17, 23] = 201
    return {"zero background": synthetic_mammograms(4, 64, seed=seed),
            "all zero": np.zeros((2, 40, 40), np.uint8),
            "one level": np.full((2, 40, 40), 9, np.uint8),
            "one nonzero pixel": one_pixel,
            "ramp 0-255": np.arange(256, dtype=np.uint8).reshape(1, 16, 16),
            "narrow, LUT on .5": rng.permutation(narrow).reshape(1, 32, 32),
            "odd n (3, 37, 53)": rng.integers(0, 256, (3, 37, 53)).astype(np.uint8)}


def tile_edge_cases(h: int, w: int, tile: int = 32, seed: int = 0) -> np.ndarray:
    """(12, h, w) uint8 images of 0/200 shapes placed on the edges of
    `tile` x `tile` tiles, each clipped to the image (so 1 x n and n x 1
    shapes and sides that are multiples of no tile keep what fits):

    0. a serpentine: a row every third row, joined at alternate ends, so
       the one component crosses every tile edge;
    1. two equal squares, the one whose first pixel has the smaller raster
       index lying in a later tile (the second tile of the top row) than
       the other's first tile (the first): the tie goes to the first;
    2. the same squares joined by a 1-pixel bridge, which an opening of
       3 or more removes, leaving the tie to the second stage;
    3. a ring whose hole straddles a tile corner;
    4. two blocks that touch only diagonally across a tile corner: one
       8-connected component;
    5. a block holding two background pockets that touch only diagonally
       across a tile corner: a channel to the border reaches the first,
       the second stays a (4-connected) hole;
    6. a frame whose background reaches the border only through a
       1-pixel gap on a tile edge (no hole);
    7. runs of 33 and gaps of 2 along rows and columns, crossing every
       tile edge at a different offset;
    8-9. random 0/200 noise at densities 0.45 and 0.6;
    10. a dark image; 11. an all-200 image.
    """
    rng = np.random.default_rng(seed)
    t = tile
    out = np.zeros((12, h, w), np.uint8)

    def box(img, y0, y1, x0, x1, v=200):
        img[max(y0, 0):max(min(y1, h), 0), max(x0, 0):max(min(x1, w), 0)] = v

    s = out[0]
    for r in range(0, h, 3):
        s[r, :] = 200
        end = w - 1 if (r // 3) % 2 == 0 else 0
        s[r + 1:r + 3, end] = 200
    # 1, 2: square A's first pixel (0, t + 8) has raster index t + 8; square
    # B starts in tile 0 at row 4, a larger index
    for img in (out[1], out[2]):
        box(img, 0, 10, t + 8, t + 18)
        box(img, 4, 14, 2, 12)
    box(out[2], 8, 9, 12, t + 8)
    # 3: a ring round the tile corner (t, t)
    box(out[3], t - 9, t + 9, t - 9, t + 9)
    box(out[3], t - 4, t + 4, t - 4, t + 4, 0)
    # 4: blocks [t - 14, t) and [t, t + 14) meeting at the corner pixels
    # (t - 1, t - 1) and (t, t)
    box(out[4], t - 14, t, t - 14, t)
    box(out[4], t, t + 14, t, t + 14)
    # 5: pockets [t - 4, t) and [t, t + 4) in a block round the corner (t,
    # t), the first opened to the top border by a 1-pixel channel
    d = out[5]
    box(d, t - 10, t + 10, t - 10, t + 10)
    box(d, t - 4, t, t - 4, t, 0)
    box(d, t, t + 4, t, t + 4, 0)
    box(d, 0, t - 4, t - 2, t - 1, 0)
    # 6: a frame 3 wide with a gap at column t in its top side
    f = out[6]
    box(f, 2, t + 20, 2, t + 20)
    box(f, 5, t + 17, 5, t + 17, 0)
    box(f, 2, 5, t, t + 1, 0)
    g = out[7]
    pos = np.arange(max(h, w))
    runs = (pos % 35) < 33
    g[runs[:h], :] = 200
    g[:, ~runs[:w]] = 0
    out[8] = np.where(rng.random((h, w)) < 0.45, 200, 0)
    out[9] = np.where(rng.random((h, w)) < 0.6, 200, 0)
    out[11] = 200
    return out


def pectoral_tile_edge_inputs(h: int, w: int, seed: int = 0):
    """(img_equ, img_bin, breast_mask), each (12, h, w) uint8, for the
    pectoral tail on the inputs that break a tiled CCL: the high-threshold
    mask is `tile_edge_cases` (its objects cross tile edges and corners),
    the equalized image seeded noise (geodesic paths that wander across
    the watershed's tiles), the breast mask 255 but for the corner
    triangle (y + x) * 6 < h + w (the third marker)."""
    img_bin = tile_edge_cases(h, w, seed=seed)
    img_equ = np.random.default_rng(seed + 1).integers(0, 256, img_bin.shape).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    breast = np.where((yy + xx) * 6 < h + w, 0, 255).astype(np.uint8)
    return img_equ, img_bin, np.broadcast_to(breast, img_bin.shape).copy()
