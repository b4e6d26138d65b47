"""Thresholding (cv2.threshold THRESH_BINARY), batched over a leading B.

Port of `cadx_tpu/ops/threshold.py`. Every reduction that the JAX
function takes over one image is taken here over the last two axes, one
value per image, never over the batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cadx_tpu_torch.utils.profiling import host_sync


def image_max(img: torch.Tensor) -> torch.Tensor:
    """Per-image max over (H, W); uint16 is widened, as torch has no
    uint16 max on the CPU."""
    if img.dtype == torch.uint16:
        img = img.to(torch.int32)
    return img.amax(dim=(-2, -1))


def _per_image(v, ndim: int):
    """Broadcast a per-image (B,) value against a (B, H, W) image."""
    if isinstance(v, torch.Tensor) and v.ndim == 1:
        return v.view(-1, *([1] * (ndim - 1)))
    return v


def binary_threshold(img: torch.Tensor, thresh, maxval=255) -> torch.Tensor:
    """cv2.THRESH_BINARY: maxval where img > thresh (strict), else 0.
    `thresh` is a scalar or one value per image. uint16 is compared
    widened, as torch has no uint16 comparison on the CPU."""
    t = _per_image(thresh, img.ndim)
    on = torch.full((), maxval, dtype=img.dtype, device=img.device)
    wide = img.to(torch.int32) if img.dtype == torch.uint16 else img
    return torch.where(wide > t, on, torch.zeros((), dtype=img.dtype, device=img.device))


def relative_threshold_value(img: torch.Tensor, frac, mx: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Per-image threshold: frac >= 1 is absolute; otherwise
    int(max * frac) in float64 for u8/u16 images (a host table over all
    maxima), or floor(f32 max * frac). Returns int32 of shape (B,).
    `mx`: the images' maxima (`image_max`) where the caller has them, as
    a row-sharded image's all-reduced max."""
    b = img.shape[0]
    if isinstance(frac, (int, float)) and frac >= 1.0:
        return torch.full((b,), int(frac), dtype=torch.int32, device=img.device)
    if mx is None:
        mx = image_max(img)
    if isinstance(frac, float) and img.dtype in (torch.uint8, torch.uint16):
        n = 1 << (8 * img.element_size())
        table = torch.as_tensor(_trunc_table(frac, n), device=img.device)
        host_sync(img.device)   # a blocking copy from pageable memory
        return table[mx.to(torch.int64)]
    return torch.floor(mx.to(torch.float32) * frac).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _trunc_table(frac: float, n: int) -> np.ndarray:
    return np.asarray([int(m * frac) for m in range(n)], dtype=np.int32)


def max_pix_val(dtype: torch.dtype) -> int:
    if dtype == torch.uint8:
        return 255
    if dtype == torch.uint16:
        return 65535
    raise ValueError(f"Unknown dtype found in input image array: {dtype}")


def to_uint8(img: torch.Tensor, mx: torch.Tensor | None = None) -> torch.Tensor:
    """(img / max * 255) truncated to uint8, with the max taken per image
    (or given: `mx`, as in relative_threshold_value); saturated to [0, 255]
    first, as JAX's float to uint8 conversion saturates (a float upload
    with negative values, a PFM's, reads 0 there, not its value mod 256)."""
    if mx is None:
        mx = image_max(img)
    maxv = mx.to(torch.float32).clamp_min(1e-12).view(-1, 1, 1)
    return (img.to(torch.float32) / maxv * 255.0).clamp(0.0, 255.0).to(torch.uint8)
