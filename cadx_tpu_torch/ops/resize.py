"""Image resize matching the cv2 modes the pipeline uses.

Port of `cadx_tpu/ops/resize.py`. Bilinear sampling uses half-pixel
centres and no antialiasing (cv2.INTER_LINEAR, jax.image 'linear' with
antialias=False); sample points beyond the edge clamp to it. INTER_AREA
is ported for integer factors only, where it is an exact box mean.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def resize_linear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W) or channel-last (B, H, W, C) float."""
    x = img.to(torch.float32)
    if x.ndim == 3:
        return F.interpolate(x[:, None], size=tuple(out_hw), mode="bilinear",
                             align_corners=False, antialias=False)[:, 0]
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def resize_area(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_AREA for integer downscale factors: the box mean, as
    the box sum times 1/(fh*fw), the order XLA computes it in.
    (B, H, W) or (B, H, W, C)."""
    h, w = img.shape[1:3]
    oh, ow = out_hw
    if not (oh > 0 and ow > 0 and h % oh == 0 and w % ow == 0):
        raise NotImplementedError(
            f"resize_area is ported for integer factors only ({h}x{w} -> "
            f"{oh}x{ow})")
    fh, fw = h // oh, w // ow
    x = img.to(torch.float32).reshape((img.shape[0], oh, fh, ow, fw)
                                      + tuple(img.shape[3:]))
    return x.sum(dim=(2, 4)) * (1.0 / (fh * fw))


@functools.cache
def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear sampling matrix, half-pixel centres."""
    r = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0,
                n_in - 1.0)
    lo = np.floor(r).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (r - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m


def resize_linear_mxu(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize as two matmuls, R @ img @ C^T, on the last two
    axes. The same sample points as resize_linear; the summation order
    differs by about an ulp."""
    oh, ow = out_hw
    h, w = img.shape[-2], img.shape[-1]
    r = torch.as_tensor(_interp_matrix(oh, h), device=img.device)
    ct = torch.as_tensor(_interp_matrix(ow, w).T, device=img.device)
    return r @ img.to(torch.float32) @ ct
