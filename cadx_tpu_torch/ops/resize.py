"""Image resize matching the cv2 modes the pipeline uses.

Port of `cadx_tpu/ops/resize.py`. Bilinear sampling uses half-pixel
centres and no antialiasing (cv2.INTER_LINEAR, jax.image 'linear' with
antialias=False); sample points beyond the edge clamp to it. INTER_AREA
is an exact box mean for integer factors and, for any other factor,
jax.image's antialiased 'linear' resize: the triangle-filter weights of
`jax.image.scale_and_translate`, applied one tap at a time.
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
    """cv2.INTER_AREA. Integer downscale factors: the box mean, as the box
    sum times 1/(fh*fw), the order XLA computes it in. Other factors:
    antialiased linear (`_resize_antialias`). (B, H, W) or (B, H, W, C)."""
    h, w = img.shape[1:3]
    oh, ow = out_hw
    if not (oh > 0 and ow > 0 and h % oh == 0 and w % ow == 0):
        return _resize_antialias(img, (oh, ow))
    fh, fw = h // oh, w // ow
    x = img.to(torch.float32).reshape((img.shape[0], oh, fh, ow, fw)
                                      + tuple(img.shape[3:]))
    return x.sum(dim=(2, 4)) * (1.0 / (fh * fw))


@functools.cache
def _triangle_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero weights of jax.image's antialiased 'linear' resize along
    one axis, as (n_out, T) input indices and float32 weights (zero-weight
    padding on a short row). The float32 arithmetic follows
    `compute_weight_mat`: triangle kernel widened by 1/scale when
    downsampling, columns normalised by their sum, samples outside the
    input zeroed."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))          # (n_in, n_out)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32).T
    nz = weights != 0
    n_taps = max(int(nz.sum(axis=1).max()), 1)
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    idx = np.minimum(first[:, None] + np.arange(n_taps)[None, :], n_in - 1)
    taps = np.take_along_axis(weights, idx, axis=1)
    # a tap clamped onto the last input repeats it; only the first copy
    # may carry its weight
    taps[first[:, None] + np.arange(n_taps)[None, :] > n_in - 1] = 0.0
    return idx.astype(np.int64), taps.astype(f32)


def _resample_axis(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """sum_t w[:, t] * x[idx[:, t]] along `dim`, tap by tap, with separate
    multiplies and adds in a fixed order, so any device gives the same
    bits."""
    idx, taps = _triangle_taps(x.shape[dim], n_out)
    idx_t = torch.as_tensor(idx, device=x.device)
    w_t = torch.as_tensor(taps, device=x.device)
    shape = [1] * x.ndim
    shape[dim] = n_out
    out = None
    for t in range(idx.shape[1]):
        term = torch.index_select(x, dim, idx_t[:, t]) * w_t[:, t].view(shape)
        out = term if out is None else out + term
    return out


def _resize_antialias(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(img, .., 'linear', antialias=True) on the (H, W)
    axes of (B, H, W) or (B, H, W, C); an axis whose size is kept is left
    as it is, as jax.image leaves it."""
    x = img.to(torch.float32)
    for dim, n_out in ((1, out_hw[0]), (2, out_hw[1])):
        if x.shape[dim] != n_out:
            x = _resample_axis(x, dim, n_out)
    return x


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
