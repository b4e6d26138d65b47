"""Histogram equalization (cv2.equalizeHist) — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/equalize.py::equalize_hist_pallas` (its
`pl.pallas_call` at :109). Source: `csrc/equalize.cu`.

Layout: one block per image. The 256-bin histogram lives in shared
memory (exact integer atomics), one thread forms the CDF and the LUT, and
the block then maps its image through the LUT. The TPU kernel's nibble
one-hot matmuls existed for the TPU's matrix unit; on Hopper, shared
memory atomics give exact counts directly. Bound: one read and one write
of each pixel (2 bytes/pixel) plus the per-block histogram atomics; with
one block per image, a batch smaller than the SM count leaves SMs idle.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build

SOURCE = "cadx_tpu_torch/csrc/equalize.cu"
REPLACES = "cadx_tpu/kernels/equalize.py:109"


def histogram256(img_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> (B, 256) int32 counts per image."""
    b = img_u8.shape[0]
    flat = img_u8.reshape(b, -1).to(torch.int64)
    hist = torch.zeros((b, 256), dtype=torch.int32, device=img_u8.device)
    return hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))


def equalize_reference(img_u8: torch.Tensor) -> torch.Tensor:
    """Plain version. cv2's rule: lut = round((cdf - cdf_min) * 255 /
    max(N - cdf_min, 1)) in f32, round half to even, clipped to [0, 255];
    cdf_min is the count at the lowest occupied level; a single-level
    image passes through unchanged."""
    b = img_u8.shape[0]
    hist = histogram256(img_u8)
    cdf = torch.cumsum(hist, dim=1, dtype=torch.int32)
    total = cdf[:, -1:]
    first_idx = (hist > 0).to(torch.int32).argmax(dim=1, keepdim=True)
    cdf_min = torch.gather(cdf, 1, first_idx)
    denom = torch.clamp_min(total - cdf_min, 1)
    lut = torch.round((cdf - cdf_min).to(torch.float32) * 255.0
                      / denom.to(torch.float32))
    lut = lut.clamp(0, 255).to(torch.uint8)
    flat = img_u8.reshape(b, -1).to(torch.int64)
    out = torch.gather(lut, 1, flat).view_as(img_u8)
    single_level = ((hist > 0).sum(dim=1) <= 1).view(b, 1, 1)
    return torch.where(single_level, img_u8, out)


def equalize(img_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> equalized uint8. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if img_u8.device.type == "cpu":
        return equalize_reference(img_u8)
    _build.check_input(img_u8, torch.uint8, "equalize")
    b, h, w = img_u8.shape
    out = torch.empty_like(img_u8)
    if b:
        lib = _build.load()
        rc = lib.cadx_equalize_hist(img_u8.data_ptr(), out.data_ptr(), b, h, w,
                                    _build.stream_ptr(img_u8.device))
        _build.check(rc, "cadx_equalize_hist")
        equalize.launches += 1
    return out


equalize.launches = 0
