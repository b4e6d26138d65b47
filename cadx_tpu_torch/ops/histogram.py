"""Histogram equalization with cv2.equalizeHist semantics, batched.

Port of `cadx_tpu/ops/histogram.py`. `equalize_hist` goes through the
equalize kernel's wrapper (`kernels/equalize.py`), which launches the
CUDA kernel for a CUDA tensor and runs the plain version beside it for a
CPU tensor.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels.equalize import equalize, histogram256

__all__ = ["apply_lut256", "equalize_hist", "histogram256"]


def equalize_hist(img_u8: torch.Tensor) -> torch.Tensor:
    """Equalize each (H, W) uint8 image of a (B, H, W) batch."""
    if img_u8.dtype != torch.uint8:
        raise ValueError(
            f"equalize_hist needs uint8 input, got {img_u8.dtype} "
            "(rescale with ops.threshold.to_uint8 first)")
    return equalize(img_u8)


def apply_lut256(img_u8: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """lut[img] for a uint8 image and a 256-entry table (or one table an
    image of a (B, H, W) batch, (B, 256)), each entry rounded half to even
    and cast back to the table's dtype, as JAX's one-hot matmul does."""
    table = torch.round(lut.to(torch.float32)).to(lut.dtype)
    idx = img_u8.to(torch.int64)
    if table.ndim == 1:
        return table[idx]
    return torch.gather(table, 1, idx.reshape(idx.shape[0], -1)).view(idx.shape)
