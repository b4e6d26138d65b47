"""Histogram equalization with cv2.equalizeHist semantics, batched.

Port of `cadx_tpu/ops/histogram.py`. `equalize_hist` goes through the
equalize kernel's wrapper (`kernels/equalize.py`), which launches the
CUDA kernel for a CUDA tensor and runs the plain version beside it for a
CPU tensor.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels.equalize import equalize, histogram256

__all__ = ["equalize_hist", "histogram256"]


def equalize_hist(img_u8: torch.Tensor) -> torch.Tensor:
    """Equalize each (H, W) uint8 image of a (B, H, W) batch."""
    if img_u8.dtype != torch.uint8:
        raise ValueError(
            f"equalize_hist needs uint8 input, got {img_u8.dtype} "
            "(rescale with ops.threshold.to_uint8 first)")
    return equalize(img_u8)
