"""Nearest-neighbour upsample by an integer factor — CUDA kernel and its
plain PyTorch version.

Replaces `cadx_tpu/kernels/nn_kernels.py::upsample_nearest_pallas` (its
`pl.pallas_call` at :128), the U-Net decoder's upsample. Source:
`csrc/upsample.cu`.

Layout: (..., h, w) planes, contiguous (NCHW in the port), output (...,
h*f, w*f). The grid runs over the source, so each source element is read
once. Factor 2 on rows of a multiple of 16 bytes, the U-Net's case, is the
fast path: a thread loads 16 bytes of consecutive source elements, builds
their doubled copies in registers and writes them with 16-byte stores to
both output rows (one 64-bit division a 16-byte vector, none an element).
Other factors, and rows that are not 16-byte aligned (odd widths, narrow
types), take a scalar path: a thread a source element, f x f stores. Values
are copied as raw bits of 1, 2, 4 or 8 bytes. Bound: bytes, the input read
once and the f^2 times larger output written once, at the card's memory
rate (3.35 TB/s on an H100 SXM); e.g. the U-Net's last upsample at B=8
(8x32x128x128 float32, 16.8 MB in, 67.1 MB out) cannot take less than 25
us.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build

SOURCE = "cadx_tpu_torch/csrc/upsample.cu"
REPLACES = "cadx_tpu/kernels/nn_kernels.py:128"


def upsample_nearest_reference(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Plain version: repeat_interleave along both spatial axes."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(..., h, w) -> (..., h * factor, w * factor). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if factor < 1:
        raise ValueError(f"upsample_nearest: factor must be >= 1, got {factor}")
    if x.device.type == "cpu":
        return upsample_nearest_reference(x, factor)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_nearest: expected a CUDA tensor, got {x.device}")
    if x.ndim < 2 or not x.is_contiguous() or x.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"upsample_nearest: expected a contiguous (..., h, w) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    h, w = x.shape[-2:]
    out = torch.empty((*x.shape[:-2], h * factor, w * factor), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        lib = _build.load()
        rc = lib.cadx_upsample_nearest(x.data_ptr(), out.data_ptr(),
                                       x.numel() // (h * w), h, w, factor,
                                       x.element_size(), _build.stream_ptr(x.device))
        _build.check(rc, "cadx_upsample_nearest")
        upsample_nearest.launches += 1
    return out


upsample_nearest.launches = 0
