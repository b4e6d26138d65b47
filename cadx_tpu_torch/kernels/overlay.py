"""JET colormap + show_cam_on_image blend — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/overlay.py::jet_blend_pallas` (its
`pl.pallas_call` at :76): a uint8 heatmap through cv2's JET table (BGR,
flipped to RGB), jet / 255 + the image, divided by the image's peak blend
over all its pixels and channels (at least 1e-7), times 255, truncated to
uint8. The overlay tail of `xai/gradcam.py::gradcam_overlay` and of the
reference resnet Grad-CAM. Source: `csrc/overlay.cu` (with `csrc/jet.cuh`).

Layout: the image is float32 in [0, 1], gray (B, H, W) or RGB (B, H, W,
3); the kernel reads it at a channel stride of 0 or 1. Two passes, each a
grid of 2,048-pixel chunks of every image: the first takes each chunk's
peak blend to the image's peak with an integer atomicMax (the blends are
positive floats), the second recomputes each blend, instead of keeping a
scratch plane, and writes the overlay. The 768-byte table sits in
constant memory and each block copies it to shared memory. The kernel
repeats the plain version's float operations on the card in order (add,
then divide by the peak, then multiply by 255; CUDA's tensor / 255.0 is
a product with the float32 reciprocal), so the two agree bit for bit.
Bound: bytes, the heatmap (1 byte a pixel) and the image (4 or 12) read
once and the overlay (3) written once, at the card's memory rate (3.35
TB/s on an H100 SXM): 8 bytes a gray pixel, e.g. 2.4 us for one 512²
display image, 10 us for a 256² batch of 64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.colormap import apply_jet, jet_lut_bgr

SOURCE = "cadx_tpu_torch/csrc/overlay.cu"
REPLACES = "cadx_tpu/kernels/overlay.py:76"


@functools.cache
def jet_lut_rgb() -> np.ndarray:
    """The (256, 3) uint8 RGB table the kernels upload, contiguous."""
    return np.ascontiguousarray(jet_lut_bgr()[:, ::-1])


def jet_blend_reference(heat_u8: torch.Tensor, img01: torch.Tensor) -> torch.Tensor:
    """Plain version: apply_jet -> flip to RGB -> / 255 -> + image ->
    joint max per image -> divide -> * 255 -> truncate."""
    jet_rgb = (apply_jet(heat_u8).to(torch.float32) / 255.0).flip(-1)
    over = jet_rgb + (img01[..., None] if img01.ndim == 3 else img01)
    over = over / torch.clamp_min(over.amax(dim=(1, 2, 3), keepdim=True), 1e-7)
    return (over * 255).to(torch.uint8)


def jet_blend(heat_u8: torch.Tensor, img01: torch.Tensor) -> torch.Tensor:
    """heat (B, H, W) uint8, img01 (B, H, W) or (B, H, W, 3) float32 ->
    (B, H, W, 3) uint8 RGB overlay. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if heat_u8.device.type == "cpu":
        return jet_blend_reference(heat_u8, img01)
    _build.check_input(heat_u8, torch.uint8, "jet_blend heat")
    rgb = img01.ndim == 4
    _build.check_input(img01, torch.float32, "jet_blend image", ndim=4 if rgb else 3)
    b, h, w = heat_u8.shape
    if (tuple(img01.shape[:3]) != (b, h, w) or (rgb and img01.shape[3] != 3)
            or img01.device != heat_u8.device):
        raise ValueError(f"jet_blend: image {tuple(img01.shape)} on {img01.device} does "
                         f"not match heat {(b, h, w)} on {heat_u8.device}")
    out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=heat_u8.device)
    if out.numel():
        peak = torch.empty(b, dtype=torch.int32, device=heat_u8.device)
        lib = _build.load()
        rc = lib.cadx_jet_blend(heat_u8.data_ptr(), img01.data_ptr(),
                                jet_lut_rgb().ctypes.data, peak.data_ptr(), out.data_ptr(),
                                b, h, w, 3 if rgb else 1, 1 if rgb else 0,
                                _build.stream_ptr(heat_u8.device))
        _build.check(rc, "cadx_jet_blend")
        jet_blend.launches += 1
    return out


jet_blend.launches = 0
