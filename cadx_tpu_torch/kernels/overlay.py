"""JET colormap + show_cam_on_image blend — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/overlay.py::jet_blend_pallas` (its
`pl.pallas_call` at :76): a uint8 heatmap through cv2's JET table (BGR,
flipped to RGB), jet / 255 + the image, divided by the image's peak blend
over all its pixels and channels (at least 1e-7), times 255, truncated to
uint8. The overlay tail of `xai/gradcam.py::gradcam_overlay` and of the
reference resnet Grad-CAM. Source: `csrc/overlay.cu` (with `csrc/jet.cuh`).

Layout (redesigned for Hopper): the image is float32 in [0, 1], gray (B,
H, W) or RGB (B, H, W, 3). A thread takes a group of 16 pixels: the heat
as one 16-byte load, the gray values as four float4 (RGB twelve), the 48
overlay bytes as three 16-byte stores; an image's pixels before its first
16-byte boundary and after its last whole group (image b starts at pixel
b * H * W) go one a thread, and inputs off a 16-byte boundary take the
same groups a scalar at a time. Two forms, which `form_for` chooses by
shape. The one-launch form, where the images fit one block an SM at up to
512 threads a block (every path's overlays but the pipeline's B=64
batch; at 1,024 threads it measured slower than the wide form): one
cooperative launch, a group a thread; each thread keeps its group's
inputs in registers, each block writes
its peak blend to a slot of a float a block, and after the grid's barrier
each block takes its image's peak from its image's slots and recomputes
and writes its blends: the inputs are read once, with no memset or
atomic. The wide form, for the rest: a memset of a (B,) int32 peak and
two passes over chunks x images, the first taking each block's peak to
the image's with an integer atomicMax (the blends are positive floats),
the second reading the inputs again and writing the overlay. It
replaced a three-launch kernel (a 2,048-pixel chunk a block, byte and
scalar loads, both inputs read twice, three byte stores a pixel; PERF.md
section 6 row 9). The 768-byte table sits
in constant memory and each block copies it to shared memory. The kernel
repeats the plain version's float operations on the card in order (add,
then divide by the peak, then multiply by 255; CUDA's tensor / 255.0 is
a product with the float32 reciprocal), so the two agree bit for bit on
finite images. Bound: bytes, the heatmap (1 byte a pixel) and the image
(4 or 12) read once and the overlay (3) written once, at the card's
memory rate (3.35 TB/s on an H100 SXM): 8 bytes a gray pixel, e.g. 0.63
us for one 512² display image, 10 us for a 256² batch of 64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.colormap import apply_jet, jet_lut_bgr

SOURCE = "cadx_tpu_torch/csrc/overlay.cu"
REPLACES = "cadx_tpu/kernels/overlay.py:76"
MAX_THREADS = 512            # the one-launch form's largest block (csrc/overlay.cu)
GROUP = 16                   # pixels a thread
H100_SMS = 132


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


def form_for(b: int, h: int, w: int, sms: int = H100_SMS) -> str:
    """The form `jet_blend` launches for b images of (h, w) on a card of
    `sms` SMs: "once" where the images fit on at most `sms` blocks of
    MAX_THREADS threads, a GROUP of pixels a thread (one block an SM, so
    the cooperative grid is co-resident), else "wide" (the C entry point's
    rule: the one-launch form refuses larger batches)."""
    blocks = max(1, -(-(h * w // GROUP) // MAX_THREADS))
    return "once" if b * blocks <= sms else "wide"


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
        sms = _build.sm_count(heat_u8.device.index)
        # the one-launch form's float a block, or the wide form's peaks
        scratch = torch.empty(max(b, sms), dtype=torch.int32, device=heat_u8.device)
        rc = _build.load().cadx_jet_blend(
            heat_u8.data_ptr(), img01.data_ptr(), jet_lut_rgb().ctypes.data, scratch.data_ptr(),
            out.data_ptr(), b, h, w, int(rgb), int(form_for(b, h, w, sms) == "once"), sms,
            _build.stream_ptr(heat_u8.device))
        _build.check(rc, "cadx_jet_blend")
        jet_blend.launches += 1
    return out


jet_blend.launches = 0
