"""Histogram equalization (cv2.equalizeHist) — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/equalize.py::equalize_hist_pallas` (its
`pl.pallas_call` at :109). Source: `csrc/equalize.cu`.

Layout (redesigned for the whole card): one C call queues a memset of a
(B, 256) int32 histogram scratch and two launches, with no host sync,
over chunks x images in one flat grid, so one 3328x2560 image fills the
card as a batch of 64 at 256² does. A chunk is 1-16 passes of 4 KB (256
threads, 16 bytes a load), as many as give about four blocks an SM over
the batch. The histogram launch counts each chunk into per-warp shared
histograms and adds each nonzero bin once to the image's histogram (exact
integer atomics, so every run gives the same bytes); the zero background's
hot bin is taken by counting a thread's 16 equal bytes with the warp's
lanes that hold the same value (`__match_any_sync`) and other runs of
equal bytes in a register. The map launch rebuilds its image's LUT from
the finished histogram (a block-wide prefix sum, each bin on its own
thread, the reference's f32 arithmetic) and maps its chunk through it in
shared memory with 16-byte loads and stores; the second read of the image
comes from the 50 MB L2, which holds every path image (12.2 MB at most).
Image b starts at byte b * H * W, so a block takes the bytes of its chunk
outside its 16-byte boundaries one a thread; the output is placed at the
input's address modulo 16 so the loads and stores pair up.

Bound: bytes, 2 a pixel (one read, one write); this design moves 3 (the
second read from L2).
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


def _aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor like x whose address agrees with x's modulo 16, so
    the kernel's 16-byte loads and stores pair up (a view of x that starts
    off a 16-byte boundary gets an output off it by as much)."""
    out = torch.empty_like(x)
    if (out.data_ptr() - x.data_ptr()) % 16 == 0:
        return out
    buf = torch.empty(x.numel() + 15, dtype=x.dtype, device=x.device)
    shift = (x.data_ptr() - buf.data_ptr()) % 16
    return buf[shift:shift + x.numel()].view(x.shape)


def equalize(img_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> equalized uint8. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if img_u8.device.type == "cpu":
        return equalize_reference(img_u8)
    _build.check_input(img_u8, torch.uint8, "equalize")
    b, h, w = img_u8.shape
    out = _aligned_like(img_u8)
    if img_u8.numel():
        hist = torch.empty((b, 256), dtype=torch.int32, device=img_u8.device)
        rc = _build.load().cadx_equalize_hist(img_u8.data_ptr(), out.data_ptr(),
                                              hist.data_ptr(), b, h, w,
                                              _build.stream_ptr(img_u8.device))
        _build.check(rc, "cadx_equalize_hist")
        equalize.launches += 1
    return out


equalize.launches = 0
