"""The fused Grad-CAM tail — CUDA kernel and its plain PyTorch version.

Replaces `cadx_tpu/kernels/nn_kernels.py::gradcam_tail_pallas` (its
`pl.pallas_call` at :254), the tail of `pipeline/fused.py::run_pipeline`
once per explained class: per image, GAP(grads) -> relu(sum_k w_k A_k) ->
min-max (+1e-7) -> bilinear upsample as R @ cam @ C^T -> clamp to [0, 1]
-> trunc(* 255) heatmap -> JET -> blend onto the image as
`kernels/overlay.py` does. Source: `csrc/gradcam_tail.cu` (with
`csrc/jet.cuh`).

Layout: acts and grads (B, h, w, F) float32 at any strides (the
pipeline's are channel-last views of channel-first tensors), the image
(B, oh, ow) float32, contiguous. One block of 1,024 threads per image: the
F weights, the h*w CAM and the oh*w rows of R @ cam stay in shared memory;
pass 1 writes the heatmap and takes the peak blend, pass 2 rereads its own
heat levels and writes the overlay. One block per image leaves SMs idle
at small batches (at B=64, 64 of the H100's 132); a later PR may split an
image over several blocks. The sampling matrices come from the host
(`ops/resize.py::_interp_matrix`: sample points in float64, weights in
float32, both weights of an edge row where lo == hi summed into one
entry), cached per shape and device, so the kernel uses the plain
version's weights. Each product with them is a chain of fused
multiply-adds in ascending k from 0, the order cuBLAS accumulates the
plain version's (R @ cam) @ C^T in. The GAP over h*w cells and the sum
over F channels add in the order torch's CUDA reduction adds them
(`_reduce_split`, read from ATen's Reduce.cuh and checked on the card)
where the gradients are channel-last and the activations channel-first,
as the pipeline gives them; for other layouts the order may differ.
Kernel and plain version are held to heat +-1 and overlay +-2 where the
heat agrees (the Pallas kernel's own tolerances against the XLA tail).
Bound: bytes, acts, grads and the image read once and the overlay and
heatmap written once, at the card's memory rate (3.35 TB/s on an H100
SXM): 10.3 us at B=64, (6, 6, 64) -> 256².
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.kernels.overlay import jet_blend_reference, jet_lut_rgb
from cadx_tpu_torch.ops.resize import _interp_matrix, resize_linear_mxu

SOURCE = "cadx_tpu_torch/csrc/gradcam_tail.cu"
REPLACES = "cadx_tpu/kernels/nn_kernels.py:254"


def cam_from_acts_grads(acts: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """weights = GAP(grads), cam = relu(sum_k w_k A_k), min-max per sample
    to [0, 1] (+1e-7 guard). (B, h, w, F) -> (B, h, w)."""
    weights = grads.mean(dim=(1, 2), keepdim=True)
    cam = torch.relu((weights * acts).sum(dim=-1))
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / (hi - lo + 1e-7)


def gradcam_tail_reference(acts: torch.Tensor, grads: torch.Tensor, img01: torch.Tensor,
                           out_hw: tuple[int, int]):
    """Plain version: cam_from_acts_grads -> resize_linear_mxu -> clamp ->
    trunc(* 255) -> jet_blend's plain version."""
    cam_big = resize_linear_mxu(cam_from_acts_grads(acts, grads), out_hw)
    heat_u8 = (torch.clamp(cam_big, 0.0, 1.0) * 255).to(torch.uint8)
    return jet_blend_reference(heat_u8, img01), heat_u8


def _reduce_split(num_outputs: int, inner_outputs: int, n_reduce: int) -> int:
    """Over how many threads torch's CUDA reduction (ATen Reduce.cuh,
    setReduceConfig) splits each output's `n_reduce` float32 inputs when
    the reduced dimension is not the innermost one: `num_outputs` outputs,
    `inner_outputs` of them contiguous. Outputs go four (or two) to a
    thread where `inner_outputs` allows; a block holds 512 threads, at
    most 32 wide; the block's rows split an output's inputs when that
    leaves each row at least 16 of them. The kernel follows splits of up
    to 32; a wider one is taken as 1 (another order, within tolerance)."""
    vec = next(v for v in (4, 2, 1) if inner_outputs % v == 0)
    max_threads = 512 // vec
    dim0, dim1 = num_outputs // vec, n_reduce

    def pow2_cap(n: int) -> int:
        return 1 << (n.bit_length() - 1) if 0 < n < max_threads else max_threads

    width = min(pow2_cap(dim0), 32)
    height = min(pow2_cap(dim1), max_threads // width)
    split = height if n_reduce >= 16 * height or n_reduce >= 256 else 1
    return split if split <= 32 else 1


@functools.cache
def _sampling(oh: int, h: int, ow: int, w: int, device: torch.device):
    """R (oh, h) and C^T (w, ow) on `device`, once per shape."""
    r = torch.as_tensor(_interp_matrix(oh, h), device=device)
    ct = torch.as_tensor(np.ascontiguousarray(_interp_matrix(ow, w).T), device=device)
    return r, ct


def gradcam_tail(acts: torch.Tensor, grads: torch.Tensor, img01: torch.Tensor,
                 out_hw: tuple[int, int]):
    """acts, grads (B, h, w, F) float32, img01 (B, oh, ow) float32 in [0, 1]
    -> (overlay (B, oh, ow, 3) uint8 RGB, heatmap (B, oh, ow) uint8). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if acts.device.type == "cpu":
        return gradcam_tail_reference(acts, grads, img01, out_hw)
    oh, ow = out_hw
    for name, t in (("acts", acts), ("grads", grads)):
        if t.device != acts.device or t.dtype != torch.float32 or t.ndim != 4:
            raise ValueError(f"gradcam_tail: {name} must be a (B, h, w, F) float32 "
                             f"tensor on {acts.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if acts.device.type != "cuda" or grads.shape != acts.shape:
        raise ValueError(f"gradcam_tail: acts {tuple(acts.shape)} on {acts.device} and "
                         f"grads {tuple(grads.shape)} must be one CUDA shape")
    _build.check_input(img01, torch.float32, "gradcam_tail image")
    b, h, w, f = acts.shape
    if tuple(img01.shape) != (b, oh, ow) or img01.device != acts.device:
        raise ValueError(f"gradcam_tail: image {tuple(img01.shape)} is not {(b, oh, ow)} "
                         f"on {acts.device}")
    overlay = torch.empty((b, oh, ow, 3), dtype=torch.uint8, device=acts.device)
    heat = torch.empty((b, oh, ow), dtype=torch.uint8, device=acts.device)
    if overlay.numel():
        r, ct = _sampling(oh, h, ow, w, acts.device)
        # the plain version's reductions: the GAP over the cells of
        # channel-last gradients (outputs (B, F)), the channel sum over
        # activations whose channel stride is h*w (outputs (B, h, w))
        ny_gap = _reduce_split(b * f, f, h * w)
        ny_sum = _reduce_split(b * h * w, h * w, f) if acts.stride(3) == h * w else 1
        lib = _build.load()
        rc = lib.cadx_gradcam_tail(acts.data_ptr(), grads.data_ptr(), img01.data_ptr(),
                                   r.data_ptr(), ct.data_ptr(), jet_lut_rgb().ctypes.data,
                                   overlay.data_ptr(), heat.data_ptr(), b, h, w, f, oh, ow,
                                   *acts.stride(), *grads.stride(), ny_gap, ny_sum,
                                   float(np.float32(b * f) / np.float32(b * f * h * w)),
                                   _build.stream_ptr(acts.device))
        _build.check(rc, "cadx_gradcam_tail")
        gradcam_tail.launches += 1
    return overlay, heat


gradcam_tail.launches = 0
