"""Largest object of a binary mask, with optional hole fill and opening —
CUDA kernel and its plain PyTorch version.

Replaces `cadx_tpu/kernels/largest_obj.py::largest_obj_pallas` (its
`pl.pallas_call` at :238), which chains `ccl_relax`,
`largest_mask_from_labels`, the border-flood hole fill and the opening in
one program. Source: `csrc/largest_obj.cu`, with the shared device code
in `csrc/components.cuh`.

Two orderings, as at the cleaner's two call sites:
- default: largest 8-connected component, then (fill) its holes, then
  (smooth_k) an opening with a smooth_k x smooth_k square;
- fill_first: fill the input's holes, then take the largest component.

Layout: one block of 1024 threads per image, looping to convergence
inside the block (a shared "changed" flag and __syncthreads), so no sweep
returns to the host. A 256x256 int32 plane is 256 KiB, more than a
block's 227 KB of shared memory, so the label, area and temporary planes
live in global memory (a per-image scratch of 5 int32 planes), where the
50 MB L2 holds them at these sizes. CCL is union-find that always links
to the smaller root, so a label is its component's minimum raster index;
areas are atomicAdd counts; holes are background components (4-connected)
that touch no border pixel. Bound: latency of the dependent L2 accesses
in the union-find and the k-wide window passes of the opening; one block
per image leaves SMs idle below 132 images.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.components import fill_holes, largest_component_plain
from cadx_tpu_torch.ops.morphology import opening

SOURCE = "cadx_tpu_torch/csrc/largest_obj.cu"
REPLACES = "cadx_tpu/kernels/largest_obj.py:238"
_SCRATCH_PLANES = 5


def largest_obj_reference(masks: torch.Tensor, connectivity: int = 8,
                          fill: bool = False, smooth_k: int = 0,
                          fill_first: bool = False,
                          max_iters: int = 128) -> torch.Tensor:
    """Plain version: the composed ops the JAX cleaner uses off the TPU,
    plain on any device (the public `largest_component` would launch the
    CCL and mode kernels on a CUDA tensor)."""
    m = masks.to(torch.bool)
    if fill_first:
        m = fill_holes(m, max_iters)
    out = largest_component_plain(m, connectivity, max_iters)
    if fill and not fill_first:
        out = fill_holes(out, max_iters)
    if smooth_k:
        out = opening(out.to(torch.uint8), smooth_k) > 0
    return out


def largest_obj(masks: torch.Tensor, connectivity: int = 8,
                fill: bool = False, smooth_k: int = 0,
                fill_first: bool = False) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) bool. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if masks.device.type == "cpu":
        return largest_obj_reference(masks, connectivity, fill, smooth_k,
                                     fill_first)
    _build.check_input(masks, torch.bool, "largest_obj")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    b, h, w = masks.shape
    out = torch.empty_like(masks)
    if b:
        scratch = torch.empty((b, _SCRATCH_PLANES, h, w), dtype=torch.int32,
                              device=masks.device)
        lib = _build.load()
        rc = lib.cadx_largest_obj(
            masks.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, w,
            connectivity, int(fill), int(smooth_k), int(fill_first),
            _build.stream_ptr(masks.device))
        _build.check(rc, "cadx_largest_obj")
        largest_obj.launches += 1
    return out


largest_obj.launches = 0
