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

`largest_component_seeded` is the density-seeded largest component of
`cadx_tpu/kernels/largest_obj.py::largest_component_mask` (:131-162),
which the JAX package reaches only through a test's `pallas_call`
(`tests/test_kernels.py:200`) and keeps off its paths; so does the port.
It floods from the mask pixel with the densest 17x17 neighbourhood and
keeps the flood when it holds a strict majority of the mask, which proves
it the unique largest component; otherwise it takes the CCL + largest
label. Its result is therefore `largest_component_plain`'s at the
fixpoint whatever the seed. Source: `csrc/seeded_component.cu`.

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
from cadx_tpu_torch.ops.components import (fill_holes, flood_from,
                                           largest_component_plain)
from cadx_tpu_torch.ops.morphology import opening

SOURCE = "cadx_tpu_torch/csrc/largest_obj.cu"
REPLACES = "cadx_tpu/kernels/largest_obj.py:238"
SEEDED_SOURCE = "cadx_tpu_torch/csrc/seeded_component.cu"
SEEDED_REPLACES = "cadx_tpu/kernels/largest_obj.py:131"
_SCRATCH_PLANES = 5
_SEEDED_PLANES = 4
_DENSITY_K = 17


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


def _axis_window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sum over the centred k-window [i - k//2, i + k - 1 - k//2] along
    `dim` (-2 or -1), zero outside the image; integer exact."""
    lo, hi = k // 2, k - 1 - k // 2
    n = x.shape[dim]
    pad = (lo + 1, hi) if dim == -1 else (0, 0, lo + 1, hi)
    c = torch.cumsum(torch.nn.functional.pad(x, pad), dim=dim, dtype=x.dtype)
    return c.narrow(dim, k, n) - c.narrow(dim, 0, n)


def _density_seed(mask: torch.Tensor, k: int = _DENSITY_K) -> torch.Tensor:
    """One-hot seed per image at the mask pixel with the densest k x k
    mask neighbourhood, the smallest raster index on ties, as JAX packs it
    (density << 20 | 0xFFFFF - index in int32: exact up to 2**20 pixels)."""
    h, w = mask.shape[-2:]
    m = mask.to(torch.int32)
    dens = _axis_window_sum(_axis_window_sum(m, k, -2), k, -1)
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).view(h, w)
    score = torch.where(mask, (dens << 20) | (0xFFFFF - idx),
                        torch.full((), -1, dtype=torch.int32, device=mask.device))
    best = score.amax(dim=(-2, -1), keepdim=True)
    best_idx = 0xFFFFF - (best & 0xFFFFF)
    return (idx == best_idx) & mask


def largest_component_seeded_reference(masks: torch.Tensor, connectivity: int = 8,
                                       max_iters: int = 128) -> torch.Tensor:
    """Plain version, JAX's algorithm with its sweep caps: the flood from
    the density seed where it holds a strict majority of the mask, else
    the CCL + largest label."""
    m = masks.to(torch.bool)
    comp = flood_from(m, _density_seed(m), max_iters, connectivity)
    area = comp.sum(dim=(-2, -1), dtype=torch.int64)
    total = m.sum(dim=(-2, -1), dtype=torch.int64)
    fast = (area * 2 > total).view(-1, 1, 1)
    if bool(fast.all()):
        return comp
    return torch.where(fast, comp, largest_component_plain(m, connectivity, max_iters))


def largest_component_seeded(masks: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) bool, the largest component of each
    mask (the smallest label on ties, empty for an empty mask). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if masks.device.type == "cpu":
        return largest_component_seeded_reference(masks, connectivity)
    _build.check_input(masks, torch.bool, "largest_component_seeded")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    b, h, w = masks.shape
    out = torch.empty_like(masks)
    if b:
        scratch = torch.empty((b, _SEEDED_PLANES, h, w), dtype=torch.int32,
                              device=masks.device)
        rc = _build.load().cadx_largest_component_seeded(
            masks.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, w,
            connectivity, _DENSITY_K, _build.stream_ptr(masks.device))
        _build.check(rc, "cadx_largest_component_seeded")
        largest_component_seeded.launches += 1
    return out


largest_component_seeded.launches = 0
