"""Largest object of a binary mask, with optional hole fill and opening —
CUDA kernel and its plain PyTorch version.

Replaces `cadx_tpu/kernels/largest_obj.py::largest_obj_pallas` (its
`pl.pallas_call` at :238), which chains `ccl_relax`,
`largest_mask_from_labels`, the border-flood hole fill and the opening in
one program. Source: `csrc/largest_obj.cu`, with the tiled device code
it shares with cleaner_front in `csrc/tiled_components.cuh`.

Two orderings, as at the cleaner's two call sites:
- default: largest 8-connected component, then (fill) its holes, then
  (smooth_k) an opening with a smooth_k x smooth_k square;
- fill_first: fill the input's holes, then take the largest component.

`largest_component_seeded` is the density-seeded largest component of
`cadx_tpu/kernels/largest_obj.py::largest_component_mask` (:131-162),
which the JAX package reaches only through a test's `pallas_call`
(`tests/test_kernels.py:200`) and keeps off its paths; so does the port.
JAX floods from the mask pixel with the densest 17x17 neighbourhood and
keeps the flood where it holds a strict majority of the mask, which
proves it the unique largest component; otherwise it takes the CCL +
largest label. Its result is therefore `largest_component_plain`'s at the
fixpoint whatever the seed, which is this kernel's selection with the
fill and the opening off: `csrc/seeded_component.cu` calls
`cadx_largest_obj` so (a memset and 5 launches), with no seed and no
flood, and its bytes equal `largest_obj(masks, conn)`'s.

Layout (redesigned for the whole card): the grid covers 32 x 32 tiles x
images, flattened, so any B runs and one large image fills every SM. One
C call issues a short sequence of launches on one stream with no host
sync: the conn-connected tiled union-find CCL with areas (`ccl_local`
labels a tile in shared memory from warp-ballot row runs, `ccl_merge`
joins tile edges with atomicMin-linked roots, `ccl_flatten` points
pixels at roots and counts areas once a block and root), `largest_key`
(each image's (area << 32 | ~label) max, one 64-bit atomicMax a block,
into a uint64 a memset clears first), `select_label`; the hole fill is
the background's 4-connected CCL with border marks and `fill_unmarked`
(before the selection with fill_first); the opening is four separable
window passes over byte planes. Roots end as each component's smallest
raster index whatever order the atomics take, so ties go to the smallest
index across tiles too, and the bytes are the same on every run. 9
launches at the pectoral select (fill) and with fill_first, 13 with fill
and an opening, plus the memset. Scratch: 8 * B + 10 * B * H * W bytes
(two int32 planes, two uint8 masks), 85 MB at 3328 x 2560.

Bound: bytes. The least the card can move is the mask in and out (2
bytes a pixel, 5 us at 3328 x 2560 over 3.35 TB/s); the kernel moves
~30-40 bytes a pixel through L2 and HBM (each CCL writes, merges,
flattens and reads a label plane), plus the union-find's dependent
accesses along each chain of tile roots.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.components import (fill_holes_plain, flood_from_plain,
                                           largest_component_plain)
from cadx_tpu_torch.ops.morphology import opening

SOURCE = "cadx_tpu_torch/csrc/largest_obj.cu"
REPLACES = "cadx_tpu/kernels/largest_obj.py:238"
SEEDED_SOURCE = "cadx_tpu_torch/csrc/seeded_component.cu"
SEEDED_REPLACES = "cadx_tpu/kernels/largest_obj.py:131"
_DENSITY_K = 17   # the plain version's density window (JAX's)


def _scratch_bytes(b: int, h: int, w: int) -> int:
    """The kernel's scratch: a uint64 key an image, two int32 planes and
    two uint8 planes (`csrc/largest_obj.cu`)."""
    return 8 * b + 10 * b * h * w


def largest_obj_reference(masks: torch.Tensor, connectivity: int = 8,
                          fill: bool = False, smooth_k: int = 0,
                          fill_first: bool = False,
                          max_iters: int = 128) -> torch.Tensor:
    """Plain version: the composed ops the JAX cleaner uses off the TPU,
    plain on any device (the public `largest_component` would launch the
    CCL, mode and flood kernels on a CUDA tensor)."""
    m = masks.to(torch.bool)
    if fill_first:
        m = fill_holes_plain(m, max_iters)
    out = largest_component_plain(m, connectivity, max_iters)
    if fill and not fill_first:
        out = fill_holes_plain(out, max_iters)
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
        scratch = torch.empty(_scratch_bytes(b, h, w), dtype=torch.uint8,
                              device=masks.device)
        rc = _build.load().cadx_largest_obj(
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
    comp = flood_from_plain(m, _density_seed(m), max_iters, connectivity)
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
        scratch = torch.empty(_scratch_bytes(b, h, w), dtype=torch.uint8,
                              device=masks.device)
        rc = _build.load().cadx_largest_component_seeded(
            masks.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, w,
            connectivity, _build.stream_ptr(masks.device))
        _build.check(rc, "cadx_largest_component_seeded")
        largest_component_seeded.launches += 1
    return out


largest_component_seeded.launches = 0
