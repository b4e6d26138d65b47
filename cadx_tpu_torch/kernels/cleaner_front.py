"""The cleaner's front, artifact suppression then breast segmentation, in
one launch — CUDA kernel and its plain PyTorch version.

Replaces `cadx_tpu/kernels/cleaner_front.py::cleaner_front_pallas` (its
`pl.pallas_call` at :122). Source: `csrc/cleaner_front.cu`, with the
shared device code in `csrc/components.cuh`. On a raw uint8 batch:

- stage 1 (`suppress_artifacts(raw, low_frac, smooth_k)`): threshold at
  table[max], the largest 8-connected component, its holes filled, an
  opening with a smooth_k x smooth_k square; the image ANDed with it;
- stage 2 (`segment_breast(suppressed, low_frac)`): the 8-bit
  rescale of `to_uint8`, threshold at table[max], holes filled, the
  largest 8-connected component.

The thresholds come from `ops.threshold._trunc_table`, the float64
int(max * frac) the plain path uses, passed to the kernel as 256 int32
values indexed at the image's max (a constant table for low_frac >= 1).
Outputs: the stage-2-masked suppressed image (uint8; JAX's kernel gives
the same values as int32), the stage-1 mask and the stage-2 mask (bool),
from which the caller takes the bounding rect.

Unlike JAX's kernel, any H and W: the union-find labels are int pixel
indices, not 30 packed bits, so the serving and training CLI's native
shapes run it too. The JAX package keeps its kernel off the TPU's path,
where XLA overlapped the glue of two smaller programs; on the card the
glue is ~10 separate launches a call, so `clean_boundary_gray` runs this
kernel.

Layout: one block of 1024 threads per image over a scratch of 5 int32
planes in global memory, the phases of `csrc/largest_obj.cu` chained
(two CCLs, two hole fills, one opening). Bound: the latency of the
union-find's dependent L2 accesses and the opening's k-wide window
passes; one block per image leaves SMs idle below 132 images.
"""

from __future__ import annotations

import functools

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.threshold import _trunc_table

SOURCE = "cadx_tpu_torch/csrc/cleaner_front.cu"
REPLACES = "cadx_tpu/kernels/cleaner_front.py:122"
_SCRATCH_PLANES = 5


def cleaner_front_reference(raw_u8: torch.Tensor, smooth_k: int = 15,
                            low_frac: float = 0.05, max_iters: int = 128):
    """Plain version: the cleaner's own `suppress_artifacts` and
    `segment_breast`, through `largest_obj`'s plain version with JAX's
    sweep caps on any device. Returns (img_breast_only uint8, breast_mask
    bool, contour_fill bool)."""
    # imported here: the cleaner imports this module
    from cadx_tpu_torch.preprocess import cleaner

    suppressed, mask1 = cleaner.suppress_artifacts(raw_u8, low_frac, smooth_k, max_iters)
    breast_only, contour = cleaner.segment_breast(suppressed, low_frac, max_iters)
    return breast_only, mask1 != 0, contour


@functools.lru_cache(maxsize=64)
def _threshold_table(low_frac: float, device: torch.device) -> torch.Tensor:
    """The 256 thresholds `relative_threshold_value` gives a uint8 image
    at each max, on `device`."""
    if low_frac >= 1.0:
        values = [int(low_frac)] * 256
    else:
        values = _trunc_table(float(low_frac), 256)
    return torch.as_tensor(values, dtype=torch.int32).to(device)


def cleaner_front(raw_u8: torch.Tensor, smooth_k: int = 15, low_frac: float = 0.05):
    """(B, H, W) uint8 -> (img_breast_only uint8, breast_mask bool,
    contour_fill bool), each (B, H, W). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if raw_u8.device.type == "cpu":
        return cleaner_front_reference(raw_u8, smooth_k, low_frac)
    _build.check_input(raw_u8, torch.uint8, "cleaner_front")
    if smooth_k < 0:
        raise ValueError(f"smooth_k must be >= 0, got {smooth_k}")
    b, h, w = raw_u8.shape
    breast_only = torch.empty_like(raw_u8)
    mask1 = torch.empty(raw_u8.shape, dtype=torch.bool, device=raw_u8.device)
    contour = torch.empty_like(mask1)
    if b:
        table = _threshold_table(float(low_frac), raw_u8.device)
        scratch = torch.empty((b, _SCRATCH_PLANES, h, w), dtype=torch.int32,
                              device=raw_u8.device)
        rc = _build.load().cadx_cleaner_front(
            raw_u8.data_ptr(), table.data_ptr(), breast_only.data_ptr(),
            mask1.data_ptr(), contour.data_ptr(), scratch.data_ptr(), b, h, w,
            int(smooth_k), _build.stream_ptr(raw_u8.device))
        _build.check(rc, "cadx_cleaner_front")
        cleaner_front.launches += 1
    return breast_only, mask1, contour


cleaner_front.launches = 0
