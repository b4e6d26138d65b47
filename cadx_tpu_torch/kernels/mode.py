"""Mask of the largest labelled component — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/mode.py::largest_component_mask_pallas` (its
`pl.pallas_call` at :344), which finds the most frequent foreground label
with a bitonic sort and run lengths. Source: `csrc/mode.cu`. The result is
mask & (labels == L), L the label with the largest area, the smallest
label on ties; all false for an empty mask. Labels are component raster
indices in [0, H*W), as `label_components` gives them; a foreground label
outside that range is not counted and never chosen. Any H and W: the sort
network's power-of-two sides do not apply to a histogram.

Layout (redesigned for Hopper), in three forms that `form_for` chooses by
shape. All take the argmax from the area adds themselves: an atomic add
returns the area before it, so the last add to a label knows its final
area, and the largest (area << 32 | ~label) key over all adds is the
answer, with no pass over the areas; the lanes of a warp that hold one
label add once together. The cluster form, for planes of at most 64 x 64
(the serving path's CAM labels, B=3 62x62): one launch, a thread block
cluster of CLUSTER_BLOCKS blocks an image; each block owns a range of
labels as a histogram in its shared memory and the pixels of the same
range, adds a pixel whose label another block owns through the cluster's
distributed shared memory, and writes its pixels of the output from the
registers it read them into: the inputs are read once, with no scratch,
memset or allocation. The block form, up to ONE_BLOCK_PIXELS (B=1 6x6):
the same kernel at one block an image in a plain launch, where a
cluster's barriers cost more than its split saves. The wide form, for
larger planes: a memset of the (B,) 64-bit keys and one (B, H, W) int32
area plane, then two launches over chunks x images: the adds, with one
64-bit atomicMax a block to the image's key, then the output. It
replaced a kernel of one block an image (three int32 scratch planes, six
dependent passes over them, on one SM an image; PERF.md section 6 row 5).

Bound: bytes, the labels (4 a pixel) and the mask (1) read once and the
output (1) written once; at the CAM shapes a launch's fixed cost is all
there is.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.components import largest_from_labels

SOURCE = "cadx_tpu_torch/csrc/mode.cu"
REPLACES = "cadx_tpu/kernels/mode.py:344"

CLUSTER_SIDE = 64        # the block and cluster forms' largest side (csrc/mode.cu)
ONE_BLOCK_PIXELS = 1024  # the block form's largest plane
CLUSTER_BLOCKS = 8       # blocks a cluster (csrc/mode.cu)
FORM_CODES = {"wide": 0, "block": 1, "cluster": 2}


def largest_component_mask_reference(labels: torch.Tensor,
                                     mask: torch.Tensor) -> torch.Tensor:
    """Plain version: a scatter-add histogram of the foreground labels in
    [0, H*W) and its first argmax."""
    n = labels.shape[1] * labels.shape[2]
    counted = mask.to(torch.bool) & (labels >= 0) & (labels < n)
    return largest_from_labels(labels, counted)


def form_for(h: int, w: int) -> str:
    """The form `largest_component_mask` launches at (h, w): "block" up to
    ONE_BLOCK_PIXELS, "cluster" where both sides are at most CLUSTER_SIDE,
    else "wide" (the C entry point's rule: the wrapper allocates the wide
    form's scratch, and the block and cluster forms refuse larger
    planes)."""
    if h > CLUSTER_SIDE or w > CLUSTER_SIDE:
        return "wide"
    return "block" if h * w <= ONE_BLOCK_PIXELS else "cluster"


def largest_component_mask(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 labels + bool mask -> (B, H, W) bool. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if labels.device.type == "cpu":
        return largest_component_mask_reference(labels, mask)
    _build.check_input(labels, torch.int32, "largest_component_mask labels")
    _build.check_input(mask, torch.bool, "largest_component_mask mask")
    if mask.shape != labels.shape or mask.device != labels.device:
        raise ValueError(f"largest_component_mask: mask {tuple(mask.shape)} on {mask.device} "
                         f"and labels {tuple(labels.shape)} on {labels.device} differ")
    b, h, w = labels.shape
    out = torch.empty_like(mask)
    if out.numel():
        form = form_for(h, w)
        # the wide form's scratch: b 64-bit keys, then the (b, h, w) areas
        scratch = (torch.empty(2 * b + b * h * w, dtype=torch.int32, device=labels.device)
                   if form == "wide" else None)
        rc = _build.load().cadx_largest_component_mask(
            labels.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, h, w, FORM_CODES[form],
            _build.stream_ptr(labels.device))
        _build.check(rc, "cadx_largest_component_mask")
        largest_component_mask.launches += 1
    return out


largest_component_mask.launches = 0
