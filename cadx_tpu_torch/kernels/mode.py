"""Mask of the largest labelled component — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/mode.py::largest_component_mask_pallas` (its
`pl.pallas_call` at :344), which finds the most frequent foreground label
with a bitonic sort and run lengths. Source: `csrc/mode.cu`, with the
area/argmax code of `csrc/components.cuh`. The result is mask & (labels ==
L), L the label with the largest area, the smallest label on ties; all
false for an empty mask. Labels are component raster indices in
[0, H*W), as `label_components` gives them; a foreground label outside
that range is not counted. Any H and W: the sort network's power-of-two
sides do not apply to a histogram.

Layout: one block of 1024 threads per image. Areas are atomicAdd counts
into an H*W int32 plane indexed by label, in global memory; the argmax is
a 64-bit (area << 32 | ~label) key reduced with one shared atomicMax.
Bound: the atomics of the area histogram, which collide on the few labels
of a blob mask, and one pass over the image for the output. One block per
image uses one SM.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.components import largest_from_labels

SOURCE = "cadx_tpu_torch/csrc/mode.cu"
REPLACES = "cadx_tpu/kernels/mode.py:344"
_SCRATCH_PLANES = 3


def largest_component_mask_reference(labels: torch.Tensor,
                                     mask: torch.Tensor) -> torch.Tensor:
    """Plain version: a scatter-add histogram and its first argmax."""
    return largest_from_labels(labels, mask.to(torch.bool))


def largest_component_mask(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 labels + bool mask -> (B, H, W) bool. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if labels.device.type == "cpu":
        return largest_component_mask_reference(labels, mask)
    _build.check_input(labels, torch.int32, "largest_component_mask labels")
    _build.check_input(mask, torch.bool, "largest_component_mask mask")
    if mask.shape != labels.shape:
        raise ValueError(f"largest_component_mask: mask {tuple(mask.shape)} "
                         f"and labels {tuple(labels.shape)} differ")
    b, h, w = labels.shape
    out = torch.empty_like(mask)
    if b:
        scratch = torch.empty((b, _SCRATCH_PLANES, h, w), dtype=torch.int32,
                              device=labels.device)
        rc = _build.load().cadx_largest_component_mask(
            labels.data_ptr(), mask.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, h, w, _build.stream_ptr(labels.device))
        _build.check(rc, "cadx_largest_component_mask")
        largest_component_mask.launches += 1
    return out


largest_component_mask.launches = 0
