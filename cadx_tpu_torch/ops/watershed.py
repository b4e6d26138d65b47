"""Marker watershed as a geodesic label relaxation, batched.

Port of `cadx_tpu/ops/watershed.py::marker_watershed`: each marker floods
outward along minimum-cost paths whose step cost is the intensity
difference, and the sweeps run to the exact fixpoint (bounded by
`max_iters`). Two forms, chosen as JAX chooses them: the packed int32
relaxation when the caller names up to 3 marker values and the image's
sides are <= 512 (`geodesic_scan.use_packed`), else the (distance, label)
pair form.

A CPU tensor takes the plain form (`marker_watershed_plain`); a CUDA
tensor launches the watershed kernel (`kernels/watershed.py`, imported at
the call), which runs either form to its fixpoint, or raises.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.ops import geodesic_scan as G


def marker_watershed(image: torch.Tensor, markers: torch.Tensor,
                     max_iters: int = 256, max_scan: int = 256,
                     marker_label_values: tuple = ()):
    """(B, H, W) image + markers (>0 labels, 0 unlabeled) -> (labels
    int32, boundary bool). With `marker_label_values` the image must be
    integer-valued (the equalize stage's output is)."""
    if image.device.type == "cpu":
        return marker_watershed_plain(image, markers, max_iters, max_scan,
                                      marker_label_values)
    from cadx_tpu_torch.kernels.watershed import marker_watershed as kernel

    return kernel(image, markers, max_iters, max_scan, marker_label_values)


def marker_watershed_plain(image: torch.Tensor, markers: torch.Tensor,
                           max_iters: int = 256, max_scan: int = 256,
                           marker_label_values: tuple = ()):
    """The JAX composition of the line-scan ops, on any device."""
    img = image.to(torch.float32)
    if marker_label_values and G.use_packed(image.shape[-2:],
                                            len(marker_label_values)):
        labels = G.relax_to_fixpoint_packed(
            img, markers, max_iters, max_scan, label_values=marker_label_values)
    else:
        labels = G.relax_to_fixpoint(img, markers, max_iters, max_scan)
    return labels, G.label_boundary(labels) == 1
