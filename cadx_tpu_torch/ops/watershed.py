"""Marker watershed as a geodesic label relaxation, batched.

Port of `cadx_tpu/ops/watershed.py::marker_watershed`, packed path only:
each marker floods outward along minimum-cost paths whose step cost is
the intensity difference, and the sweeps run to the exact fixpoint
(bounded by `max_iters`). The pair form, taken by JAX when the marker
values are unknown or the image is larger than 512, is not ported and
raises.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.ops import geodesic_scan as G


def marker_watershed(image: torch.Tensor, markers: torch.Tensor,
                     max_iters: int = 256, max_scan: int = 256,
                     marker_label_values: tuple = ()):
    """(B, H, W) integer-valued image + markers (>0 labels, 0 unlabeled)
    -> (labels int32, boundary bool)."""
    if not (marker_label_values
            and G.use_packed(image.shape[-2:], len(marker_label_values))):
        raise NotImplementedError(
            "only the packed watershed is ported: pass up to 3 "
            "marker_label_values on an image of side <= 512")
    labels = G.relax_to_fixpoint_packed(
        image.to(torch.float32), markers, max_iters, max_scan,
        label_values=marker_label_values)
    return labels, G.label_boundary(labels) == 1
