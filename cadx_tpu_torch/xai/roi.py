"""Region of interest from a Grad-CAM map, batched.

Port of `cadx_tpu/xai/roi.py`: the bounding box of the largest
8-connected region at or above `threshold` times the map's max, in
normalised [0, 1] viewer coordinates. The region goes through
`ops.components.largest_component`, so on a CUDA tensor it runs the CCL
and largest-component-mask kernels, as the JAX op runs their Pallas
kernels; a failure there raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cadx_tpu_torch.ops.components import largest_component


def roi_from_cam(cam: torch.Tensor, threshold: float = 0.6) -> torch.Tensor:
    """(B, h, w) maps -> (B, 4) float32 (top, left, height, width). The
    box is never empty: the argmax pixel is always hot."""
    b, h, w = cam.shape
    hot = cam >= threshold * cam.amax(dim=(1, 2), keepdim=True)
    region = largest_component(hot, connectivity=8)
    rows = region.any(dim=2).to(torch.int32)
    cols = region.any(dim=1).to(torch.int32)
    y0 = rows.argmax(dim=1)
    y1 = h - rows.flip(1).argmax(dim=1)
    x0 = cols.argmax(dim=1)
    x1 = w - cols.flip(1).argmax(dim=1)
    # the JAX division by the static side compiles to a product with its
    # float32 reciprocal, which can differ from the quotient by an ulp
    inv_h = float(np.float32(1.0) / np.float32(h))
    inv_w = float(np.float32(1.0) / np.float32(w))
    f32 = torch.float32
    return torch.stack([y0.to(f32) * inv_h, x0.to(f32) * inv_w,
                        (y1 - y0).to(f32) * inv_h, (x1 - x0).to(f32) * inv_w], dim=1)


def roi_dict_from_vals(vals) -> dict:
    """(top, left, height, width) -> the web app's roiCoords payload."""
    top, left, height, width = (float(v) for v in vals)
    return {"top": round(top, 4), "left": round(left, 4),
            "width": round(width, 4), "height": round(height, 4)}


def roi_coords_dict(cam: torch.Tensor) -> dict:
    """One (h, w) map -> roiCoords, with one host fetch."""
    return roi_dict_from_vals(roi_from_cam(cam[None]).cpu()[0].tolist())
