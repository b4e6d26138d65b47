"""Max pooling, forward only.

Port of the forward of `cadx_tpu/ops/pool.py::max_pool_ties`: a
non-overlapping window max that drops trailing odd rows and columns. The
reference's tie-broadcast gradient is a training concern and is not
ported yet; nothing on the serving path differentiates through a pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_ties(x: torch.Tensor, size: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H // size, W // size) window max."""
    return F.max_pool2d(x, size, stride=size)
