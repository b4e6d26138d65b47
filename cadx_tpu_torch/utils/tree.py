"""Per-tensor gradient-norm clipping.

Port of `cadx_tpu/utils/tree.py::clip_tensor_by_norm` and
`clip_grads_per_leaf`: the reference (Classes/CNNModel.py:217-222) clips
each gradient array by its own L2 norm, max_norm 5.0, with a 1e-6 fudge
in the denominator. The norm is taken in float32 and the scale stays on
the device, so clipping never waits for the host.
"""

from __future__ import annotations

import torch


def clip_tensor_by_norm(g: torch.Tensor, max_norm: float = 5.0) -> torch.Tensor:
    """g * (max_norm / (norm + 1e-6)) iff norm > max_norm, else g."""
    norm = torch.linalg.vector_norm(g.to(torch.float32))
    # a tensor numerator: `scalar / tensor` is a reciprocal and a product
    limit = torch.full((), max_norm, device=g.device)
    scale = torch.where(norm > max_norm, limit / (norm + 1e-6),
                        torch.ones((), device=g.device))
    return (g * scale).to(g.dtype)


def clip_grads_per_leaf(grads, max_norm: float = 5.0) -> list[torch.Tensor]:
    """Clip every tensor of `grads` by its own norm."""
    return [clip_tensor_by_norm(g, max_norm) for g in grads]
