"""Grad-CAM core on the split classifier.

Port of `cadx_tpu/xai/gradcam.py::cam_from_acts_grads` and its
`conv_features` / `head_logits` aliases: the CAM explains the same
network that `models.cnn.predict` runs.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.models import cnn

conv_features = cnn.conv_stack
head_logits = cnn.head_logits


def cam_from_acts_grads(acts: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """weights = GAP(grads), cam = relu(sum_k w_k A_k), min-max per sample
    to [0, 1] (+1e-7 guard). (B, h, w, F) -> (B, h, w)."""
    weights = grads.mean(dim=(1, 2), keepdim=True)
    cam = torch.relu((weights * acts).sum(dim=-1))
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / (hi - lo + 1e-7)
