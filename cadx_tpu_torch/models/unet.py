"""The resnet encoder's first convolution, the slice's feature extractor.

Port of `cadx_tpu/models/unet.py::encoder_first_features`: conv1, 7x7,
stride 2, pad 3, no bias, 1 -> 64 channels. Only conv1 runs on the
ported slice; the rest of a converted encoder is carried untouched in
`ResNetStem.rest`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class ResNetStem(nn.Module):
    """conv1 of the resnet encoder, weight (64, in_channels, 7, 7)."""

    def __init__(self, weight: torch.Tensor, rest: dict | None = None):
        super().__init__()
        self.conv1 = nn.Parameter(weight)
        self.rest = rest or {}

    def forward(self, img_nhwc: torch.Tensor) -> torch.Tensor:
        x = img_nhwc.permute(0, 3, 1, 2)
        return F.conv2d(x, self.conv1, stride=2, padding=3).permute(0, 2, 3, 1)


def init_resnet_stem(generator: torch.Generator, in_channels: int = 1,
                     device=None) -> ResNetStem:
    """He-normal conv1, drawn on the CPU from `generator`."""
    std = math.sqrt(2.0 / (7 * 7 * in_channels))
    w = torch.randn((64, in_channels, 7, 7), generator=generator) * std
    return ResNetStem(w.to(device))


def encoder_first_features(stem: ResNetStem, img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) in [0, 1] -> (B, H/2, W/2, 64) raw conv1 features,
    returned as a channel-last view of the channel-first result."""
    return stem(img)
