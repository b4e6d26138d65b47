"""The reference "basic" CNN classifier.

Port of `cadx_tpu/models/cnn.py` (inference): [conv + bias + LeakyReLU,
2x2 max pool] blocks, a row-major (H, W, C) flatten, dense + LeakyReLU
layers and the guarded softmax. Conv weights are He-normal (O, I, kh, kw);
dense weights are Xavier-uniform and kept (in, out) as in JAX. The public
functions take and return channel-last activations, as JAX does; the
convolutions run channel-first inside.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from cadx_tpu_torch.ops.conv import conv2d, leaky_relu
from cadx_tpu_torch.ops.pool import max_pool_ties


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Architecture. The JAX config's dropout_rate is a training setting
    and has no counterpart here yet."""

    input_shape: tuple[int, int, int]  # (H, W, C)
    num_classes: int
    conv_layers: tuple[tuple[int, int], ...] = ((8, 3), (16, 3))  # (filters, k)
    hidden_units: tuple[int, ...] = (128, 64)
    leaky_alpha: float = 0.01
    conv_padding: str = "VALID"

    def __post_init__(self):
        if self.conv_padding not in ("VALID", "SAME"):
            raise ValueError(f"conv_padding must be 'VALID' or 'SAME', got "
                             f"{self.conv_padding!r}")
        h, w, _ = self.input_shape
        for i, (f, k) in enumerate(self.conv_layers):
            if self.conv_padding == "VALID":
                h, w = h - k + 1, w - k + 1
            h, w = h // 2, w // 2
            if h < 1 or w < 1:
                raise ValueError(
                    f"conv layer {i} ({f} filters, k={k}) and its pool reduce "
                    f"the input {self.input_shape} below 1x1")

    def flatten_size(self) -> int:
        h, w, c = self.input_shape
        for f, k in self.conv_layers:
            if self.conv_padding == "VALID":
                h, w = h - k + 1, w - k + 1
            h, w, c = h // 2, w // 2, f
        return h * w * c


class CNN(nn.Module):
    """Parameters of the classifier; `config` fixes the architecture."""

    def __init__(self, config: CNNConfig, conv: list, dense: list, output):
        super().__init__()
        self.config = config
        self.conv_w = nn.ParameterList([nn.Parameter(w) for w, _ in conv])
        self.conv_b = nn.ParameterList([nn.Parameter(b) for _, b in conv])
        self.dense_w = nn.ParameterList([nn.Parameter(w) for w, _ in dense])
        self.dense_b = nn.ParameterList([nn.Parameter(b) for _, b in dense])
        self.out_w = nn.Parameter(output[0])
        self.out_b = nn.Parameter(output[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self, x)


def init_params(generator: torch.Generator, config: CNNConfig,
                device=None) -> CNN:
    """He-normal convs, Xavier-uniform dense, zero biases, drawn on the
    CPU from `generator` (so a seed gives the same weights on any device)."""
    def uniform(shape, limit):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit

    conv, dense = [], []
    c_in = config.input_shape[2]
    for f, k in config.conv_layers:
        std = math.sqrt(2.0 / (k * k * c_in))
        conv.append((torch.randn((f, c_in, k, k), generator=generator) * std,
                     torch.zeros(f)))
        c_in = f
    prev = config.flatten_size()
    for units in config.hidden_units:
        dense.append((uniform((prev, units), math.sqrt(6.0 / (prev + units))),
                      torch.zeros(units)))
        prev = units
    limit = math.sqrt(6.0 / (prev + config.num_classes))
    output = (uniform((prev, config.num_classes), limit),
              torch.zeros(config.num_classes))
    return CNN(config, conv, dense, output).to(device)


def reference_softmax(z: torch.Tensor) -> torch.Tensor:
    """Logits clipped to [-50, 50], max-subtracted, 1e-12 added to the
    denominator, uniform where the sum is 0."""
    z = torch.clamp(z, -50.0, 50.0)
    z = z - z.amax(dim=-1, keepdim=True)
    exps = torch.exp(z)
    s = exps.sum(dim=-1, keepdim=True)
    uniform = torch.ones_like(z) / z.shape[-1]
    return torch.where(s == 0, uniform, exps / (s + 1e-12))


def conv_stack(model: CNN, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, F) activations after the conv+pool blocks."""
    cfg = model.config
    out = x.permute(0, 3, 1, 2)
    for w, b in zip(model.conv_w, model.conv_b):
        out = max_pool_ties(leaky_relu(conv2d(out, w, b, padding=cfg.conv_padding),
                                       cfg.leaky_alpha), 2)
    return out.permute(0, 2, 3, 1)


def head_logits(model: CNN, feats: torch.Tensor) -> torch.Tensor:
    """Row-major (h, w, F) flatten, dense + LeakyReLU chain, output logits."""
    alpha = model.config.leaky_alpha
    out = feats.reshape(feats.shape[0], -1)
    for w, b in zip(model.dense_w, model.dense_b):
        out = leaky_relu(out @ w + b, alpha)
    return out @ model.out_w + model.out_b


def forward(model: CNN, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> class probabilities (B, num_classes)."""
    return reference_softmax(head_logits(model, conv_stack(model, x)))


def predict(model: CNN, x: torch.Tensor):
    """(argmax class, probs) per sample."""
    probs = forward(model, x)
    return probs.argmax(dim=-1), probs
