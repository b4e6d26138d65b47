"""The reference "basic" CNN classifier.

Port of `cadx_tpu/models/cnn.py`: [conv + bias + LeakyReLU, 2x2 max pool]
blocks, a row-major (H, W, C) flatten, dense + LeakyReLU (+ inverted
dropout in training) layers and the guarded softmax, with the training
loss and its gradients. Conv weights are He-normal (O, I, kh, kw); dense
weights are Xavier-uniform and kept (in, out) as in JAX. The public
functions take and return channel-last activations, as JAX does; the
conv blocks run channel-first inside, through the conv_leaky and pool
kernels (`ops.conv.conv2d_leaky`, `ops.pool.max_pool_ties`, whose
backward is the reference's tie-broadcast). `compute_dtype=torch.bfloat16`
is JAX's opt-in mixed precision: the conv stack in bfloat16 (the bf16 form
of the conv kernel), parameters and the head in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from cadx_tpu_torch.ops.conv import conv2d_leaky, leaky_relu
from cadx_tpu_torch.ops.pool import max_pool_ties


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Architecture and dropout; JSON round-trips to the reference npz
    schema."""

    input_shape: tuple[int, int, int]  # (H, W, C)
    num_classes: int
    conv_layers: tuple[tuple[int, int], ...] = ((8, 3), (16, 3))  # (filters, k)
    hidden_units: tuple[int, ...] = (128, 64)
    dropout_rate: float = 0.3
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

    def to_json_dict(self) -> dict[str, Any]:
        """The reference save_model config keys, in its order, plus
        leaky_alpha; conv_padding only for SAME models, so a VALID model
        keeps the reference's exact key set."""
        out = {
            "input_shape": list(self.input_shape),
            "num_classes": self.num_classes,
            "conv_layers": [list(cl) for cl in self.conv_layers],
            "hidden_units": list(self.hidden_units),
            "dropout_rate": self.dropout_rate,
            "leaky_alpha": self.leaky_alpha,
        }
        if self.conv_padding != "VALID":
            out["conv_padding"] = self.conv_padding
        return out

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "CNNConfig":
        return cls(
            input_shape=tuple(d["input_shape"]),
            num_classes=int(d["num_classes"]),
            conv_layers=tuple(tuple(cl) for cl in d["conv_layers"]),
            hidden_units=tuple(d["hidden_units"]),
            dropout_rate=float(d["dropout_rate"]),
            leaky_alpha=float(d.get("leaky_alpha", 0.01)),
            conv_padding=d.get("conv_padding", "VALID"),
        )

    def conv_output_shapes(self) -> list[tuple[int, int, int]]:
        """Post-conv (pre-pool) (h, w, filters) of each block."""
        h, w, _ = self.input_shape
        shapes = []
        for f, k in self.conv_layers:
            if self.conv_padding == "VALID":
                h, w = h - k + 1, w - k + 1
            shapes.append((h, w, f))
            h, w = h // 2, w // 2
        return shapes

    def flatten_size(self) -> int:
        h, w, c = self.input_shape
        for f, k in self.conv_layers:
            if self.conv_padding == "VALID":
                h, w = h - k + 1, w - k + 1
            h, w, c = h // 2, w // 2, f
        return h * w * c

    def layer_indices(self) -> dict[str, Any]:
        """The reference's `self.layers` indices (conv, pool pairs, then
        dense, then output), which name its npz keys W{i}/b{i}."""
        conv = [2 * i for i in range(len(self.conv_layers))]
        first_dense = 2 * len(self.conv_layers)
        dense = [first_dense + i for i in range(len(self.hidden_units))]
        return {"conv": conv, "dense": dense,
                "output": first_dense + len(self.hidden_units)}


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


def conv_stack(model: CNN, x: torch.Tensor, *,
               compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, F) activations after the conv+pool blocks.

    compute_dtype (torch.bfloat16): JAX's opt-in mixed precision. x and
    each conv kernel are cast to it (the only casts: the convs return it,
    and LeakyReLU and the pool keep it), each conv's sum is rounded to it,
    plus the float32 bias, rounded again; the activations stay in it."""
    cfg = model.config
    out = x.permute(0, 3, 1, 2)
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    for w, b in zip(model.conv_w, model.conv_b):
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        out = max_pool_ties(conv2d_leaky(out, w, b, cfg.leaky_alpha,
                                         cfg.conv_padding), 2)
    return out.permute(0, 2, 3, 1)


def head_logits(model: CNN, feats: torch.Tensor, *, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Row-major (h, w, F) flatten, dense + LeakyReLU chain, output logits.
    In training, with dropout_rate > 0 and a generator, each hidden
    activation keeps where uniform > rate, scaled by 1 / (1 - rate); the
    uniforms are drawn from `generator` on the activations' device."""
    alpha, rate = model.config.leaky_alpha, model.config.dropout_rate
    drop = training and rate > 0.0 and generator is not None
    out = feats.reshape(feats.shape[0], -1)
    for w, b in zip(model.dense_w, model.dense_b):
        out = leaky_relu(out @ w + b, alpha)
        if drop:
            keep = torch.rand(out.shape, generator=generator, device=out.device) > rate
            out = out * keep.to(out.dtype) / (1.0 - rate)
    return out @ model.out_w + model.out_b


def apply(model: CNN, x: torch.Tensor, training: bool = False,
          generator: torch.Generator | None = None, *,
          compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Batched forward -> logits (B, num_classes); x (B, H, W, C) float32.
    compute_dtype: see conv_stack (the conv stack in bf16, the head in
    float32)."""
    feats = conv_stack(model, x, compute_dtype=compute_dtype)
    if compute_dtype is not None:
        feats = feats.to(torch.float32)
    return head_logits(model, feats, training=training, generator=generator)


def forward(model: CNN, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> class probabilities (B, num_classes)."""
    return reference_softmax(apply(model, x))


def predict(model: CNN, x: torch.Tensor):
    """(argmax class, probs) per sample."""
    probs = forward(model, x)
    return probs.argmax(dim=-1), probs


def cross_entropy(probs: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Reference loss (Classes/CNNModel.py:360-367): probs clipped to
    [1e-12, 1], then the NLL; a scalar sum for one sample, the batch mean
    otherwise."""
    per_sample = -(y_onehot * torch.log(torch.clamp(probs, 1e-12, 1.0))).sum(dim=-1)
    return per_sample if probs.ndim == 1 else per_sample.mean()


def loss_fn(model: CNN, x: torch.Tensor, y_onehot: torch.Tensor, *,
            training: bool = False,
            generator: torch.Generator | None = None,
            compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits, whose gradient is exactly
    (probs - y) / B, the reference's backward seed."""
    logp = torch.log_softmax(apply(model, x, training, generator,
                                   compute_dtype=compute_dtype), dim=-1)
    return -(y_onehot * logp).sum(dim=-1).mean()


def grads_fn(model: CNN, x: torch.Tensor, y_onehot: torch.Tensor, *,
             training: bool = False, generator: torch.Generator | None = None,
             compute_dtype: torch.dtype | None = None):
    """(loss, grads): grads of the batch-averaged loss, unclipped, one per
    tensor of `model.parameters()`."""
    with torch.enable_grad():
        loss = loss_fn(model, x, y_onehot, training=training, generator=generator,
                       compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), list(grads)


def num_params(model: CNN) -> int:
    return sum(p.numel() for p in model.parameters())
