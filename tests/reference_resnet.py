"""Plain PyTorch reference of a ResNet classifier's training step, for the
CPU tests.

He, Zhang, Ren and Sun (2016, arXiv:1512.03385, Table 1), with
torchvision's stride placement ("V1.5": a bottleneck's stride on its
3x3, not its first 1x1): a 7x7/2 conv (pad 3) to 64 channels, batch norm,
ReLU, a 3x3/2 max pool (pad 1); stages of bottlenecks (1x1 reduce, 3x3
with the stride, 1x1 expand x4), each conv followed by a batch norm, ReLU
after all but the last, a 1x1 projection with its batch norm where the
shape changes, ReLU after the residual add; the global average pool and
the fc. Departures, as the port runs it: the
convs have no bias (torchvision's layout); the input channels and the
classes are the configuration's.

Batch norm in training mode is written out: each channel's mean and biased
variance over (B, H, W) (two passes), (x - mean) / sqrt(var + eps) *
weight + bias, the running mean and the running unbiased variance updated
with the momentum; autograd differentiates through the statistics. The
loss is the batch mean of -log softmax(logits)[y]; `adam` is one Adam
update in optax's order. Parameters and running statistics are dicts keyed
by the port's names. Imports nothing of the port or of JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.1


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor) -> torch.Tensor:
    """Training batch norm of x (B, C, H, W); the running statistics are
    updated in place."""
    shape = (1, -1, 1, 1)
    n = x.numel() // x.shape[1]
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean.view(shape)) ** 2).mean(dim=(0, 2, 3))
    with torch.no_grad():
        running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
        running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * var * n / (n - 1))
    return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS) * weight.view(shape) \
        + bias.view(shape)


def batch_norm_eval(x, weight, bias, running_mean, running_var) -> torch.Tensor:
    shape = (1, -1, 1, 1)
    return (x - running_mean.view(shape)) / torch.sqrt(running_var.view(shape) + EPS) \
        * weight.view(shape) + bias.view(shape)


def _bn(params, stats, name, x, training):
    w, b = params[name + ".weight"], params[name + ".bias"]
    rm, rv = stats[name + ".running_mean"], stats[name + ".running_var"]
    return batch_norm_train(x, w, b, rm, rv) if training else batch_norm_eval(x, w, b, rm, rv)


def _block(params, stats, prefix, x, stride, training):
    def conv(name, xin, s, pad):
        return F.conv2d(xin, params[f"{prefix}.{name}.weight"], stride=s, padding=pad)

    def bn(name, xin):
        return _bn(params, stats, f"{prefix}.{name}", xin, training)

    out = torch.relu(bn("bn1", conv("conv1", x, 1, 0)))
    out = torch.relu(bn("bn2", conv("conv2", out, stride, 1)))
    out = bn("bn3", conv("conv3", out, 1, 0))
    identity = x
    if f"{prefix}.downsample.0.weight" in params:
        identity = bn("downsample.1", conv("downsample.0", x, stride, 0))
    return torch.relu(out + identity)


def logits(params: dict, stats: dict, x: torch.Tensor, layers,
           training: bool = True) -> torch.Tensor:
    """x (B, C, H, W) -> (B, classes): the training forward (batch
    statistics, running statistics updated) or, with training=False, the
    inference forward (running statistics)."""
    x = F.conv2d(x, params["conv1.weight"], stride=2, padding=3)
    x = torch.relu(_bn(params, stats, "bn1", x, training))
    x = F.max_pool2d(x, 3, 2, 1)
    for si, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            x = _block(params, stats, f"layer{si + 1}.{bi}", x, stride, training)
    return x.mean(dim=(2, 3)) @ params["fc.weight"].T + params["fc.bias"]


def cross_entropy(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(z, dim=-1)[torch.arange(len(y)), y].mean()


def adam(params: dict, grads: dict, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> dict:
    """The parameters after Adam's first step from zero moments."""
    c1 = float(np.float32(1) - np.float32(b1))
    c2 = float(np.float32(1) - np.float32(b2))
    out = {}
    for k, p in params.items():
        g = grads[k]
        m_hat = (1 - b1) * g / c1
        v_hat = (1 - b2) * g * g / c2
        out[k] = p - lr * (m_hat / (torch.sqrt(v_hat) + eps))
    return out
