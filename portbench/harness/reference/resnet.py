"""Plain PyTorch reference of a ResNet classifier's training step.

The network of the port's test reference (`tests/reference_resnet.py`),
with torch's own batch norm in place of its written-out one: He, Zhang,
Ren and Sun (2016, arXiv:1512.03385, Table 1), with
torchvision's stride placement ("V1.5": a bottleneck's stride on its 3x3):
a 7x7/2 conv (pad 3) to 64 channels, batch norm, ReLU, a 3x3/2 max pool
(pad 1); stages of bottlenecks (1x1 reduce, 3x3 with the stride, 1x1
expand x4), each conv followed by a batch norm, ReLU after all but the last, a 1x1 projection with its batch norm where
the shape changes, ReLU after the residual add; the global average pool
and the fc. The convs have no bias (torchvision's layout). Batch norm in
training mode is torch's own `F.batch_norm(training=True)`, at the
momentum and eps of the configuration's `batch_norm`: the batch's mean and
biased variance, the running mean and unbiased variance updated in place. The loss is the batch mean of -log
softmax(logits)[y].

Parameters are plain tensors in a dict keyed by the port's parameter names
(`param_shapes`), in the port's order; the running statistics a dict of
`<batch norm>.running_mean` / `.running_var`. `Precision` (`model.py`)
fixes the arithmetic of every conv and of the fc: float32 with TF32 off,
or the TF32 control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import FP32, Precision


def _blocks(cfg: dict):
    """(prefix, cin, width, cout, stride, projection) of every block."""
    out, cin = [], 64
    for si, (n_blocks, width) in enumerate(zip(cfg["layers"], cfg["widths"])):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            cout = 4 * width
            out.append((f"layer{si + 1}.{bi}", cin, width, cout, stride,
                        stride != 1 or cin != cout))
            cin = cout
    return out


def param_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, in the port's `named_parameters`
    order: conv1, bn1, each block's conv1, bn1, conv2, bn2, conv3, bn3,
    downsample.0, downsample.1, then fc."""
    out = [("conv1.weight", (64, cfg["in_channels"], 7, 7)),
           ("bn1.weight", (64,)), ("bn1.bias", (64,))]

    def conv_bn(conv, bn, cout, cin, k):
        out.extend([(f"{conv}.weight", (cout, cin, k, k)), (f"{bn}.weight", (cout,)),
                    (f"{bn}.bias", (cout,))])

    for prefix, cin, width, cout, _, proj in _blocks(cfg):
        conv_bn(f"{prefix}.conv1", f"{prefix}.bn1", width, cin, 1)
        conv_bn(f"{prefix}.conv2", f"{prefix}.bn2", width, width, 3)
        conv_bn(f"{prefix}.conv3", f"{prefix}.bn3", cout, width, 1)
        if proj:
            conv_bn(f"{prefix}.downsample.0", f"{prefix}.downsample.1", cout, cin, 1)
    c = _blocks(cfg)[-1][3]
    return out + [("fc.weight", (cfg["num_classes"], c)), ("fc.bias", (cfg["num_classes"],))]


def batch_norms(cfg: dict) -> list[str]:
    """The batch norms' names, in the network's order."""
    return [n[:-len(".weight")] for n, s in param_shapes(cfg)
            if n.endswith(".weight") and len(s) == 1]


def init_stats(cfg: dict, device) -> dict:
    """Running statistics as BatchNorm2d starts them: mean 0, variance 1."""
    out = {}
    for name, (c,) in ((n[:-len(".weight")], s) for n, s in param_shapes(cfg)
                       if n.endswith(".weight") and len(s) == 1):
        out[name + ".running_mean"] = torch.zeros(c, device=device)
        out[name + ".running_var"] = torch.ones(c, device=device)
    return out


def _conv(params, name, x, stride, pad, p: Precision):
    return F.conv2d(p.rnd(x), p.rnd(params[name + ".weight"]), stride=stride, padding=pad)


def _bn(params, stats, cfg, name, x):
    return F.batch_norm(x, stats[name + ".running_mean"], stats[name + ".running_var"],
                        params[name + ".weight"], params[name + ".bias"], training=True,
                        momentum=cfg["batch_norm"]["momentum"], eps=cfg["batch_norm"]["eps"])


def logits(params: dict, stats: dict, cfg: dict, x: torch.Tensor,
           p: Precision = FP32) -> torch.Tensor:
    """x (B, C, H, W) -> (B, classes), the training forward; `stats` are
    updated in place."""
    x = torch.relu(_bn(params, stats, cfg, "bn1", _conv(params, "conv1", x, 2, 3, p)))
    x = F.max_pool2d(x, 3, 2, 1)
    for prefix, _, _, _, stride, proj in _blocks(cfg):
        def conv_bn(conv, bn, t, s, pad):
            return _bn(params, stats, cfg, f"{prefix}.{bn}",
                       _conv(params, f"{prefix}.{conv}", t, s, pad, p))

        out = torch.relu(conv_bn("conv1", "bn1", x, 1, 0))
        out = torch.relu(conv_bn("conv2", "bn2", out, stride, 1))
        out = conv_bn("conv3", "bn3", out, 1, 0)
        identity = conv_bn("downsample.0", "downsample.1", x, stride, 0) if proj else x
        x = torch.relu(out + identity)
    pooled = x.mean(dim=(2, 3))
    return p.rnd(pooled) @ p.rnd(params["fc.weight"]).T + params["fc.bias"]


def cross_entropy_loss(params: dict, stats: dict, cfg: dict, x: torch.Tensor, y: torch.Tensor,
                       p: Precision = FP32) -> torch.Tensor:
    """The batch mean of -log softmax(logits)[y]; x (B, C, H, W), y (B,)."""
    logp = torch.log_softmax(logits(params, stats, cfg, x, p), dim=-1)
    return -logp.gather(1, y.view(-1, 1)).mean()
