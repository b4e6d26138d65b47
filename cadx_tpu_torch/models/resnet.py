"""ResNet family (basic and bottleneck blocks) with torch state-dict import.

Port of `cadx_tpu/models/resnet.py`. The reference depends on two
pretrained torch ResNets: smp.Unet's resnet34 encoder, whose children give
the app's feature maps (app.py:78-94), and torchvision's resnet50, whose
layer4[-1] is the Grad-CAM target (GRADCAM.py:16, 52-53). A user who
supplies their own `.pth` gets the reference's feature values back.

`ResNet` is an `nn.Module` whose submodules carry torchvision's own names
(conv1, bn1, layer1..layer4 of blocks with conv1..conv3, bn1..bn3 and
downsample.0/1, fc), so importing a torchvision state dict is
`load_state_dict`, and an smp one the same after stripping its `encoder.`
prefix. Convolutions are F.conv2d in full float32 (the JAX package leaves
them to XLA). The public functions take channel-last (B, H, W, C) tensors,
as JAX's do, and run channel-first inside. Two paths:

- inference (`stage_features`, `layer4_features`, `head_logits`,
  `forward`): every batch norm applies the running statistics through the
  inference batchnorm kernel (`models/unet.py::bn_apply`), 53 of them in a
  ResNet-50, under `torch.no_grad` (that kernel records no autograd
  graph); Grad-CAM differentiates the head alone (`head_logits`);
- training (`train_logits`, bottleneck blocks): autograd records the
  whole network, every batch norm normalises with its batch's statistics
  and updates its running statistics in place through the training kernels
  (`kernels/batchnorm.py::batchnorm_train`, the ReLU after it fused), the
  stem's 3x3/2 max pool is `F.max_pool2d` (the pool kernel has no padded
  overlapping form; JAX too leaves that pool to XLA), and the head is the
  global average pool and fc. Spans `resnet.stem`, `resnet.layer1` ..
  `resnet.layer4`, `resnet.head`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cadx_tpu_torch.kernels.batchnorm import batchnorm_train
from cadx_tpu_torch.models.unet import BatchNorm, bn_apply, max_pool_plain
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block: str = "basic"                      # "basic" | "bottleneck"
    layers: tuple[int, ...] = (3, 4, 6, 3)
    widths: tuple[int, ...] = (64, 128, 256, 512)
    in_channels: int = 3
    num_classes: int | None = None            # None -> encoder only (no fc)

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4


RESNET34 = ResNetConfig(block="basic", layers=(3, 4, 6, 3))
RESNET50 = ResNetConfig(block="bottleneck", layers=(3, 4, 6, 3))
RESNET50_CLASSIFIER = dataclasses.replace(RESNET50, num_classes=1000)


# ---------------------------------------------------------------------------
# modules (torchvision's names)
# ---------------------------------------------------------------------------

class ConvWeight(nn.Module):
    """A bias-free convolution's weight (O, I, kh, kw), key `weight`."""

    def __init__(self, cout: int, cin: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((cout, cin, k, k)))


class Linear(nn.Module):
    """The fc head, torchvision's layout: weight (out, in), bias (out,)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((cout, cin)))
        self.bias = nn.Parameter(torch.zeros(cout))


class Block(nn.Module):
    """A basic (3x3, 3x3) or bottleneck (1x1, 3x3 with the stride, 1x1 x4)
    block, with a 1x1 projection where the shape changes."""

    def __init__(self, kind: str, cin: int, width: int, stride: int):
        super().__init__()
        if kind == "basic":
            cout = width
            self.conv1, self.bn1 = ConvWeight(width, cin, 3), BatchNorm(width)
            self.conv2, self.bn2 = ConvWeight(width, width, 3), BatchNorm(width)
        else:
            cout = 4 * width
            self.conv1, self.bn1 = ConvWeight(width, cin, 1), BatchNorm(width)
            self.conv2, self.bn2 = ConvWeight(width, width, 3), BatchNorm(width)
            self.conv3, self.bn3 = ConvWeight(cout, width, 1), BatchNorm(cout)
        self.downsample = (nn.Sequential(ConvWeight(cout, cin, 1), BatchNorm(cout))
                           if stride != 1 or cin != cout else None)
        self.out_channels = cout


class ResNet(nn.Module):
    """Weights of a ResNet of `config`, zero until initialised or loaded."""

    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.config = config
        self.conv1 = ConvWeight(64, config.in_channels, 7)
        self.bn1 = BatchNorm(64)
        cin = 64
        for si, (n_blocks, width) in enumerate(zip(config.layers, config.widths)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Block(config.block, cin, width,
                                    2 if (si > 0 and bi == 0) else 1))
                cin = blocks[-1].out_channels
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        self.n_stages = len(config.layers)
        self.fc = Linear(cin, config.num_classes) if config.num_classes is not None else None

    def stages(self) -> list[nn.Sequential]:
        return [getattr(self, f"layer{i + 1}") for i in range(self.n_stages)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_resnet(generator: torch.Generator, config: ResNetConfig, device=None) -> ResNet:
    """Random weights drawn on the CPU from `generator`, the torchvision
    layout: He-normal convs (in the JAX package's order: conv1, then each
    block's convs and projection), batch norms at scale 1, bias 0, mean 0,
    var 1, and a uniform(+-1/sqrt(in)) fc with zero bias."""
    model = ResNet(config)

    def he(conv: ConvWeight):
        cout, cin, kh, kw = conv.weight.shape
        conv.weight.data = (torch.randn((cout, cin, kh, kw), generator=generator)
                            * math.sqrt(2.0 / (kh * kw * cin)))

    he(model.conv1)
    for stage in model.stages():
        for block in stage:
            for name in ("conv1", "conv2", "conv3"):
                if hasattr(block, name):
                    he(getattr(block, name))
            if block.downsample is not None:
                he(block.downsample[0])
    if model.fc is not None:
        cout, cin = model.fc.weight.shape
        limit = 1.0 / math.sqrt(cin)
        model.fc.weight.data = (torch.rand((cout, cin), generator=generator) * 2.0 - 1.0) * limit
    return model.to(device)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, conv: ConvWeight, stride: int, pad: int) -> torch.Tensor:
    return F.conv2d(x, conv.weight, stride=stride, padding=pad)


def _basic_block(p: Block, x: torch.Tensor, stride: int) -> torch.Tensor:
    identity = x
    out = torch.relu(bn_apply(p.bn1, _conv(x, p.conv1, stride, 1)))
    out = bn_apply(p.bn2, _conv(out, p.conv2, 1, 1))
    if p.downsample is not None:
        identity = bn_apply(p.downsample[1], _conv(x, p.downsample[0], stride, 0))
    return torch.relu(out + identity)


def _bottleneck_block(p: Block, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torchvision Bottleneck: 1x1 reduce -> 3x3 (the stride here,
    torchvision's 'ResNet V1.5') -> 1x1 expand (x4), relu after the add."""
    identity = x
    out = torch.relu(bn_apply(p.bn1, _conv(x, p.conv1, 1, 0)))
    out = torch.relu(bn_apply(p.bn2, _conv(out, p.conv2, stride, 1)))
    out = bn_apply(p.bn3, _conv(out, p.conv3, 1, 0))
    if p.downsample is not None:
        identity = bn_apply(p.downsample[1], _conv(x, p.downsample[0], stride, 0))
    return torch.relu(out + identity)


def stage_features(model: ResNet, x: torch.Tensor) -> list[torch.Tensor]:
    """Outputs after each encoder child in torchvision's named_children
    order, [conv1, bn1, relu, maxpool, layer1..layer4], as channel-last
    views (app.py:89-94). x: (B, H, W, C) float32."""
    block_fn = _basic_block if model.config.block == "basic" else _bottleneck_block
    feats = []
    with torch.no_grad(), full_fp32():
        x = x.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        x = _conv(x, model.conv1, 2, 3)
        feats.append(x)                       # features[0]: the raw conv1 output
        x = bn_apply(model.bn1, x)
        feats.append(x)
        x = torch.relu(x)
        feats.append(x)
        x = max_pool_plain(x, 3, 2, pad=1)
        feats.append(x)
        for si, stage in enumerate(model.stages()):
            for bi, block in enumerate(stage):
                x = block_fn(block, x, (1 if si == 0 else 2) if bi == 0 else 1)
            feats.append(x)
    return [f.permute(0, 2, 3, 1) for f in feats]


def layer4_features(model: ResNet, x: torch.Tensor) -> torch.Tensor:
    """The Grad-CAM target activations (layer4[-1]'s output,
    GRADCAM.py:52-53), channel-last."""
    return stage_features(model, x)[-1]


def head_logits(model: ResNet, layer4: torch.Tensor) -> torch.Tensor:
    """avgpool + fc on channel-last layer4 activations, the split point of
    the Grad-CAM backward. (B, h, w, C) -> (B, num_classes)."""
    with full_fp32():
        return layer4.mean(dim=(1, 2)) @ model.fc.weight.T + model.fc.bias


def forward(model: ResNet, x: torch.Tensor) -> torch.Tensor:
    """Full classifier forward: stages -> global average pool -> fc.
    (B, H, W, C) -> (B, num_classes) logits, inference only."""
    with torch.no_grad():
        return head_logits(model, layer4_features(model, x))


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _bn_train(bn: BatchNorm, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """BatchNorm2d in training mode (momentum 0.1, eps 1e-5), then the ReLU
    where `relu`, through the training kernels."""
    return batchnorm_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                           bn.num_batches_tracked, relu=relu)


def _bottleneck_block_train(p: Block, x: torch.Tensor, stride: int) -> torch.Tensor:
    identity = x
    out = _bn_train(p.bn1, _conv(x, p.conv1, 1, 0), True)
    out = _bn_train(p.bn2, _conv(out, p.conv2, stride, 1), True)
    out = _bn_train(p.bn3, _conv(out, p.conv3, 1, 0), False)
    if p.downsample is not None:
        identity = _bn_train(p.downsample[1], _conv(x, p.downsample[0], stride, 0), False)
    return torch.relu(out + identity)


def train_logits(model: ResNet, x: torch.Tensor) -> torch.Tensor:
    """The bottleneck classifier's training forward: (B, H, W, C) -> (B,
    num_classes) logits, recorded by autograd (under the caller's grad
    mode), with every batch norm on its batch's statistics and its running
    statistics updated in place; float32 with TF32 off."""
    if model.config.block != "bottleneck":
        raise ValueError(f"train_logits trains bottleneck ResNets, not {model.config.block!r}")
    with full_fp32():
        with span("resnet.stem"):
            # NCHW strides even for one channel, whose permuted view is also
            # channels-last: cuDNN would answer it in channels-last, which
            # the batch-norm kernels do not take
            x = x.to(torch.float32).permute(0, 3, 1, 2).clone(
                memory_format=torch.contiguous_format)
            x = _bn_train(model.bn1, _conv(x, model.conv1, 2, 3), True)
            x = F.max_pool2d(x, 3, 2, 1)
        for si, stage in enumerate(model.stages()):
            with span(f"resnet.layer{si + 1}"):
                for bi, block in enumerate(stage):
                    x = _bottleneck_block_train(block, x,
                                                (1 if si == 0 else 2) if bi == 0 else 1)
        with span("resnet.head"):
            return x.mean(dim=(2, 3)) @ model.fc.weight.T + model.fc.bias


# ---------------------------------------------------------------------------
# torch state-dict import
# ---------------------------------------------------------------------------

def _shape(t) -> tuple[int, ...]:
    return tuple(t.shape)


def detect_config(sd: Mapping[str, Any]) -> ResNetConfig:
    """Block type, stage depths, widths, in_channels and fc from the
    state-dict keys alone (torchvision resnet18-152, smp resnet encoders)."""
    block = "bottleneck" if "layer1.0.conv3.weight" in sd else "basic"
    layers, widths = [], []
    for li in range(1, 5):
        n = 0
        while f"layer{li}.{n}.conv1.weight" in sd:
            n += 1
        if n == 0:
            break
        layers.append(n)
        key = "conv1" if block == "bottleneck" else "conv2"
        widths.append(_shape(sd[f"layer{li}.0.{key}.weight"])[0])
    in_channels = _shape(sd["conv1.weight"])[1]
    num_classes = _shape(sd["fc.weight"])[0] if "fc.weight" in sd else None
    return ResNetConfig(block=block, layers=tuple(layers), widths=tuple(widths),
                        in_channels=in_channels, num_classes=num_classes)


def strip_prefix(sd: Mapping[str, Any], prefix: str | None = None) -> dict:
    """Remove a key prefix. With prefix=None, detects smp's 'encoder.'
    prefix (smp.Unet state dicts keep the resnet under it)."""
    if prefix is None:
        prefix = "encoder." if any(k.startswith("encoder.conv1") for k in sd) else ""
    if not prefix:
        return dict(sd)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def params_from_state_dict(sd: Mapping[str, Any], config: ResNetConfig | None = None,
                           prefix: str | None = None,
                           device=None) -> tuple[ResNetConfig, ResNet]:
    """torch state dict -> (config, ResNet) on `device` (the CPU when None).
    Takes torchvision resnets and smp resnet encoders (the 'encoder.'
    prefix is stripped); values may be tensors or numpy arrays. Keys the
    architecture does not name are ignored; an fc head is loaded where
    the config has one and the state dict holds it."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
          for k, v in strip_prefix(sd, prefix).items()}
    if config is None:
        config = detect_config(sd)
    model = ResNet(config)
    if model.fc is not None and "fc.weight" not in sd:
        model.fc = None
    ours = model.state_dict()
    missing = [k for k in ours if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} keys of {config}: {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in ours if k in sd}, strict=False)
    return config, model.to(device)


def load_state_dict_file(path: str) -> dict:
    """Read a .pth/.pt file into a state dict (weights_only=True keeps the
    unpickling data-only)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return obj


def encoder_params_from_state_dict(sd_or_path, prefix: str | None = None,
                                   device=None) -> tuple[ResNetConfig, ResNet]:
    """Import an smp or torchvision resnet (a path or a state dict), e.g.
    the serving engine's feature encoder or its Grad-CAM resnet50."""
    if isinstance(sd_or_path, (str, bytes)):
        sd_or_path = load_state_dict_file(sd_or_path)
    return params_from_state_dict(sd_or_path, prefix=prefix, device=device)
