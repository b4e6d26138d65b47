"""U-Net family: the tiny autoencoder, the general U-Net, and the resnet
encoder's first convolution.

Port of `cadx_tpu/models/unet.py`:
- TinyUNet (Classes/Preprocessing.py:176-204): the Keras autoencoder
  Conv16 -> pool -> Conv32 -> pool -> Conv64 bottleneck -> 2x (upsample +
  conv) -> 1x1 sigmoid, trained on MSE; its bottleneck is a feature
  extractor.
- UNet: encoder-decoder with skip concatenations (BASELINE.json "U-Net
  ROI segmentation"), trained by `train/segmentation.py`.
- ResNetStem: conv1 of the resnet encoder, 7x7, stride 2, pad 3, no bias,
  1 -> 64 channels, the serving path's feature extractor
  (`encoder_first_features`); the rest of a converted or imported encoder
  is carried untouched in `ResNetStem.rest`.
- the full resnet34 encoder (`init_resnet_encoder`,
  `resnet_encoder_features`, built on `models/resnet.py`), and the pieces
  the resnets share: `BatchNorm` (torchvision's BatchNorm2d keys),
  `bn_apply` through the batchnorm kernel, and `max_pool_plain`.

The public functions take and return channel-last (B, H, W, C) tensors,
as JAX does, and run channel-first inside. Convolutions are SAME + ReLU
through F.conv2d (JAX runs them in XLA); the 2x2 pools go through the
pool kernel (`ops.pool.max_pool_first`, whose backward is the first
maximum's, as JAX's `reduce_window` VJP) and the upsamples through the
upsample kernel. Weights are drawn on the CPU from a `torch.Generator`
with the JAX package's distributions: glorot-uniform (Keras default) for
the tiny U-Net and the U-Net's 1x1 head, He-normal for the U-Net's 3x3
convs, zero biases.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from cadx_tpu_torch.kernels.batchnorm import batchnorm
from cadx_tpu_torch.ops.conv import conv2d
from cadx_tpu_torch.ops.pool import max_pool_first, upsample_nearest

RESNET34_LAYERS = (3, 4, 6, 3)
RESNET34_WIDTHS = (64, 128, 256, 512)


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


def init_resnet_encoder(generator: torch.Generator, in_channels: int = 1,
                        layers=RESNET34_LAYERS, widths=RESNET34_WIDTHS, device=None):
    """The full resnet34 encoder (basic blocks, no fc head) as a
    `models.resnet.ResNet`, He-normal convs drawn on the CPU from
    `generator`, batch norms at scale 1, bias 0, mean 0, var 1."""
    from cadx_tpu_torch.models import resnet

    config = resnet.ResNetConfig(block="basic", layers=tuple(layers), widths=tuple(widths),
                                 in_channels=in_channels)
    return resnet.init_resnet(generator, config, device=device)


def resnet_encoder_features(model, x: torch.Tensor) -> list[torch.Tensor]:
    """Outputs after each encoder child, [conv1, bn1, relu, maxpool,
    layer1..layer4], channel-last, as the app's extract_encoder_features
    loop (app.py:89-94) collects them. x: (B, H, W, C)."""
    from cadx_tpu_torch.models import resnet

    return resnet.stage_features(model, x)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """Inference batch norm parameters under torchvision's BatchNorm2d
    state-dict keys (weight, bias, running_mean, running_var,
    num_batches_tracked)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))


def bn_apply(bn: BatchNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias over channel-first x (B,
    C, H, W): the batchnorm kernel on a CUDA tensor (inference only), its
    plain version on a CPU tensor."""
    return batchnorm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, eps)


def max_pool_plain(x: torch.Tensor, size: int = 2, stride: int | None = None,
                   pad: int = 0) -> torch.Tensor:
    """torch MaxPool2d semantics (-inf padding) over channel-first x: the
    resnets' stem pool, which JAX runs as `reduce_window` outside any
    Pallas kernel."""
    return F.max_pool2d(x, size, stride or size, pad)


class Conv(nn.Module):
    """A stride-1 SAME conv, weight (F, C, k, k), bias (F,)."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, padding="SAME")


def _glorot_conv(generator, k, cin, cout) -> Conv:
    limit = math.sqrt(6.0 / (k * k * cin + k * k * cout))
    w = (torch.rand((cout, cin, k, k), generator=generator) * 2.0 - 1.0) * limit
    return Conv(w, torch.zeros(cout))


def _he_conv(generator, k, cin, cout) -> Conv:
    std = math.sqrt(2.0 / (k * k * cin))
    return Conv(torch.randn((cout, cin, k, k), generator=generator) * std,
                torch.zeros(cout))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# TinyUNet — Keras tiny_unet parity
# ---------------------------------------------------------------------------

class TinyUNet(nn.Module):
    def __init__(self, c1: Conv, c2: Conv, bottleneck: Conv, c3: Conv, c4: Conv,
                 out: Conv):
        super().__init__()
        self.c1, self.c2, self.bottleneck = c1, c2, bottleneck
        self.c3, self.c4, self.out = c3, c4, out


def init_tiny_unet(generator: torch.Generator, in_channels: int = 1,
                   device=None) -> TinyUNet:
    widths = ((in_channels, 16, 3), (16, 32, 3), (32, 64, 3), (64, 32, 3),
              (32, 16, 3), (16, 1, 1))
    convs = [_glorot_conv(generator, k, cin, cout) for cin, cout, k in widths]
    return TinyUNet(*convs).to(device)


def tiny_unet_apply(model: TinyUNet, x: torch.Tensor, *,
                    return_bottleneck: bool = False) -> torch.Tensor:
    """x: (B, H, W, C). Mirrors the Keras graph layer for layer."""
    c1 = torch.relu(model.c1(_nchw(x)))
    c2 = torch.relu(model.c2(max_pool_first(c1)))
    bn = torch.relu(model.bottleneck(max_pool_first(c2)))
    if return_bottleneck:
        return _nhwc(bn)
    c3 = torch.relu(model.c3(upsample_nearest(bn, 2)))
    c4 = torch.relu(model.c4(upsample_nearest(c3, 2)))
    return _nhwc(torch.sigmoid(model.out(c4)))


def tiny_unet_bottleneck(model: TinyUNet, x: torch.Tensor) -> torch.Tensor:
    """Bottleneck features (the reference's bottleneck_model,
    Preprocessing.py:247-248)."""
    return tiny_unet_apply(model, x, return_bottleneck=True)


def tiny_unet_mse(model: TinyUNet, x: torch.Tensor) -> torch.Tensor:
    """Autoencoder reconstruction loss (model.compile(loss='mse'))."""
    return ((tiny_unet_apply(model, x) - x) ** 2).mean()


# ---------------------------------------------------------------------------
# General U-Net with skip connections
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 1
    out_channels: int = 1
    features: tuple[int, ...] = (16, 32, 64, 128)  # per encoder level
    final_activation: str = "sigmoid"  # "sigmoid" | "none"


class DoubleConv(nn.Module):
    def __init__(self, conv1: Conv, conv2: Conv):
        super().__init__()
        self.conv1, self.conv2 = conv1, conv2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv2(torch.relu(self.conv1(x))))


class UNet(nn.Module):
    def __init__(self, config: UNetConfig, enc: list, bottleneck: DoubleConv,
                 dec: list, head: Conv):
        super().__init__()
        self.config = config
        self.enc = nn.ModuleList(enc)
        self.bottleneck = bottleneck
        self.dec = nn.ModuleList(dec)
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return unet_apply(self, x)


def init_unet(generator: torch.Generator, config: UNetConfig, device=None) -> UNet:
    def double(cin, f):
        return DoubleConv(_he_conv(generator, 3, cin, f), _he_conv(generator, 3, f, f))

    enc, cin = [], config.in_channels
    for f in config.features[:-1]:
        enc.append(double(cin, f))
        cin = f
    bottleneck = double(cin, config.features[-1])
    cin = config.features[-1]
    dec = []
    for f in reversed(config.features[:-1]):
        dec.append(double(cin + f, f))
        cin = f
    head = _glorot_conv(generator, 1, cin, config.out_channels)
    return UNet(config, enc, bottleneck, dec, head).to(device)


def unet_apply(model: UNet, x: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder with skip concatenations. x: (B, H, W, C), H and W
    divisible by 2 ** (len(features) - 1)."""
    x = _nchw(x)
    skips = []
    for enc in model.enc:
        x = enc(x)
        skips.append(x)
        x = max_pool_first(x)
    x = model.bottleneck(x)
    for dec, skip in zip(model.dec, reversed(skips)):
        x = dec(torch.cat([upsample_nearest(x, 2), skip], dim=1))
    x = model.head(x)
    if model.config.final_activation == "sigmoid":
        x = torch.sigmoid(x)
    return _nhwc(x)
