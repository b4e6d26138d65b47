"""Turn the JAX package's parameters and optimizer states into the port's.

The input of `convert_pipeline_params` is a `PipelineParams(encoder=...,
classifier=...)` pair (any pair with those two fields, or a 2-tuple); that
of `convert_engine_params` is an engine's three parameter trees and its
config; `convert_unet_params` and `convert_tiny_unet_params` take U-Net
trees, and `convert_adam_state` an optax Adam state. Leaves are numpy
arrays, e.g. `jax.tree_util.tree_map(np.asarray, params)`; configs and
states are read by attribute, so jax is not needed. Conv kernels go from
HWIO to OIHW; dense (in, out) weights are kept as they are. The serving
stem (`convert_encoder`) runs `encoder["conv1"]` only and carries the rest
of the encoder as tensors, untouched, in `ResNetStem.rest`;
`convert_resnet_encoder` turns the whole encoder, and
`convert_resnet_params` any `models/resnet.py` tree, into the port's
`ResNet` (torchvision layout: fc (in, out) becomes (out, in)).
"""

from __future__ import annotations

import numpy as np
import torch

from cadx_tpu_torch.models import cnn, resnet, unet
from cadx_tpu_torch.pipeline.fused import PipelineConfig, PipelineParams
from cadx_tpu_torch.serve.engine import EngineConfig, EngineState
from cadx_tpu_torch.train.optim import AdamState


def hwio_to_oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.array(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1), order="C"))


def _vec(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def convert_encoder(encoder: dict, device=None) -> unet.ResNetStem:
    rest = {k: _tensors(v, device) for k, v in encoder.items() if k != "conv1"}
    return unet.ResNetStem(hwio_to_oihw(encoder["conv1"]["kernel"]).to(device),
                           rest)


def _resnet_state_dict(params: dict) -> dict:
    """A JAX resnet tree -> torchvision state-dict keys and layouts."""
    sd = {}

    def bn(prefix, p):
        sd.update({f"{prefix}.weight": _vec(p["scale"]), f"{prefix}.bias": _vec(p["bias"]),
                   f"{prefix}.running_mean": _vec(p["mean"]),
                   f"{prefix}.running_var": _vec(p["var"])})

    sd["conv1.weight"] = hwio_to_oihw(params["conv1"]["kernel"])
    bn("bn1", params["bn1"])
    for si, stage in enumerate(params["stages"], start=1):
        for bi, block in enumerate(stage):
            p = f"layer{si}.{bi}"
            for name in ("conv1", "conv2", "conv3"):
                if name in block:
                    sd[f"{p}.{name}.weight"] = hwio_to_oihw(block[name]["kernel"])
                    bn(f"{p}.bn{name[-1]}", block[f"bn{name[-1]}"])
            if "downsample" in block:
                sd[f"{p}.downsample.0.weight"] = hwio_to_oihw(block["downsample"]["kernel"])
                bn(f"{p}.downsample.1", block["downsample"]["bn"])
    if "fc" in params:
        sd["fc.weight"] = _vec(np.asarray(params["fc"]["kernel"]).T)
        sd["fc.bias"] = _vec(params["fc"]["bias"])
    return sd


def convert_resnet_params(params: dict, config=None, device=None) -> resnet.ResNet:
    """A JAX `models.resnet` tree (`init_resnet`, `params_from_state_dict`)
    -> the port's ResNet. `config` (a JAX or port ResNetConfig, read by
    attribute) or, when None, the one the weights' shapes give."""
    if config is not None:
        config = resnet.ResNetConfig(
            block=config.block, layers=tuple(config.layers), widths=tuple(config.widths),
            in_channels=config.in_channels, num_classes=config.num_classes)
    return resnet.params_from_state_dict(_resnet_state_dict(params), config,
                                         device=device)[1]


def convert_resnet_encoder(encoder: dict, device=None) -> resnet.ResNet:
    """The full-encoder counterpart of `convert_encoder`: a JAX
    `unet.init_resnet_encoder` tree -> the port's resnet34 encoder."""
    return convert_resnet_params(encoder, None, device)


def convert_classifier(params: dict, config: cnn.CNNConfig,
                       device=None) -> cnn.CNN:
    conv = [(hwio_to_oihw(layer["kernel"]), _vec(layer["bias"]))
            for layer in params["conv"]]
    dense = [(_vec(layer["kernel"]), _vec(layer["bias"]))
             for layer in params["dense"]]
    output = (_vec(params["output"]["kernel"]), _vec(params["output"]["bias"]))
    return cnn.CNN(config, conv, dense, output).to(device)


def convert_cnn_config(config) -> cnn.CNNConfig:
    """A JAX `CNNConfig` (read by attribute, so jax is not needed) -> the
    port's."""
    return cnn.CNNConfig(
        input_shape=tuple(config.input_shape), num_classes=config.num_classes,
        conv_layers=tuple(tuple(c) for c in config.conv_layers),
        hidden_units=tuple(config.hidden_units),
        dropout_rate=float(config.dropout_rate),
        leaky_alpha=config.leaky_alpha, conv_padding=config.conv_padding)


def convert_engine_params(encoder_params, basic_params, advanced_params,
                          config, device=None):
    """A JAX serving engine's weights and `EngineConfig` -> the port's
    (EngineConfig, EngineState), for `InferenceEngine(config, state=...)`.
    The weights are numpy trees (`jax.tree_util.tree_map(np.asarray, ...)`
    of `encoder_params`, `basic_params`, `advanced_params`); the config is
    read by attribute."""
    basic = convert_cnn_config(config.basic_classifier)
    advanced = convert_cnn_config(config.advanced_classifier)
    ours = EngineConfig(
        segment_hw=tuple(config.segment_hw),
        feature_resize=tuple(config.feature_resize),
        native_clean_max_side=config.native_clean_max_side,
        basic_classifier=basic, advanced_classifier=advanced)
    state = EngineState(
        encoder=convert_encoder(encoder_params, device),
        basic=convert_classifier(basic_params, basic, device),
        advanced=convert_classifier(advanced_params, advanced, device))
    return ours, state


def convert_pipeline_params(params, config: PipelineConfig,
                            device=None) -> PipelineParams:
    encoder, classifier = params
    return PipelineParams(
        encoder=convert_encoder(encoder, device),
        classifier=convert_classifier(classifier, config.classifier, device),
    )


def _conv(layer: dict) -> unet.Conv:
    return unet.Conv(hwio_to_oihw(layer["kernel"]), _vec(layer["bias"]))


def convert_tiny_unet_params(params: dict, device=None) -> unet.TinyUNet:
    """A JAX `init_tiny_unet` tree -> the port's TinyUNet."""
    return unet.TinyUNet(*(_conv(params[k]) for k in
                           ("c1", "c2", "bottleneck", "c3", "c4", "out"))).to(device)


def convert_unet_params(params: dict, config: unet.UNetConfig,
                        device=None) -> unet.UNet:
    """A JAX `init_unet` tree -> the port's UNet. The JAX package has no
    up-convolution, so `config.up` must be "nearest"."""
    if config.up != "nearest":
        raise ValueError(f"the JAX package's U-Net upsamples by nearest neighbour; no JAX "
                         f"tree holds the up-convolutions of up={config.up!r}")

    def double(p):
        return unet.DoubleConv(_conv(p["conv1"]), _conv(p["conv2"]))

    return unet.UNet(config, [double(p) for p in params["enc"]],
                     double(params["bottleneck"]),
                     [double(p) for p in params["dec"]],
                     _conv(params["head"])).to(device)


def convert_adam_state(state, convert_params, device=None) -> AdamState:
    """An optax Adam state (`ScaleByAdamState`, or the tuple `optax.adam`
    makes with it first) -> the port's AdamState. `convert_params` maps a
    parameter-shaped tree to the port's module (e.g. `lambda t:
    convert_classifier(t, config)`); mu and nu go through it, so each
    moment lands in its parameter's layout and order."""
    if not hasattr(state, "mu"):
        state = state[0]

    def moments(tree):
        return [p.detach().to(device) for p in convert_params(tree).parameters()]

    return AdamState(int(np.asarray(state.count)), moments(state.mu),
                     moments(state.nu))
