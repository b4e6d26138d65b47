"""Turn the JAX package's pipeline and serving-engine parameters into the
port's.

The input of `convert_pipeline_params` is a `PipelineParams(encoder=...,
classifier=...)` pair (any pair with those two fields, or a 2-tuple); that
of `convert_engine_params` is an engine's three parameter trees and its
config. Leaves are numpy arrays, e.g.
`jax.tree_util.tree_map(np.asarray, params)`. Conv kernels go from
HWIO to OIHW; dense (in, out) weights are kept as they are. Only
`encoder["conv1"]` runs on the ported slice; the rest of the encoder is
carried as tensors, untouched, in `ResNetStem.rest`.
"""

from __future__ import annotations

import numpy as np
import torch

from cadx_tpu_torch.models import cnn, unet
from cadx_tpu_torch.pipeline.fused import PipelineConfig, PipelineParams
from cadx_tpu_torch.serve.engine import EngineConfig, EngineState


def hwio_to_oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


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


def convert_classifier(params: dict, config: cnn.CNNConfig,
                       device=None) -> cnn.CNN:
    def vec(x):
        return torch.from_numpy(np.asarray(x, np.float32).copy())

    conv = [(hwio_to_oihw(layer["kernel"]), vec(layer["bias"]))
            for layer in params["conv"]]
    dense = [(vec(layer["kernel"]), vec(layer["bias"]))
             for layer in params["dense"]]
    output = (vec(params["output"]["kernel"]), vec(params["output"]["bias"]))
    return cnn.CNN(config, conv, dense, output).to(device)


def convert_cnn_config(config) -> cnn.CNNConfig:
    """A JAX `CNNConfig` (read by attribute, so jax is not needed) -> the
    port's; its training-only dropout_rate is dropped."""
    return cnn.CNNConfig(
        input_shape=tuple(config.input_shape), num_classes=config.num_classes,
        conv_layers=tuple(tuple(c) for c in config.conv_layers),
        hidden_units=tuple(config.hidden_units),
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
