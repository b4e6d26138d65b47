"""Turn the JAX package's pipeline parameters into the port's.

The input is a `PipelineParams(encoder=..., classifier=...)` pair (any
pair with those two fields, or a 2-tuple) whose leaves are numpy arrays,
e.g. `jax.tree_util.tree_map(np.asarray, params)`. Conv kernels go from
HWIO to OIHW; dense (in, out) weights are kept as they are. Only
`encoder["conv1"]` runs on the ported slice; the rest of the encoder is
carried as tensors, untouched, in `ResNetStem.rest`.
"""

from __future__ import annotations

import numpy as np
import torch

from cadx_tpu_torch.models import cnn, unet
from cadx_tpu_torch.pipeline.fused import PipelineConfig, PipelineParams


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


def convert_pipeline_params(params, config: PipelineConfig,
                            device=None) -> PipelineParams:
    encoder, classifier = params
    return PipelineParams(
        encoder=convert_encoder(encoder, device),
        classifier=convert_classifier(classifier, config.classifier, device),
    )
