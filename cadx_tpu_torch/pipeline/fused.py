"""The end-to-end CADx pipeline on one batch.

Port of `cadx_tpu/pipeline/fused.py::run_pipeline`: uint8 (B, H, W) ->
clean (suppress, segment, pectoral removal, boundary gray) -> resnet
conv1 (7x7/2, 64 channels) -> bilinear resize to the classifier input ->
CNN -> guarded softmax -> Grad-CAM per explained class -> JET overlay
blended onto the cleaned image. The Grad-CAM tail of each class (CAM,
upsample, heatmap, JET, blend) is one launch of the gradcam_tail kernel
(`kernels/gradcam_tail.py`) on the card, its plain version on the CPU.

Convolutions and matmuls run in full float32 (no TF32) inside
`run_pipeline`, as the JAX package runs them at HIGHEST precision; the
setting is scoped to the call (`precision.full_fp32`). Grad-CAM's one
backward pass, through the dense head, is plain autograd.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cadx_tpu_torch.kernels.gradcam_tail import gradcam_tail
from cadx_tpu_torch.models import cnn, unet
from cadx_tpu_torch.ops.resize import resize_linear
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.preprocess import cleaner
from cadx_tpu_torch.utils.profiling import span
from cadx_tpu_torch.xai.gradcam import conv_features, head_logits


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    image_hw: tuple[int, int] = (256, 256)
    feature_hw: tuple[int, int] = (32, 32)      # classifier spatial input
    classes_to_explain: tuple[int, ...] = (0, 1)
    # storage dtype of the encoder's (B, H/2, W/2, 64) features; the
    # resize reads them back as float32. "bfloat16" is opt-in.
    feature_dtype: str = "float32"
    classifier: cnn.CNNConfig = dataclasses.field(
        default_factory=lambda: cnn.CNNConfig(
            input_shape=(32, 32, 64),
            num_classes=2,
            conv_layers=((128, 3), (64, 3)),
            hidden_units=(256, 128),
        )
    )


class PipelineParams(NamedTuple):
    encoder: unet.ResNetStem
    classifier: cnn.CNN


class PipelineOutput(NamedTuple):
    probs: torch.Tensor       # (B, num_classes)
    predicted: torch.Tensor   # (B,) argmax class
    clean_u8: torch.Tensor    # (B, H, W) cleaned display image
    features: torch.Tensor    # (B, fh, fw, 64) classifier inputs
    overlays: torch.Tensor    # (B, n_explained, H, W, 3) uint8 RGB
    heatmaps: torch.Tensor    # (B, n_explained, H, W) uint8


def init_pipeline_params(generator: torch.Generator, config: PipelineConfig,
                         device=None) -> PipelineParams:
    """Random weights from `generator` (drawn on the CPU, then moved)."""
    return PipelineParams(
        encoder=unet.init_resnet_stem(generator, device=device),
        classifier=cnn.init_params(generator, config.classifier, device=device),
    )


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _gradcam_tail(acts, grads, clean01, config: PipelineConfig):
    """CAM -> matmul upsample -> clip -> truncating u8 -> JET -> blend
    with a joint max-normalise per sample: (overlays, heatmaps)."""
    return gradcam_tail(acts, grads, clean01, config.image_hw)


def run_pipeline(params: PipelineParams, batch_u8: torch.Tensor,
                 config: PipelineConfig) -> PipelineOutput:
    """batch_u8: (B, H, W) uint8 at config.image_hw, on the device the
    params live on."""
    with span("pipeline"), full_fp32(), torch.no_grad():
        with span("pipeline.clean"):
            clean01 = cleaner.clean_boundary_gray(batch_u8) / 255.0
        with span("pipeline.encode"):
            feats = unet.encoder_first_features(params.encoder, clean01[..., None])
            feats = feats.to(_DTYPES[config.feature_dtype])
            feats_small = resize_linear(feats.to(torch.float32), config.feature_hw)
        with span("pipeline.classify"):
            probs = cnn.forward(params.classifier, feats_small)
            predicted = probs.argmax(dim=-1)

        overlays, heatmaps = [], []
        if config.classes_to_explain:
            with span("pipeline.explain"):
                acts = conv_features(params.classifier, feats_small)
                with torch.enable_grad():
                    acts = acts.detach().requires_grad_(True)
                    logits = head_logits(params.classifier, acts)
                    for i, class_idx in enumerate(config.classes_to_explain):
                        seed = torch.zeros_like(logits)
                        seed[:, class_idx] = 1.0
                        (grads,) = torch.autograd.grad(
                            logits, acts, grad_outputs=seed,
                            retain_graph=i + 1 < len(config.classes_to_explain))
                        ov, hm = _gradcam_tail(acts.detach(), grads, clean01, config)
                        overlays.append(ov)
                        heatmaps.append(hm)

        b = batch_u8.shape[0]
        h, w = config.image_hw
        dev = batch_u8.device
        return PipelineOutput(
            probs=probs,
            predicted=predicted,
            clean_u8=(clean01 * 255).to(torch.uint8),
            features=feats_small,
            overlays=(torch.stack(overlays, dim=1) if overlays else
                      torch.zeros((b, 0, h, w, 3), dtype=torch.uint8, device=dev)),
            heatmaps=(torch.stack(heatmaps, dim=1) if heatmaps else
                      torch.zeros((b, 0, h, w), dtype=torch.uint8, device=dev)),
        )


def run_pipeline_checksum(params: PipelineParams, batch_u8: torch.Tensor,
                          config: PipelineConfig) -> torch.Tensor:
    """Scalar digest of the full pipeline, for timing end to end."""
    out = run_pipeline(params, batch_u8, config)
    return (out.probs.sum()
            + out.overlays.to(torch.float32).sum() / 1e6
            + out.features.sum() / 1e3)
