"""Inference engine behind the serving routes.

Port of `cadx_tpu/serve/engine.py`: one instance serves all requests, from
concurrent threads. Its surface is the one the HTTP front calls:
`process_single_image` (clean at native resolution, or at a bucketed shape
for oversized uploads, -> segment_hw gray -> resnet conv1 features),
`finalize_feature_token`, `classify`, `classify_and_roi`,
`roi_coords_per_class`, `classify_batch`, `write_gradcam_overlays`,
`dynamic_batcher` and `warmup`. Two pipelines:

- "basic": features bilinearly resized to the basic classifier's input,
  CNN, guarded softmax;
- "advanced": the full feature stack classified directly.

A classify request is one device program in effect (`_fused_request`):
forward, the predicted class's Grad-CAM ROI and the per-class ROIs, packed
into one small vector that is fetched to the host once. `dispatch_count`
and `fetch_count` expose that contract. A failure of the CAM/ROI tail
raises; nothing falls back to a fixed box.

Weights come from a seed (`torch.Generator`), from a JAX engine's
parameters through `convert.convert_engine_params`, or from the reference
deployment's artifacts: a cnn_model `.npz` for the basic classifier, a
training-summary JSON and `.pth` for the advanced one, an smp/torchvision
resnet34 `.pth` for the encoder, and a torchvision resnet50 `.pth` for the
reference Grad-CAM, which `write_gradcam_overlays` then runs in place of
the explain-own-classifier CAM. A missing artifact keeps its seeded
weights. Everything runs on one device, `device`: the card unless the
caller passes `device="cpu"` (construction raises without a card). The
mesh data-parallel bulk path of the JAX engine is not ported.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import tempfile
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cadx_tpu_torch import checkpoint
from cadx_tpu_torch.device import resolve
from cadx_tpu_torch.models import cnn, resnet, unet
from cadx_tpu_torch.ops.resize import resize_area, resize_linear
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.preprocess import cleaner
from cadx_tpu_torch.xai import gradcam
from cadx_tpu_torch.xai.roi import roi_dict_from_vals, roi_from_cam

CLASS_MAP = {0: "Benign", 1: "Malignant", 2: "Normal"}


def classify_result_dict(probs, cls_idx: int, roi: dict) -> dict:
    """The classify result schema (reference rows, app.py:555-564), shared
    by the per-sample path and the micro-batcher."""
    probs = np.asarray(probs)
    return {
        "prediction_probabilities": probs.tolist(),
        "predicted_class": CLASS_MAP[cls_idx],
        "predicted_class_index": cls_idx,
        "accuracy": round(float(probs.max()) * 100, 2),
        "confidence": 76,  # reference quirk (app.py:560)
        "diagnosis": CLASS_MAP[cls_idx],
        "explainability": 0.5,
        "roiCoords": roi,
    }


def bucket_clean_hw(h: int, w: int, cap: int) -> tuple[int, int]:
    """Cleaning resolution for an oversized native upload: long side ==
    cap, short side scaled, then rounded up to a multiple of 128 (at most
    cap/128 distinct shapes); orientation kept."""
    scale = cap / max(h, w)
    short = max(128, -(-round(min(h, w) * scale) // 128) * 128)
    short = min(short, cap)
    return (cap, short) if h >= w else (short, cap)


@dataclasses.dataclass
class EngineConfig:
    segment_hw: tuple[int, int] = (512, 512)
    feature_resize: tuple[int, int] = (32, 32)
    # Native uploads whose long side exceeds this are area-downscaled to a
    # bucketed shape (bucket_clean_hw) before cleaning; None cleans at any
    # native size, as the reference does.
    native_clean_max_side: int | None = 1536
    basic_classifier: cnn.CNNConfig = dataclasses.field(
        default_factory=lambda: cnn.CNNConfig(
            input_shape=(32, 32, 64), num_classes=2,
            conv_layers=((128, 3), (64, 3)), hidden_units=(256, 128),
            dropout_rate=0.3))
    advanced_classifier: cnn.CNNConfig = dataclasses.field(
        default_factory=lambda: cnn.CNNConfig(
            input_shape=(256, 256, 64), num_classes=2,
            conv_layers=((32, 3), (64, 3)), hidden_units=(256, 128),
            dropout_rate=0.1))


class EngineState(NamedTuple):
    encoder: unet.ResNetStem
    basic: cnn.CNN
    advanced: cnn.CNN


def init_engine_state(generator: torch.Generator, config: EngineConfig,
                      device=None) -> EngineState:
    """Random weights from `generator`, drawn on the CPU, then moved."""
    return EngineState(
        encoder=unet.init_resnet_stem(generator, device=device),
        basic=cnn.init_params(generator, config.basic_classifier, device=device),
        advanced=cnn.init_params(generator, config.advanced_classifier,
                                 device=device))


def _fused_request(model: cnn.CNN, feats_in: torch.Tensor,
                  class_indices: tuple[int, ...]) -> torch.Tensor:
    """One classify/roi request on the device, packed into one float32
    vector [probs (num_classes) | pred | roi_pred (4) | roi per class (4
    each)], each roi (top, left, height, width) from `roi_from_cam`. The
    predicted class's seed is a one-hot of the device argmax, so nothing
    waits for the host before the single fetch."""
    n = model.config.num_classes
    x = feats_in[None].to(torch.float32)
    with full_fp32():
        with torch.no_grad():
            probs = cnn.forward(model, x)[0]
        pred = probs.argmax()
        classes = torch.cat([pred[None], torch.tensor(class_indices, dtype=torch.long,
                                                      device=x.device)])
        seeds = F.one_hot(classes, n).to(torch.float32)[:, None]
        cams = gradcam.class_cams(model, x, seeds)[:, 0]
        with torch.no_grad():
            rois = roi_from_cam(cams)
    return torch.cat([probs, pred[None].to(torch.float32), rois.reshape(-1)])


class InferenceEngine:
    # device feature cache: 4 slots of (64, 256, 256) float32 stacks
    _FEATS_CACHE_SLOTS = 4

    def __init__(self, config: EngineConfig | None = None, seed: int = 0,
                 device=None, state: EngineState | None = None,
                 basic_npz: str | None = None,
                 advanced_summary_json: str | None = None,
                 advanced_pth: str | None = None,
                 encoder_pth: str | None = None,
                 gradcam_pth: str | None = None):
        """Weights: `state` (e.g. from `convert.convert_engine_params`), or
        random weights from `seed`; then each artifact that exists replaces
        its part, as the reference deployment loads them: `basic_npz` the
        basic classifier (CNNM.py:658), `advanced_summary_json` with
        `advanced_pth` the advanced one (app.py:571-575), `encoder_pth`
        (an smp or torchvision resnet34 state dict) the encoder's conv1
        (app.py:78-94). `gradcam_pth`, a torchvision resnet50 state dict
        with its fc head, switches the overlays to the reference's own
        Grad-CAM (GRADCAM.py:16-53); one without a head raises ValueError
        here rather than on every request. Everything runs on `device`,
        the card when None; without a card that raises unless
        device="cpu"."""
        self.config = config or EngineConfig()
        self.device = resolve(device)
        if state is None:
            state = init_engine_state(torch.Generator().manual_seed(seed),
                                      self.config)
        encoder, basic, advanced = state
        if encoder_pth and os.path.exists(encoder_pth):
            enc = resnet.encoder_params_from_state_dict(encoder_pth)[1].state_dict()
            encoder = unet.ResNetStem(enc.pop("conv1.weight"), rest=enc)
        self.gradcam_resnet = None
        if gradcam_pth and os.path.exists(gradcam_pth):
            cfg50, model50 = resnet.encoder_params_from_state_dict(gradcam_pth)
            if model50.fc is None:
                raise ValueError(
                    f"gradcam_pth {gradcam_pth!r} has no 'fc' head: it looks like an "
                    "encoder-only state dict (pass that as encoder_pth); the reference "
                    "Grad-CAM needs a full classifier resnet50 .pth")
            self.gradcam_resnet = (cfg50, model50.to(self.device))
        if basic_npz and os.path.exists(basic_npz):
            cfg, basic = checkpoint.load_npz(basic_npz)
            self.config = dataclasses.replace(self.config, basic_classifier=cfg)
        if (advanced_summary_json and advanced_pth and os.path.exists(advanced_summary_json)
                and os.path.exists(advanced_pth)):
            from cadx_tpu_torch.compat.adcnnm import load_trained_model

            cfg, advanced = load_trained_model(advanced_summary_json, advanced_pth)
            self.config = dataclasses.replace(self.config, advanced_classifier=cfg)
        self.encoder_params = encoder.to(self.device)
        self.basic_params = basic.to(self.device)
        self.advanced_params = advanced.to(self.device)
        # per-request cost observability: one device program and one host
        # fetch per classify request (tested)
        self.dispatch_count = 0
        self.fetch_count = 0
        self._device_feats_lru: collections.OrderedDict = collections.OrderedDict()
        self._feats_lock = threading.Lock()
        self._batchers: dict = {}
        self._batchers_lock = threading.Lock()

    # ------------------------------------------------------------------
    # segmentation (upload-single path)
    # ------------------------------------------------------------------
    def process_single_image(self, img: np.ndarray, cache_token=None):
        """cleaner -> segment_hw gray -> encoder conv1 features. Returns
        (features CHW (64, h/2, w/2) float32, clean image uint8), numpy.

        Oversized natives (long side > native_clean_max_side) are
        area-downscaled to a bucketed shape first. `cache_token` keeps the
        device copy of the features for a later classify/roi."""
        x = torch.as_tensor(_host_image(img), device=self.device)
        cap = self.config.native_clean_max_side
        if cap and max(x.shape) > cap:
            x = resize_area(x[None].to(torch.float32),
                            bucket_clean_hw(*x.shape, cap))[0]
        feats, clean_u8 = self._segment(x)
        if cache_token is not None:
            self._feats_cache_put(cache_token, feats)
        return feats.cpu().numpy(), clean_u8.cpu().numpy()

    def _segment(self, img: torch.Tensor):
        with full_fp32(), torch.no_grad():
            gray = cleaner.clean_boundary_gray(img[None])
            resized = resize_area(gray, self.config.segment_hw)
            feats = unet.encoder_first_features(
                self.encoder_params, (resized / 255.0)[..., None])[0]
            clean_u8 = torch.clamp(torch.round(resized[0]), 0, 255).to(torch.uint8)
            return feats.permute(2, 0, 1).contiguous(), clean_u8

    def _put_locked(self, token, feats) -> None:
        lru = self._device_feats_lru
        lru.pop(token, None)
        lru[token] = feats
        while len(lru) > self._FEATS_CACHE_SLOTS:
            lru.popitem(last=False)

    def _feats_cache_put(self, token, feats) -> None:
        with self._feats_lock:
            self._put_locked(token, feats)

    def finalize_feature_token(self, provisional, final) -> None:
        """Rebind cached features from a provisional token to the final
        content token. No-op on a miss."""
        with self._feats_lock:
            lru = self._device_feats_lru
            if provisional in lru:
                self._put_locked(final, lru.pop(provisional))

    def _cached_device_features(self, features, cache_token):
        """The device copy of `features` cached under `cache_token` (a hit
        refreshes its recency), or None."""
        if cache_token is None:
            return None
        with self._feats_lock:
            lru = self._device_feats_lru
            if cache_token not in lru:
                return None
            dev = lru[cache_token]
            lru.move_to_end(cache_token)
        return dev if tuple(dev.shape) == tuple(np.shape(features)) else None

    # ------------------------------------------------------------------
    # classification (classify / roi paths)
    # ------------------------------------------------------------------
    @staticmethod
    def _to_hwc(f):
        """CHW -> HWC for numpy arrays or tensors: features are CHW with the
        encoder's 64 channels; the reference's shape[0] < shape[2] rule
        covers the rest."""
        if f.ndim == 3 and ((f.shape[0] == 64 and f.shape[-1] != 64)
                            or f.shape[0] < f.shape[2]):
            return f.permute(1, 2, 0) if isinstance(f, torch.Tensor) else f.transpose(1, 2, 0)
        return f

    def process_bottleneck_features(self, feat: np.ndarray) -> np.ndarray:
        """CHW -> HWC + bilinear resize to the basic classifier's input."""
        f = self._to_hwc(torch.from_numpy(np.array(feat, np.float32)))
        out = resize_linear(f[None].to(self.device), self.config.feature_resize)[0]
        return out.cpu().numpy()

    def _prep_classifier_input(self, features, pipeline: str, cache_token=None):
        """Features -> (classifier input on the device, model). A cache hit
        keeps the whole prep on the device; the ops are the same."""
        dev = self._cached_device_features(features, cache_token)
        if dev is None:
            dev = torch.from_numpy(np.array(features, np.float32)).to(self.device)
        f = self._to_hwc(dev.to(torch.float32))
        if pipeline == "basic":
            return resize_linear(f[None], self.config.feature_resize)[0], self.basic_params
        return f, self.advanced_params

    def roi_coords_per_class(self, features, pipeline: str = "basic",
                             class_indices=(0, 1)) -> list[dict]:
        """CAM-derived roiCoords for each requested class."""
        return self.classify_and_roi(features, pipeline, class_indices)[1]

    def classify(self, features, pipeline: str = "basic", cache_token=None) -> dict:
        """One sample -> result dict shaped like the reference's rows."""
        return self.classify_and_roi(features, pipeline, class_indices=(),
                                     cache_token=cache_token)[0]

    def classify_and_roi(self, features, pipeline: str = "basic",
                         class_indices=(0, 1), cache_token=None):
        """classify + per-class CAM roiCoords: one device program, one host
        fetch."""
        feats_in, model = self._prep_classifier_input(features, pipeline,
                                                      cache_token)
        self.dispatch_count += 1
        vec = _fused_request(model, feats_in, tuple(class_indices))
        self.fetch_count += 1
        vec = vec.cpu().numpy()  # the single host fetch
        n = model.config.num_classes
        roi = roi_dict_from_vals(vec[n + 1:n + 5])
        coords = [roi_dict_from_vals(vec[n + 5 + 4 * i:n + 9 + 4 * i])
                  for i in range(len(class_indices))]
        return classify_result_dict(vec[:n], int(vec[n]), roi), coords

    # ------------------------------------------------------------------
    # dynamic micro-batching
    # ------------------------------------------------------------------
    def dynamic_batcher(self, pipeline: str = "basic", max_batch: int = 8,
                        max_wait_ms: float = 4.0):
        """The MicroBatcher of this pipeline and settings, made once."""
        from cadx_tpu_torch.serve.batcher import MicroBatcher

        key = (pipeline, max_batch, max_wait_ms)
        with self._batchers_lock:
            if key not in self._batchers:
                self._batchers[key] = MicroBatcher(
                    self, pipeline, max_batch=max_batch, max_wait_ms=max_wait_ms)
            return self._batchers[key]

    # ------------------------------------------------------------------
    # batched bulk classification
    # ------------------------------------------------------------------
    def classify_batch(self, images_u8: np.ndarray, pipeline: str = "basic") -> list[dict]:
        """(B, H, W) uint8 at segment_hw -> one result row per image, through
        the port's `run_pipeline` with bf16 feature storage, no CAMs."""
        from cadx_tpu_torch.pipeline import fused

        cfg = (self.config.basic_classifier if pipeline == "basic"
               else self.config.advanced_classifier)
        pcfg = fused.PipelineConfig(
            image_hw=tuple(self.config.segment_hw),
            feature_hw=(tuple(self.config.feature_resize) if pipeline == "basic"
                        else tuple(cfg.input_shape[:2])),
            classes_to_explain=(), feature_dtype="bfloat16", classifier=cfg)
        params = fused.PipelineParams(
            encoder=self.encoder_params,
            classifier=self.basic_params if pipeline == "basic" else self.advanced_params)
        out = fused.run_pipeline(
            params, torch.as_tensor(np.asarray(images_u8), device=self.device), pcfg)
        fetched = torch.cat([out.probs, out.predicted[:, None].to(torch.float32)],
                            dim=1).cpu().numpy()
        probs, preds = fetched[:, :-1], fetched[:, -1].astype(int)
        return [
            {
                "sample": i + 1,
                "prediction_probabilities": probs[i].tolist(),
                "predicted_class": CLASS_MAP[int(preds[i])],
                "accuracy": round(float(probs[i].max()) * 100, 2),
                "diagnosis": CLASS_MAP[int(preds[i])],
            }
            for i in range(len(preds))
        ]

    def warmup(self, native_shapes=()) -> None:
        """Run every serving path once on dummy inputs: segment at
        segment_hw and at each of `native_shapes`, both classifiers with
        their CAM/ROI tails, the micro-batchers and the overlay writer
        (the reference resnet50 Grad-CAM where `gradcam_pth` gave one)."""
        h, w = self.config.segment_hw
        feats = None
        for hw_ in [(h, w)] + [tuple(s) for s in native_shapes]:
            feats, _clean = self.process_single_image(np.zeros(hw_, np.uint8))
        with tempfile.TemporaryDirectory() as tmp:
            for pipeline in ("basic", "advanced"):
                self.classify_and_roi(feats, pipeline)
                self.dynamic_batcher(pipeline).classify(feats)
                self.write_gradcam_overlays(feats, np.zeros((h, w), np.uint8), tmp,
                                            classes=(0, 1), pipeline=pipeline)

    # ------------------------------------------------------------------
    # explainability artifacts
    # ------------------------------------------------------------------
    def write_gradcam_overlays(self, features, display_img: np.ndarray,
                               save_folder: str, classes=(0, 1),
                               pipeline: str = "basic") -> dict:
        """Per-class Grad-CAM overlays with the reference's filenames. With
        an imported resnet50 (`gradcam_pth`), the reference's own CAM over
        the display image; otherwise the active classifier's (a redesign,
        PARITY.md)."""
        if self.gradcam_resnet is not None:
            return gradcam.generate_reference_gradcam_overlays(
                self.gradcam_resnet[1], display_img, classes, save_folder)
        if pipeline == "basic":
            feats = self.process_bottleneck_features(features)
            model = self.basic_params
        else:
            feats = self._to_hwc(np.array(features, np.float32))
            model = self.advanced_params
        return gradcam.generate_dual_class_gradcam_overlays(
            model, feats, display_img, classes, save_folder)


def _host_image(img) -> np.ndarray:
    """An upload as an array torch takes on any device: uint16 (which
    CUDA tensors barely support) becomes float32, exactly; the cleaner
    rescales by the image max either way."""
    arr = np.array(img)
    return arr.astype(np.float32) if arr.dtype == np.uint16 else arr
