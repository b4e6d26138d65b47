"""Grad-CAM on the split classifier and on the reference resnet50, and the
overlay artifacts.

Port of `cadx_tpu/xai/gradcam.py`:
- the serving CAM, which explains the framework's own classifier:
  `cam_from_acts_grads` with its `conv_features` / `head_logits` aliases
  (the CAM explains the same network that `models.cnn.predict` runs),
  `gradcam_map`, `gradcam_overlay` and
  `generate_dual_class_gradcam_overlays`. The gradient of a class score
  with respect to the conv activations is one autograd pass through the
  dense head;
- the reference's own Grad-CAM (GRADCAM.py:16-81), a torchvision-layout
  resnet50 (`models/resnet.py`) over the ImageNet-normalised display
  image: layer4 activations, the gradient of the class logit through the
  avgpool + fc head alone, the CAM, a bilinear resize and pytorch-grad-
  cam's second min-max after it: `imagenet_input_from_gray`,
  `resnet_gradcam_map`, `resnet_gradcam_overlay` and
  `generate_reference_gradcam_overlays` (one resnet forward for all the
  classes asked for).

Both overlays end in the jet_blend kernel (`kernels/overlay.py`). PNG
files are written by `xai/png.py`, with the reference's filenames.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cadx_tpu_torch.kernels.gradcam_tail import cam_from_acts_grads
from cadx_tpu_torch.kernels.overlay import jet_blend
from cadx_tpu_torch.models import cnn, resnet
from cadx_tpu_torch.ops.resize import resize_linear
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.xai.png import write_png

conv_features = cnn.conv_stack
head_logits = cnn.head_logits


def class_cams(model: cnn.CNN, x: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Normalised CAMs of one batch for several seeds: x (B, H, W, C),
    seeds (S, B, num_classes) d(logits) rows -> (S, B, h, w). One forward
    through the conv stack, one backward through the head per seed."""
    with torch.no_grad():
        acts = conv_features(model, x)
    with torch.enable_grad():
        acts = acts.detach().requires_grad_(True)
        logits = head_logits(model, acts)
        cams = []
        for i, seed in enumerate(seeds):
            (grads,) = torch.autograd.grad(logits, acts, grad_outputs=seed,
                                           retain_graph=i + 1 < len(seeds))
            cams.append(cam_from_acts_grads(acts.detach(), grads))
    return torch.stack(cams)


def gradcam_map(model: cnn.CNN, x: torch.Tensor, class_idx: int) -> torch.Tensor:
    """Normalised [0, 1] CAM at feature resolution for one sample (H, W, C)."""
    seed = torch.zeros((1, 1, model.config.num_classes), device=x.device)
    seed[0, 0, class_idx] = 1.0
    return class_cams(model, x[None].to(torch.float32), seed)[0, 0]


def _overlay(heatmap_u8: torch.Tensor, display_img_u8: torch.Tensor) -> torch.Tensor:
    """show_cam_on_image of one (H, W) heatmap onto a (H, W) gray or (H, W,
    3) RGB uint8 image, through the jet_blend kernel -> (H, W, 3) RGB."""
    img01 = display_img_u8.to(torch.float32) / 255.0
    return jet_blend(heatmap_u8[None], img01[None].contiguous())[0]


def gradcam_overlay(model: cnn.CNN, x: torch.Tensor, display_img_u8: torch.Tensor,
                    class_idx: int, out_hw: tuple[int, int]):
    """CAM -> bilinear upsample -> JET -> show_cam_on_image blend. Returns
    (overlay_u8 RGB (H, W, 3), heatmap_u8 (H, W))."""
    with full_fp32():
        cam = gradcam_map(model, x, class_idx)
    with torch.no_grad():
        cam_big = torch.clamp(resize_linear(cam[None], out_hw)[0], 0.0, 1.0)
        heatmap_u8 = (cam_big * 255).to(torch.uint8)
        return _overlay(heatmap_u8, display_img_u8), heatmap_u8


def _prepare_display(display_img) -> np.ndarray:
    img = np.asarray(display_img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


def _write_pair(save_folder: str, class_idx: int, ov_rgb: np.ndarray, hm: np.ndarray):
    write_png(os.path.join(save_folder, f"gradcam_overlay_class_{class_idx}.png"), ov_rgb)
    write_png(os.path.join(save_folder, f"gradcam_heatmap_class_{class_idx}.png"), hm)


def generate_dual_class_gradcam_overlays(model: cnn.CNN, features, display_img,
                                         classes_to_test=(0, 1),
                                         save_folder: str = "explainability") -> dict:
    """Reference entry point and filenames: writes
    gradcam_overlay_class_{i}.png (the RGB overlay) and
    gradcam_heatmap_class_{i}.png (grayscale) for each class; returns
    {class: (overlay RGB, heatmap)} as numpy arrays. `features` (H, W, C)
    is a tensor on the model's device or an array."""
    os.makedirs(save_folder, exist_ok=True)
    img = _prepare_display(display_img)
    dev = model.out_w.device
    x = torch.as_tensor(features, dtype=torch.float32, device=dev)
    img_t = torch.from_numpy(np.array(img)).to(dev)
    overlays = {}
    for class_idx in classes_to_test:
        ov_rgb, hm = gradcam_overlay(model, x, img_t, int(class_idx), img.shape[:2])
        ov_rgb, hm = ov_rgb.cpu().numpy(), hm.cpu().numpy()
        _write_pair(save_folder, class_idx, ov_rgb, hm)
        overlays[class_idx] = (ov_rgb, hm)
    return overlays


# ---------------------------------------------------------------------------
# The reference's Grad-CAM: a resnet50's layer4 over the display image
# (GRADCAM.py:16-53). The serving CAM above explains the framework's own
# classifier (a deliberate redesign, PARITY.md); this one reproduces the
# reference's heatmaps when the user supplies resnet50 weights.
# ---------------------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_input_from_gray(img_u8: torch.Tensor) -> torch.Tensor:
    """GRADCAM.py:24-28, :46-50: a (H, W) uint8 gray image -> three [0, 1]
    channels -> ImageNet-normalised (1, H, W, 3)."""
    img_f = img_u8.to(torch.float32) / 255.0
    rgb = torch.stack([img_f] * 3, dim=-1)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img_u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img_u8.device)
    return ((rgb - mean) / std)[None]


def resnet_gradcam_cams(model: resnet.ResNet, x: torch.Tensor,
                        class_indices) -> torch.Tensor:
    """pytorch-grad-cam's GradCAM on layer4[-1] for several classes of one
    normalised input x (1, H, W, 3): one resnet forward, then per class
    weights = GAP(d logit_class / d layer4), cam = relu(sum_k w_k A_k),
    min-max at feature resolution -> (S, h, w)."""
    acts = resnet.layer4_features(model, x)
    with torch.enable_grad():
        acts = acts.detach().requires_grad_(True)
        logits = resnet.head_logits(model, acts)
        cams = []
        for i, class_idx in enumerate(class_indices):
            seed = torch.zeros_like(logits)
            seed[0, int(class_idx)] = 1.0
            (grads,) = torch.autograd.grad(logits, acts, grad_outputs=seed,
                                           retain_graph=i + 1 < len(class_indices))
            cams.append(cam_from_acts_grads(acts.detach(), grads)[0])
    return torch.stack(cams)


def resnet_gradcam_map(model: resnet.ResNet, x: torch.Tensor, class_idx: int) -> torch.Tensor:
    """Normalised [0, 1] CAM over layer4 for one normalised input (1, H, W,
    3) -> (h, w)."""
    return resnet_gradcam_cams(model, x, (class_idx,))[0]


def _reference_tail(cam: torch.Tensor, img_u8: torch.Tensor, out_hw: tuple[int, int]):
    """Bilinear resize, the second min-max (pytorch-grad-cam scales again
    after the resize: a resized [0, 1] map has min > 0 and max < 1), trunc(*
    255) heatmap, jet_blend onto the gray image."""
    with torch.no_grad():
        cam_big = resize_linear(cam[None], out_hw)[0]
        cam_big = cam_big - cam_big.amin()
        cam_big = cam_big / (1e-7 + cam_big.amax())
        heatmap_u8 = (cam_big * 255).to(torch.uint8)
        return _overlay(heatmap_u8, img_u8), heatmap_u8


def resnet_gradcam_overlay(model: resnet.ResNet, img_u8: torch.Tensor, class_idx: int,
                           out_hw: tuple[int, int]):
    """Preprocess -> CAM -> resize -> show_cam_on_image blend of one (H, W)
    uint8 gray image. Returns (overlay_u8 RGB, heatmap_u8), the reference's
    (show_cam_on_image output, grayscale_cam * 255) pair
    (GRADCAM.py:63-70)."""
    cam = resnet_gradcam_map(model, imagenet_input_from_gray(img_u8), class_idx)
    return _reference_tail(cam, img_u8, out_hw)


def generate_reference_gradcam_overlays(model: resnet.ResNet, display_img,
                                        classes_to_test=(0, 1),
                                        save_folder: str = "explainability") -> dict:
    """GRADCAM.py:31-81 with the reference's filenames, driven by an
    imported resnet50 (`models.resnet.params_from_state_dict`): one
    forward for all of `classes_to_test`; returns {class: (overlay RGB,
    heatmap)} as numpy arrays."""
    os.makedirs(save_folder, exist_ok=True)
    img = _prepare_display(display_img)
    img_t = torch.from_numpy(np.array(img)).to(model.conv1.weight.device)
    cams = resnet_gradcam_cams(model, imagenet_input_from_gray(img_t), classes_to_test)
    overlays = {}
    for cam, class_idx in zip(cams, classes_to_test):
        ov_rgb, hm = _reference_tail(cam, img_t, img.shape[:2])
        ov_rgb, hm = ov_rgb.cpu().numpy(), hm.cpu().numpy()
        _write_pair(save_folder, class_idx, ov_rgb, hm)
        overlays[class_idx] = (ov_rgb, hm)
    return overlays
