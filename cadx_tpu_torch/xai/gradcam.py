"""Grad-CAM on the split classifier, and the overlay artifacts.

Port of `cadx_tpu/xai/gradcam.py`: `cam_from_acts_grads` with its
`conv_features` / `head_logits` aliases (the CAM explains the same network
that `models.cnn.predict` runs), `gradcam_map`, `gradcam_overlay` and
`generate_dual_class_gradcam_overlays` with the reference's filenames.
The gradient of a class score with respect to the conv activations is one
autograd pass through the dense head. PNG files are written by
`xai/png.py`. The resnet50 reference Grad-CAM is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cadx_tpu_torch.models import cnn
from cadx_tpu_torch.ops.colormap import apply_jet
from cadx_tpu_torch.ops.resize import resize_linear
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.xai.png import write_png

conv_features = cnn.conv_stack
head_logits = cnn.head_logits


def cam_from_acts_grads(acts: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """weights = GAP(grads), cam = relu(sum_k w_k A_k), min-max per sample
    to [0, 1] (+1e-7 guard). (B, h, w, F) -> (B, h, w)."""
    weights = grads.mean(dim=(1, 2), keepdim=True)
    cam = torch.relu((weights * acts).sum(dim=-1))
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / (hi - lo + 1e-7)


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


def gradcam_overlay(model: cnn.CNN, x: torch.Tensor, display_img_u8: torch.Tensor,
                    class_idx: int, out_hw: tuple[int, int]):
    """CAM -> bilinear upsample -> JET -> show_cam_on_image blend. Returns
    (overlay_u8 RGB (H, W, 3), heatmap_u8 (H, W))."""
    with full_fp32():
        cam = gradcam_map(model, x, class_idx)
    with torch.no_grad():
        cam_big = torch.clamp(resize_linear(cam[None], out_hw)[0], 0.0, 1.0)
        heatmap_u8 = (cam_big * 255).to(torch.uint8)
        jet_rgb = (apply_jet(heatmap_u8).to(torch.float32) / 255.0).flip(-1)
        if display_img_u8.ndim == 2:
            img_rgb = torch.stack([display_img_u8] * 3, dim=-1)
        else:
            img_rgb = display_img_u8
        cam_img = jet_rgb + img_rgb.to(torch.float32) / 255.0
        cam_img = cam_img / torch.clamp_min(cam_img.amax(), 1e-7)
        return (cam_img * 255).to(torch.uint8), heatmap_u8


def generate_dual_class_gradcam_overlays(model: cnn.CNN, features, display_img,
                                         classes_to_test=(0, 1),
                                         save_folder: str = "explainability") -> dict:
    """Reference entry point and filenames: writes
    gradcam_overlay_class_{i}.png (the RGB overlay) and
    gradcam_heatmap_class_{i}.png (grayscale) for each class; returns
    {class: (overlay RGB, heatmap)} as numpy arrays. `features` (H, W, C)
    is a tensor on the model's device or an array."""
    os.makedirs(save_folder, exist_ok=True)
    img = np.asarray(display_img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    dev = model.out_w.device
    x = torch.as_tensor(features, dtype=torch.float32, device=dev)
    img_t = torch.from_numpy(np.array(img)).to(dev)
    overlays = {}
    for class_idx in classes_to_test:
        ov_rgb, hm = gradcam_overlay(model, x, img_t, int(class_idx), img.shape[:2])
        ov_rgb, hm = ov_rgb.cpu().numpy(), hm.cpu().numpy()
        write_png(os.path.join(save_folder, f"gradcam_overlay_class_{class_idx}.png"), ov_rgb)
        write_png(os.path.join(save_folder, f"gradcam_heatmap_class_{class_idx}.png"), hm)
        overlays[class_idx] = (ov_rgb, hm)
    return overlays
