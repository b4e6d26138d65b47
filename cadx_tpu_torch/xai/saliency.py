"""Input-gradient saliency, the reference's manual NumPy XAI path.

Port of `cadx_tpu/xai/saliency.py` (reference explainability.py): for each
target class, run the classifier forward (no dropout), take the gradient
of the softmax cross-entropy against that class with respect to the
INPUT, then saliency = the channel max of |d_input|, min-max scaled to
uint8, JET-coloured, bilinearly resized to the display image and blended
0.5 / 0.5 onto it (cv2.addWeighted). The gradient is autograd through the
classifier's conv_leaky and pool kernels; the tail is plain ops (the JAX
package has no Pallas kernel on this path). Arrays are BGR, as the
reference's cv2 calls make them; the PNG files hold the same colours.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from cadx_tpu_torch.models import cnn
from cadx_tpu_torch.ops.colormap import add_weighted, apply_jet, normalize_to_u8
from cadx_tpu_torch.ops.resize import resize_linear
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.xai.png import write_png


def input_gradient(model: cnn.CNN, x: torch.Tensor, class_idx: int) -> torch.Tensor:
    """d(cross-entropy against class_idx) / d(input) for one sample (H, W,
    C): the reference backward seeded with probs - onehot
    (explainability.py:13-68)."""
    y = F.one_hot(torch.tensor([class_idx], device=x.device),
                  model.config.num_classes).to(torch.float32)
    with torch.enable_grad(), full_fp32():
        xin = x[None].detach().to(torch.float32).requires_grad_(True)
        (grad,) = torch.autograd.grad(cnn.loss_fn(model, xin, y), xin)
    return grad[0]


def saliency_map_u8(d_input: torch.Tensor) -> torch.Tensor:
    """Channel max of |grad| -> min-max -> uint8 (explainability.py:72-74)."""
    return normalize_to_u8(d_input.abs().amax(dim=-1))


def saliency_overlay(model: cnn.CNN, x: torch.Tensor, display_img_u8: torch.Tensor,
                     class_idx: int, out_hw: tuple[int, int]):
    """grad -> saliency -> JET -> resize -> 0.5 / 0.5 blend.

    display_img_u8: the (H, W) or (H, W, 3) uint8 image under the heatmap.
    Returns (overlay_u8 BGR, heatmap_u8 BGR) at out_hw, as
    generate_saliency_overlay does (explainability.py:71-78)."""
    sal = saliency_map_u8(input_gradient(model, x, class_idx))
    with torch.no_grad():
        heat_small = apply_jet(sal)
        # cv2.resize's INTER_LINEAR of the uint8 BGR heatmap, rounded back
        heat = resize_linear(heat_small.to(torch.float32)[None], out_hw)[0]
        heat = torch.clamp(torch.round(heat), 0, 255).to(torch.uint8)
        if display_img_u8.ndim == 2:
            display_img_u8 = torch.stack([display_img_u8] * 3, dim=-1)
        return add_weighted(display_img_u8, 0.5, heat, 0.5, 0.0), heat


def generate_dual_class_overlays(model: cnn.CNN, features, display_img,
                                 classes_to_test=(0, 1),
                                 save_folder: str = "explainability") -> dict:
    """The reference entry point and filenames (explainability.py:81-108):
    writes overlay_class_{i}.png and heatmap_class_{i}.png into
    save_folder; returns {class: (overlay BGR, heatmap BGR)} as numpy
    arrays. `features` (H, W, C) is a tensor on the model's device or an
    array."""
    os.makedirs(save_folder, exist_ok=True)
    img = np.asarray(display_img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    dev = model.out_w.device
    x = torch.as_tensor(features, dtype=torch.float32, device=dev)
    img_t = torch.from_numpy(np.array(img)).to(dev)
    overlays = {}
    for class_idx in classes_to_test:
        ov, hm = saliency_overlay(model, x, img_t, int(class_idx), img.shape[:2])
        ov, hm = ov.cpu().numpy(), hm.cpu().numpy()
        # the arrays are BGR, as cv2.imwrite takes them; PNG stores RGB
        write_png(os.path.join(save_folder, f"overlay_class_{class_idx}.png"), ov[..., ::-1])
        write_png(os.path.join(save_folder, f"heatmap_class_{class_idx}.png"), hm[..., ::-1])
        overlays[class_idx] = (ov, hm)
    return overlays
