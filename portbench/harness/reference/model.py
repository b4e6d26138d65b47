"""Plain PyTorch reference of the models, Grad-CAM, ROI and Adam.

A frozen, plain copy of what the port computes with its kernels: the
encoder's conv1 (7x7, stride 2, 64 channels), the reference CNN ([conv +
bias + LeakyReLU, 2x2 max pool] blocks, a row-major flatten, dense +
LeakyReLU layers with inverted dropout in training, the guarded softmax),
Grad-CAM over the conv stack's output (GAP of the gradients, ReLU,
min-max, bilinear upsample as two matmuls, JET blend), the ROI of a CAM
and Adam in optax's order. Parameters are plain tensors:

    {"conv": [(w (F, C, k, k), b (F,)), ...], "dense": [(w (in, out), b), ...],
     "out": (w, b)}

`Precision` fixes the arithmetic of every convolution and product: full
float32 (TF32 off), or TF32, the nearest precision below, which is the
control that the comparison must reject. TF32 rounds both operands of a
product to 10 mantissa bits and accumulates in float32; `Precision.rnd`
does the rounding itself, so the control computes alike on the card and
on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .colormap import apply_jet
from .components import largest_component_plain
from .resize import _interp_matrix


@dataclasses.dataclass(frozen=True)
class Precision:
    tf32: bool = False

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to TF32 (10 mantissa bits, nearest, ties to even) in
        the TF32 control, its gradient passed through; x itself in
        float32."""
        if not self.tf32:
            return x
        bits = x.detach().contiguous().view(torch.int32)
        bits = bits + (0xFFF + ((bits >> 13) & 1))
        return x + ((bits & ~0x1FFF).view(torch.float32) - x).detach()

    @contextlib.contextmanager
    def scope(self):
        """cuDNN and matmul TF32 set to this precision while inside."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


FP32 = Precision(False)
TF32 = Precision(True)


def conv1(weight: torch.Tensor, img01: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """(B, H, W) in [0, 1] -> (B, H/2, W/2, 64) raw conv1 features."""
    x = img01[:, None].to(torch.float32)
    return F.conv2d(p.rnd(x), p.rnd(weight), stride=2, padding=3).permute(0, 2, 3, 1)


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * x)


def _windows(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    oh, ow = h // size, w // size
    xr = x[..., :oh * size, :ow * size].reshape(*x.shape[:-2], oh, size, ow, size)
    return xr.movedim(-3, -2).reshape(*x.shape[:-2], oh, ow, size * size)


def _unwindow(core: torch.Tensor, like: torch.Tensor, size: int) -> torch.Tensor:
    *lead, oh, ow, _ = core.shape
    core = core.reshape(*lead, oh, ow, size, size).movedim(-2, -3)
    out = torch.zeros_like(like)
    out[..., :oh * size, :ow * size] = core.reshape(*lead, oh * size, ow * size)
    return out


class _MaxPoolTies(torch.autograd.Function):
    """Window max over the cropped 2x2 windows; the gradient goes in full
    to every tied maximum (the reference CNN's backward)."""

    @staticmethod
    def forward(ctx, x, size: int):
        out = _windows(x, size).amax(dim=-1)
        ctx.save_for_backward(x, out)
        ctx.size = size
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        hit = _windows(x, ctx.size) == out[..., None]
        core = torch.where(hit, g[..., None], torch.zeros((), dtype=g.dtype, device=g.device))
        return _unwindow(core, x, ctx.size), None


def conv_stack(params: dict, cfg: dict, x: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, F) after the conv + pool blocks."""
    pad = 0 if cfg["conv_padding"] == "VALID" else None
    out = x.permute(0, 3, 1, 2)
    for w, b in params["conv"]:
        z = F.conv2d(p.rnd(out), p.rnd(w), b,
                     padding=w.shape[-1] // 2 if pad is None else pad)
        out = _MaxPoolTies.apply(leaky_relu(z, cfg["leaky_alpha"]), 2)
    return out.permute(0, 2, 3, 1)


def head_logits(params: dict, cfg: dict, feats: torch.Tensor, p: Precision = FP32,
                uniforms: list | None = None) -> torch.Tensor:
    """Flatten, dense + LeakyReLU (with dropout where `uniforms` are
    given: keep where u > rate, scaled by 1 / (1 - rate)), output logits."""
    rate = cfg["dropout_rate"]
    out = feats.reshape(feats.shape[0], -1)
    for i, (w, b) in enumerate(params["dense"]):
        out = leaky_relu(p.rnd(out) @ p.rnd(w) + b, cfg["leaky_alpha"])
        if uniforms is not None and rate > 0:
            out = out * (uniforms[i] > rate).to(out.dtype) / (1.0 - rate)
    w, b = params["out"]
    return p.rnd(out) @ p.rnd(w) + b


def softmax(z: torch.Tensor) -> torch.Tensor:
    """Logits clipped to [-50, 50], max-subtracted, 1e-12 added to the
    denominator, uniform where the sum is 0."""
    z = torch.clamp(z, -50.0, 50.0)
    z = z - z.amax(dim=-1, keepdim=True)
    exps = torch.exp(z)
    s = exps.sum(dim=-1, keepdim=True)
    uniform = torch.ones_like(z) / z.shape[-1]
    return torch.where(s == 0, uniform, exps / (s + 1e-12))


def cam_from_acts_grads(acts: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    weights = grads.mean(dim=(1, 2), keepdim=True)
    cam = torch.relu((weights * acts).sum(dim=-1))
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / (hi - lo + 1e-7)


def class_grads(params: dict, cfg: dict, acts: torch.Tensor, seeds, p: Precision = FP32):
    """d(logits . seed)/d(acts) for each seed row (S, B, num_classes)."""
    with torch.enable_grad():
        a = acts.detach().requires_grad_(True)
        logits = head_logits(params, cfg, a, p)
        out = []
        for i, seed in enumerate(seeds):
            (g,) = torch.autograd.grad(logits, a, grad_outputs=seed,
                                       retain_graph=i + 1 < len(seeds))
            out.append(g)
    return out


def resize_linear_mxu(img: torch.Tensor, out_hw, p: Precision = FP32) -> torch.Tensor:
    oh, ow = out_hw
    h, w = img.shape[-2], img.shape[-1]
    r = torch.as_tensor(_interp_matrix(oh, h), device=img.device)
    ct = torch.as_tensor(_interp_matrix(ow, w).T, device=img.device)
    return p.rnd(p.rnd(r) @ p.rnd(img.to(torch.float32))) @ p.rnd(ct)


def jet_blend(heat_u8: torch.Tensor, img01: torch.Tensor) -> torch.Tensor:
    """JET of the heatmap as RGB in [0, 1] plus the image, divided by the
    joint max per image, * 255, truncated."""
    jet_rgb = (apply_jet(heat_u8).to(torch.float32) / 255.0).flip(-1)
    over = jet_rgb + (img01[..., None] if img01.ndim == 3 else img01)
    over = over / torch.clamp_min(over.amax(dim=(1, 2, 3), keepdim=True), 1e-7)
    return (over * 255).to(torch.uint8)


def gradcam_tail(acts, grads, img01, out_hw, p: Precision = FP32):
    """(overlay (B, oh, ow, 3) uint8 RGB, heatmap (B, oh, ow) uint8)."""
    cam_big = resize_linear_mxu(cam_from_acts_grads(acts, grads), out_hw, p)
    heat_u8 = (torch.clamp(cam_big, 0.0, 1.0) * 255).to(torch.uint8)
    return jet_blend(heat_u8, img01), heat_u8


def roi_from_cam(cam: torch.Tensor, threshold: float = 0.6) -> torch.Tensor:
    """(B, h, w) -> (B, 4) (top, left, height, width) of the largest
    8-connected region >= threshold * max, in [0, 1] coordinates."""
    b, h, w = cam.shape
    hot = cam >= threshold * cam.amax(dim=(1, 2), keepdim=True)
    region = largest_component_plain(hot, 8)
    rows = region.any(dim=2).to(torch.int32)
    cols = region.any(dim=1).to(torch.int32)
    y0 = rows.argmax(dim=1)
    y1 = h - rows.flip(1).argmax(dim=1)
    x0 = cols.argmax(dim=1)
    x1 = w - cols.flip(1).argmax(dim=1)
    inv_h = float(np.float32(1.0) / np.float32(h))
    inv_w = float(np.float32(1.0) / np.float32(w))
    f32 = torch.float32
    return torch.stack([y0.to(f32) * inv_h, x0.to(f32) * inv_w,
                        (y1 - y0).to(f32) * inv_h, (x1 - x0).to(f32) * inv_w], dim=1)


def masked_loss(params: dict, cfg: dict, x, y_onehot, mask, uniforms,
                p: Precision = FP32) -> torch.Tensor:
    """Cross-entropy of the log-softmax, averaged over the real rows."""
    logp = torch.log_softmax(head_logits(params, cfg, conv_stack(params, cfg, x, p), p,
                                         uniforms), dim=-1)
    per_sample = -(y_onehot * logp).sum(dim=-1)
    return (per_sample * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def leaves(params: dict) -> dict[str, torch.Tensor]:
    """The parameters by the port's names: conv_w.i, conv_b.i, dense_w.i,
    dense_b.i, out_w, out_b."""
    out = {}
    for group, i in (("conv", 0), ("dense", 0)):
        for j, (w, b) in enumerate(params[group]):
            out[f"{group}_w.{j}"] = w
            out[f"{group}_b.{j}"] = b
    out["out_w"], out["out_b"] = params["out"]
    return out


def adam_step(leaves_, grads, mu, nu, count: int, lr: float, b1: float, b2: float,
              eps: float) -> None:
    """One Adam update in place, in optax's order (count is the new step)."""
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    with torch.no_grad():
        for q, g, m, v in zip(leaves_, grads, mu, nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            m_hat = m / torch.full((), c1, device=m.device)
            v_hat = v / torch.full((), c2, device=v.device)
            q.add_(-lr * (m_hat / (torch.sqrt(v_hat) + eps)))
