"""U-Net segmentation training.

Port of `cadx_tpu/train/segmentation.py` (BASELINE.json "U-Net ROI
segmentation"): Adam on Dice + BCE, batched, with IoU/Dice of the
thresholded predictions on a validation set after every epoch. The
forward runs the pool and upsample kernels on the card (a U-Net with
`up="transpose"` upsamples by cuDNN's transposed conv instead). With a mesh the
batches shard over its data axis (`parallel.data_parallel.dp_step`):
each shard's loss is its share of the batch's, and the gradients are
summed over the axis.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch

from cadx_tpu_torch.device import resolve
from cadx_tpu_torch.models import unet
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.train import optim
from cadx_tpu_torch.utils.profiling import span


def dice_bce_loss(model: unet.UNet, x: torch.Tensor, y: torch.Tensor,
                  bce_weight: float = 0.5, eps: float = 1e-6,
                  batch: int | None = None) -> torch.Tensor:
    """Weighted BCE + soft Dice of the clipped sigmoid output, both batch
    means of per-sample terms. `batch`: the whole batch's size when x is
    a data-parallel shard of it; the loss is then the shard's share, so
    the shards' losses sum to the batch's."""
    p = torch.clamp(unet.unet_apply(model, x), eps, 1 - eps)
    terms = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    inter = (p * y).sum(dim=(1, 2, 3))
    denom = p.sum(dim=(1, 2, 3)) + y.sum(dim=(1, 2, 3))
    per_dice = (2 * inter + eps) / (denom + eps)
    if batch is None:
        bce, dice = terms.mean(), 1.0 - per_dice.mean()
    else:
        bce = terms.sum() / (batch * terms[0].numel())
        dice = (x.shape[0] - per_dice.sum()) / batch
    return bce_weight * bce + (1 - bce_weight) * dice


def iou_dice(pred_mask: torch.Tensor, true_mask: torch.Tensor, eps: float = 1e-6):
    """Batch-mean IoU and Dice of thresholded predictions."""
    p = pred_mask.to(torch.float32)
    t = true_mask.to(torch.float32)
    inter = (p * t).sum(dim=(1, 2, 3))
    union = torch.maximum(p, t).sum(dim=(1, 2, 3))
    denom = p.sum(dim=(1, 2, 3)) + t.sum(dim=(1, 2, 3))
    return (((inter + eps) / (union + eps)).mean(),
            ((2 * inter + eps) / (denom + eps)).mean())


def make_seg_train_step(tx: optim.Adam, mesh=None):
    """`step(model, opt_state, x, y)`: one Adam update of the Dice + BCE
    loss in place; returns (opt_state, loss). Without a mesh it runs in the
    spans `train.step` ⊃ `train.forward`, `.backward`, `.optimizer`, as
    `train/step.py`'s steps do. With a mesh the batch's rows shard over its
    data axis."""
    if mesh is not None:
        from cadx_tpu_torch.parallel import data_parallel as dp
        from cadx_tpu_torch.parallel.mesh import DATA_AXIS, row_slices

        replicas = dp.Replicas(mesh.axis(DATA_AXIS))

        def sharded_step(model, opt_state, x, y):
            slices = row_slices(x.shape[0], replicas.axis)
            return dp.dp_step(
                replicas, model, opt_state,
                lambda m, k, dev: dice_bce_loss(m, x[slices[k]].to(dev), y[slices[k]].to(dev),
                                                batch=x.shape[0]),
                tx.step)

        return sharded_step

    def step(model, opt_state, x, y):
        params = list(model.parameters())
        with span("train.step"):
            with torch.enable_grad(), full_fp32():
                with span("train.forward"):
                    loss = dice_bce_loss(model, x, y)
                with span("train.backward"):
                    grads = torch.autograd.grad(loss, params)
            with span("train.optimizer"):
                opt_state = tx.step(params, grads, opt_state)
        return opt_state, loss.detach()

    return step


@dataclasses.dataclass
class SegFitResult:
    model: unet.UNet
    history: list[dict]   # {epoch, loss, val_iou, val_dice}


def fit_segmentation(
    model: unet.UNet, X, Y, X_val, Y_val, *,
    epochs: int = 10, lr: float = 1e-3, batch_size: int = 8,
    threshold: float = 0.5, seed: int = 0,
    log_fn: Callable[[str], None] | None = None, mesh=None, device=None,
) -> SegFitResult:
    """Train a copy of a UNet on X (N, H, W, C) in [0, 1] and binary masks
    Y (N, H, W, 1), on `device` (the card when None; the mesh's home
    device with a `mesh`, whose data axis then shards each batch). A tail
    batch smaller than batch_size wraps around to the start of the
    epoch's permutation, as in JAX, so every step has batch_size
    samples."""
    dev = resolve(mesh.home if mesh is not None and device is None else device)
    log = log_fn or (lambda s: None)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    model = copy.deepcopy(model).to(dev)
    tx = optim.adam(lr)
    opt_state = tx.init(model.parameters())
    train_step = make_seg_train_step(tx, mesh)
    xv = torch.from_numpy(np.asarray(X_val, np.float32)).to(dev)
    yv = torch.from_numpy(np.asarray(Y_val, np.float32)).to(dev)

    rng = np.random.default_rng(seed)
    n = len(X)
    batch_size = min(batch_size, n)  # small datasets still train
    history = []
    with full_fp32():
        for epoch in range(epochs):
            perm = rng.permutation(n)
            losses, weights = [], []
            for i in range(0, n, batch_size):
                idx = perm[i:i + batch_size]
                if len(idx) < batch_size:
                    idx = np.concatenate([idx, perm[:batch_size - len(idx)]])
                opt_state, loss = train_step(model, opt_state,
                                             torch.from_numpy(X[idx]).to(dev),
                                             torch.from_numpy(Y[idx]).to(dev))
                losses.append(loss)   # device scalars; one fetch an epoch
                weights.append(float(len(idx)))
            w = torch.tensor(weights, dtype=torch.float32, device=dev)
            total = float(torch.stack(losses) @ w)
            with torch.no_grad():
                iou, dice = iou_dice(unet.unet_apply(model, xv) >= threshold, yv)
            row = {"epoch": epoch + 1, "loss": total / max(sum(weights), 1.0),
                   "val_iou": float(iou), "val_dice": float(dice)}
            history.append(row)
            log(f"[SEG {epoch+1}/{epochs}] loss={row['loss']:.4f} "
                f"iou={row['val_iou']:.3f} dice={row['val_dice']:.3f}")
    return SegFitResult(model=model, history=history)
