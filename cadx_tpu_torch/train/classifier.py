"""ResNet whole-image classifier training.

The JAX package trains no ResNet: this trainer is the port's own, built as
`train/segmentation.py`'s. One step is the ResNet's training forward
(`models/resnet.py::train_logits`: batch statistics through the training
batch-norm kernels, the running statistics updated in place), the mean
softmax cross-entropy over the batch, every gradient by autograd, then
Adam (`train/optim.py`, one fused kernel on the card), in the spans
`train.step` ⊃ `train.forward`, `.backward`, `.optimizer` (the batch-norm
backwards' `bn_train_kernel` counted in `.backward`). `fit_resnet`
holds the training set on the device, so a step never waits on the card:
each epoch's permutation goes over once from pinned memory, batches are
gathered on the device, and the host fetches the epoch's losses and the
validation accuracy (eval mode: the running statistics through the
inference kernel) once an epoch.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch

from cadx_tpu_torch.device import resolve
from cadx_tpu_torch.kernels import batchnorm
from cadx_tpu_torch.models import resnet
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.train import optim
from cadx_tpu_torch.utils.profiling import span


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The batch mean of -log softmax(logits)[y]; y (B,) int64 classes."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y.view(-1, 1)).mean()


def resnet_loss(model: resnet.ResNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy of the training forward of x (B, H, W, C)."""
    return cross_entropy(resnet.train_logits(model, x), y)


def make_resnet_train_step(tx: optim.Adam):
    """`step(model, opt_state, x, y)`: one Adam update of the cross-entropy
    in place (the batch norms' running statistics too); returns
    (opt_state, loss), the loss a device scalar."""

    def step(model, opt_state, x, y):
        params = list(model.parameters())
        with span("train.step"):
            with torch.enable_grad(), full_fp32():
                with span("train.forward"):
                    loss = resnet_loss(model, x, y)
                with span("train.backward"), batchnorm.backward_counted():
                    grads = torch.autograd.grad(loss, params)
            with span("train.optimizer"):
                opt_state = tx.step(params, grads, opt_state)
        return opt_state, loss.detach()

    return step


def predict_classes(model: resnet.ResNet, X: torch.Tensor, batch_size: int) -> torch.Tensor:
    """argmax of the inference forward's logits (running statistics), in
    batches, on X's device."""
    with torch.no_grad():
        return torch.cat([resnet.forward(model, X[i:i + batch_size]).argmax(dim=-1)
                          for i in range(0, len(X), batch_size)]
                         + [torch.zeros(0, dtype=torch.int64, device=X.device)])


@dataclasses.dataclass
class ResNetFitResult:
    model: resnet.ResNet
    history: list[dict]   # {epoch, loss, val_acc}


def fit_resnet(
    model: resnet.ResNet, X, y, X_val, y_val, *,
    epochs: int = 10, lr: float = 1e-3, batch_size: int = 16, seed: int = 0,
    log_fn: Callable[[str], None] | None = None, device=None,
) -> ResNetFitResult:
    """Train a copy of a ResNet classifier on X (N, H, W, C) float32 and
    integer labels y (N,), on `device` (the card when None). Each epoch
    takes a fresh permutation (`np.random.default_rng(seed)`); a tail
    batch smaller than batch_size wraps around to the start of the
    epoch's permutation, as `fit_segmentation`'s does, so every step has
    batch_size samples. The validation accuracy after each epoch is the
    inference forward's, on the running statistics."""
    dev = resolve(device)
    log = log_fn or (lambda s: None)
    model = copy.deepcopy(model).to(dev)
    tx = optim.adam(lr)
    opt_state = tx.init(model.parameters())
    train_step = make_resnet_train_step(tx)
    xd = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
    yd = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    xv = torch.from_numpy(np.asarray(X_val, np.float32)).to(dev)
    yv = torch.from_numpy(np.asarray(y_val, np.int64)).to(dev)

    rng = np.random.default_rng(seed)
    n = len(xd)
    batch_size = min(batch_size, n)
    steps = -(-n // batch_size)
    history = []
    for epoch in range(epochs):
        perm = rng.permutation(n)
        idx = torch.from_numpy(np.concatenate([perm, perm[:steps * batch_size - n]]))
        if dev.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(dev, non_blocking=True).view(steps, batch_size)
        losses = []
        for i in range(steps):
            opt_state, loss = train_step(model, opt_state, xd.index_select(0, idx[i]),
                                         yd.index_select(0, idx[i]))
            losses.append(loss)   # device scalars; one fetch an epoch
        mean_loss = float(torch.stack(losses).mean())
        acc = float((predict_classes(model, xv, batch_size) == yv).to(torch.float32).mean())
        history.append({"epoch": epoch + 1, "loss": mean_loss, "val_acc": acc})
        log(f"[RESNET {epoch + 1}/{epochs}] loss={mean_loss:.4f} val_acc={acc:.3f}")
    return ResNetFitResult(model=model, history=history)
