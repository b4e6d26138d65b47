"""Training and evaluation steps and the epoch-loop trainer.

Port of `cadx_tpu/train/step.py`. One minibatch update is a batched
forward (the conv_leaky and pool kernels on the card), batch-averaged
gradients by autograd (the reference's accumulate-then-average), then
either per-tensor clip + SGD or Adam, in place on the model. The loop
touches the host for the shuffle, one loss fetch and one accuracy a
epoch.

Reference loop semantics mirrored (Classes/CNNModel.py:399-513): the
per-epoch shuffle (`np.random.default_rng(seed).permutation`, so the batch
order is the JAX package's), zero-padded partial batches with a mask, lr
x0.98 per epoch (SGD), a best-weights snapshot on a strictly better
validation accuracy and its restore at the end. History rows {epoch,
loss, val_acc} match training_History_advanced.json. Everything runs in
float32 with TF32 off (`precision.full_fp32`), but for the JAX package's
opt-in bfloat16 options: `compute_dtype=torch.bfloat16` runs the conv
stack in bfloat16 (`models/cnn.py::conv_stack`; the bf16 form of the conv
kernel on the card), parameters, Adam state and the head staying float32;
`device_data_dtype=torch.bfloat16` stores the device-resident dataset in
bfloat16, each batch gathered and cast to float32 as JAX does.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from cadx_tpu_torch import checkpoint as ckpt
from cadx_tpu_torch.device import resolve
from cadx_tpu_torch.models import cnn
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.train import optim
from cadx_tpu_torch.utils.profiling import span


def masked_loss_fn(model: cnn.CNN, x, y_onehot, mask, *, training: bool,
                   generator: torch.Generator | None,
                   compute_dtype: torch.dtype | None = None,
                   count: torch.Tensor | None = None,
                   uniforms: list[torch.Tensor] | None = None) -> torch.Tensor:
    """Cross-entropy of the log-softmax of the logits, averaged over the
    real (mask = 1) samples only: the padded tail batch averages over its
    actual count, as the reference does (Classes/CNNModel.py:459-464).
    compute_dtype: the conv stack's opt-in bfloat16 (cnn.conv_stack).
    A data-parallel shard passes the whole batch's real `count` (so the
    shards' losses sum to the batch's) and its rows of the batch's
    dropout `uniforms` (cnn.dropout_uniforms)."""
    logp = torch.log_softmax(cnn.apply(model, x, training, generator,
                                       compute_dtype=compute_dtype,
                                       uniforms=uniforms), dim=-1)
    per_sample = -(y_onehot * logp).sum(dim=-1)
    if count is None:
        count = torch.clamp_min(mask.sum(), 1.0)
    return (per_sample * mask).sum() / count


def _loss_and_grads(model, x, y_onehot, mask, training, generator, compute_dtype=None):
    params = list(model.parameters())
    with torch.enable_grad(), full_fp32():
        with span("train.forward"):
            loss = masked_loss_fn(model, x, y_onehot, mask, training=training,
                                  generator=generator, compute_dtype=compute_dtype)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, params)
    return params, list(grads), loss.detach()


def sgd_train_step(model: cnn.CNN, x, y_onehot, mask, lr: float,
                   generator: torch.Generator | None,
                   training: bool = True,
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One basic-pipeline update in place: grads -> per-tensor clip(5.0)
    -> SGD. Returns the loss, a device scalar."""
    with span("train.step"):
        params, grads, loss = _loss_and_grads(model, x, y_onehot, mask, training,
                                              generator, compute_dtype)
        with span("train.optimizer"):
            optim.sgd_reference_update(params, grads, lr)
    return loss


def make_adam_train_step(tx: optim.Adam, compute_dtype: torch.dtype | None = None):
    """Advanced-pipeline update: Adam on the softmax cross-entropy.
    `step(model, opt_state, x, y_onehot, mask, generator)` updates the model
    in place and returns (opt_state, loss)."""

    def step(model, opt_state, x, y_onehot, mask, generator):
        with span("train.step"):
            params, grads, loss = _loss_and_grads(model, x, y_onehot, mask, True,
                                                  generator, compute_dtype)
            with span("train.optimizer"):
                opt_state = tx.step(params, grads, opt_state)
        return opt_state, loss

    return step


def eval_step(model: cnn.CNN, x: torch.Tensor) -> torch.Tensor:
    """Predicted classes: argmax of the logits."""
    with torch.no_grad(), full_fp32():
        return cnn.apply(model, x).argmax(dim=-1)


def predict_classes(model: cnn.CNN, X, batch_size: int = 64) -> np.ndarray:
    """Predicted classes of a numpy dataset, in batches on the model's
    device."""
    X = np.asarray(X, dtype=np.float32)
    dev = model.out_w.device
    out = [eval_step(model, torch.from_numpy(X[i:i + batch_size]).to(dev)).cpu().numpy()
           for i in range(0, len(X), batch_size)]
    return np.concatenate(out) if out else np.zeros((0,), np.int64)


def evaluate(model: cnn.CNN, X, y_labels, batch_size: int = 64) -> float:
    """Test-set accuracy."""
    preds = predict_classes(model, X, batch_size)
    return float(np.mean(preds == np.asarray(y_labels)[:len(preds)]))


def _stat_lines(named, fmt: str) -> list[str]:
    lines = []
    for name, t in named:
        a = t.detach().cpu().numpy()
        lines.append(fmt.format(name=name, mean=a.mean(), std=a.std(), max=a.max(),
                                min=a.min()))
    return lines


def weight_stats(model: cnn.CNN) -> list[str]:
    """Per-layer weight statistics lines (reference weight_stats,
    Classes/CNNModel.py:479-487), conv, dense, then output; biases are
    skipped."""
    named = ([(f"conv_w.{i}", w) for i, w in enumerate(model.conv_w)]
             + [(f"dense_w.{i}", w) for i, w in enumerate(model.dense_w)]
             + [("out_w", model.out_w)])
    return _stat_lines(
        named, "Layer {name}: mean={mean:.4e}, std={std:.4e}, max={max:.4e}, min={min:.4e}")


def grad_stats(model: cnn.CNN, grads) -> list[str]:
    """Gradient statistics lines (reference log_gradients,
    Classes/CNNModel.py:516-520), one per parameter of `model`."""
    return _stat_lines(
        ((n, g) for (n, _), g in zip(model.named_parameters(), grads)),
        "{name}: mean={mean:.2e}, std={std:.2e}, min={min:.2e}, max={max:.2e}")


@dataclasses.dataclass
class FitResult:
    model: cnn.CNN
    history: list[dict]          # [{epoch, loss, val_acc}] reference schema
    best_val_acc: float
    epoch_accuracy: list[float]  # reference CNNModel.epoch_accuracy
    train_seconds: float


def _adam_state_to_host(state: optim.AdamState | None):
    if state is None:
        return None
    return {"count": state.count, "mu": state.mu, "nu": state.nu}


def _adam_state_from_host(d, device) -> optim.AdamState | None:
    if d is None:
        return None
    return optim.AdamState(int(d["count"]),
                           [torch.from_numpy(a).to(device) for a in d["mu"]],
                           [torch.from_numpy(a).to(device) for a in d["nu"]])


def _load_params(model: cnn.CNN, arrays) -> None:
    with torch.no_grad():
        for p, a in zip(model.parameters(), arrays):
            p.copy_(torch.as_tensor(a))


def fit(
    model: cnn.CNN,
    X, y_onehot, X_test, y_test_labels,
    *,
    epochs: int = 10,
    lr: float = 0.01,
    batch_size: int = 8,
    optimizer: str = "sgd",            # "sgd" (basic) | "adam" (advanced)
    lr_decay: float = 0.98,
    seed: int = 0,
    restore_best: bool = True,
    log_fn: Callable[[str], None] | None = None,
    checkpoint_path: str | None = None,
    state_path: str | None = None,     # full train-state checkpoint (resume)
    resume: bool = False,
    save: bool = True,                 # write checkpoint_path and state_path
                                       # (one rank of a data-parallel world)
    eval_every_batch: bool = False,    # reference evaluates test set per batch
    log_weight_stats: bool = False,    # reference per-layer stats per epoch
    device_data: bool | None = None,   # keep the dataset on the device
    device_data_dtype: torch.dtype | None = None,  # e.g. torch.bfloat16: the
                                       # device copy stored compressed (compute
                                       # stays float32)
    compute_dtype: torch.dtype | None = None,  # e.g. torch.bfloat16: the conv
                                       # stack in bf16, parameters float32
    update_fn=None,                    # (model, opt_state, xb, yb, mb, lr, generator) -> (opt_state, loss)
    device=None,
) -> FitResult:
    """Train a copy of `model` on `device` (the card when None; without
    one this raises unless device="cpu") with the reference loop
    semantics; the caller's model is untouched.

    `update_fn` replaces the built-in step (it updates the model in
    place). With `state_path`, the full training state (parameters,
    optimizer state, epoch, history, both generators' states) is written
    atomically after every epoch and `resume=True` continues from it;
    `save=False` reads a resume state but writes neither file.
    `device_data` (on below 4 GB) puts the dataset on the device once, in
    `device_data_dtype` (float32 when None), and gathers each batch there,
    cast to float32. `compute_dtype` reaches the built-in SGD and Adam
    steps only; an `update_fn` takes its own.
    """
    dev = resolve(device)
    X = np.asarray(X, dtype=np.float32)
    y_onehot = np.asarray(y_onehot, dtype=np.float32)
    model = copy.deepcopy(model).to(dev)
    params = list(model.parameters())
    n = len(X)
    host_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=dev).manual_seed(seed)
    log = log_fn or (lambda s: None)

    if device_data is None:
        device_data = X.nbytes + y_onehot.nbytes < 4 * 1024**3
    if device_data:
        X_dev = torch.from_numpy(X).to(dev).to(device_data_dtype or torch.float32)
        y_dev = torch.from_numpy(y_onehot).to(dev)

    # the test set goes to the device once, in batches of up to 64
    yte = np.asarray(y_test_labels)
    Xte = np.asarray(X_test, dtype=np.float32)
    eval_bs = min(64, max(len(Xte), 1))
    eval_batches = [torch.from_numpy(Xte[i:i + eval_bs]).to(dev)
                    for i in range(0, len(Xte), eval_bs)]

    def eval_acc() -> float:
        if not eval_batches:
            return 0.0
        preds = torch.cat([eval_step(model, xb) for xb in eval_batches])
        return float(np.mean(preds.cpu().numpy() == yte))

    tx = optim.adam(lr) if optimizer == "adam" else None
    opt_state = tx.init(params) if tx is not None else None
    adam_step = make_adam_train_step(tx, compute_dtype) if tx is not None else None

    best_acc, best_params = 0.0, None
    history: list[dict] = []
    epoch_accuracy: list[float] = []
    cur_lr = lr
    start_epoch = 0
    t0 = time.time()

    if resume and state_path and os.path.exists(state_path):
        st = ckpt.load_train_state(state_path)
        _load_params(model, st["params"])
        if st["opt_state"] is not None and opt_state is not None:
            opt_state = _adam_state_from_host(st["opt_state"], dev)
        best_acc = st["best_acc"]
        best_params = (None if st["best_params"] is None else
                       [torch.from_numpy(a).to(dev) for a in st["best_params"]])
        history = list(st["history"])
        epoch_accuracy = list(st["epoch_accuracy"])
        cur_lr = st["lr"]
        start_epoch = st["epoch"]
        host_rng = np.random.default_rng()
        host_rng.bit_generator.state = st["host_rng_state"]
        generator.set_state(torch.from_numpy(st["generator_state"]))
        log(f"[RESUME] from {state_path} at epoch {start_epoch}")

    with full_fp32():
        for epoch in range(start_epoch, epochs):
            perm = host_rng.permutation(n)
            if not device_data:
                Xs, ys = X[perm], y_onehot[perm]
            batch_losses: list[torch.Tensor] = []
            batch_weights: list[float] = []
            for i in range(0, n, batch_size):
                nb = min(batch_size, n - i)
                if device_data:
                    # the padded rows repeat sample 0; the mask drops them
                    idx = np.zeros((batch_size,), np.int64)
                    idx[:nb] = perm[i:i + nb]
                    idx_t = torch.from_numpy(idx).to(dev)
                    xb = X_dev.index_select(0, idx_t).to(torch.float32)
                    yb = y_dev.index_select(0, idx_t)
                else:
                    xb = np.zeros((batch_size,) + X.shape[1:], np.float32)
                    yb = np.zeros((batch_size,) + y_onehot.shape[1:], np.float32)
                    xb[:nb], yb[:nb] = Xs[i:i + nb], ys[i:i + nb]
                    xb, yb = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
                mb = torch.zeros((batch_size,), dtype=torch.float32)
                mb[:nb] = 1.0
                mb = mb.to(dev)
                if update_fn is not None:
                    opt_state, loss = update_fn(model, opt_state, xb, yb, mb, cur_lr,
                                                generator)
                elif tx is not None:
                    opt_state, loss = adam_step(model, opt_state, xb, yb, mb, generator)
                else:
                    loss = sgd_train_step(model, xb, yb, mb, cur_lr, generator,
                                          compute_dtype=compute_dtype)
                batch_losses.append(loss)
                batch_weights.append(float(nb))
                if eval_every_batch:
                    # the reference evaluates the test set after every
                    # batch (CNNM.py:537); off by default
                    acc = eval_acc()
                    log(f"[EPOCH {epoch+1}/{epochs}, BATCH {i//batch_size+1}] "
                        f"BatchLoss={float(loss):.4f}  Accuracy={acc:.4f}")

            weights = torch.tensor(batch_weights, dtype=torch.float32, device=dev)
            avg_loss = float(torch.stack(batch_losses) @ weights) / n
            val_acc = eval_acc()
            epoch_accuracy.append(val_acc)
            history.append({"epoch": epoch + 1, "loss": avg_loss, "val_acc": val_acc})
            log(f"[EPOCH {epoch+1}/{epochs}] Loss={avg_loss:.4f}, ValAcc={val_acc:.4f}")
            if log_weight_stats:
                log("[Weight Stats] per layer:")
                for line in weight_stats(model):
                    log("    " + line)

            if val_acc > best_acc:
                best_acc = val_acc
                best_params = [p.detach().clone() for p in params]
                if checkpoint_path and save:
                    ckpt.save_npz(model, checkpoint_path)
            if optimizer == "sgd":
                cur_lr *= lr_decay

            if state_path and save:
                ckpt.save_train_state(state_path, {
                    "params": [p.detach() for p in params],
                    "opt_state": _adam_state_to_host(opt_state),
                    "best_acc": best_acc,
                    "best_params": best_params,
                    "history": history,
                    "epoch_accuracy": epoch_accuracy,
                    "lr": cur_lr,
                    "epoch": epoch + 1,
                    "host_rng_state": host_rng.bit_generator.state,
                    "generator_state": generator.get_state(),
                })

    if restore_best and best_params is not None:
        _load_params(model, best_params)
    return FitResult(model=model, history=history, best_val_acc=best_acc,
                     epoch_accuracy=epoch_accuracy, train_seconds=time.time() - t0)
