"""K-fold cross-validation on one device.

Port of `cadx_tpu/train/crossval.py`: the reference `CrossValidator`
(Classes/CrossValidator.py:10-17) wraps sklearn KFold(n_splits=5) and
leaves `split_data`/`aggregate_metrics` unimplemented; here the folds are
sklearn-identical, each fold trains through `step.fit`, and the metrics
are aggregated. The JAX package's mesh data-parallel folds are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cadx_tpu_torch.device import resolve
from cadx_tpu_torch.models import cnn
from cadx_tpu_torch.train import step
from cadx_tpu_torch.train.metrics import evaluation_block


class KFold:
    """sklearn-identical deterministic K-fold splitter: the first n % k
    folds get n // k + 1 samples; optional shuffle with seed."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False, seed: int = 0):
        if n_splits < 2:
            raise ValueError("n_splits must be >= 2")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.seed = seed

    def split(self, n: int):
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(idx)
        fold_sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        fold_sizes[: n % self.n_splits] += 1
        start = 0
        for size in fold_sizes:
            test = idx[start:start + size]
            train = np.concatenate([idx[:start], idx[start + size:]])
            yield train, test
            start += size


@dataclasses.dataclass
class CrossValResult:
    fold_results: list[step.FitResult]
    fold_accuracies: list[float]
    fold_evaluations: list[dict]
    mean_accuracy: float
    std_accuracy: float

    def aggregate_metrics(self) -> dict:
        return {
            "n_splits": len(self.fold_accuracies),
            "fold_accuracies": self.fold_accuracies,
            "mean_accuracy": self.mean_accuracy,
            "std_accuracy": self.std_accuracy,
        }


def cross_validate(
    config: cnn.CNNConfig,
    X,
    y_labels,
    *,
    n_splits: int = 5,
    epochs: int = 10,
    lr: float = 0.01,
    batch_size: int = 8,
    optimizer: str = "sgd",
    seed: int = 0,
    log_fn=None,
    compute_dtype: torch.dtype | None = None,
    device=None,
) -> CrossValResult:
    """Train and evaluate k folds on `device` (the card when None); fold
    f starts from weights drawn with seed + f. compute_dtype: the conv
    stack's opt-in bfloat16 (see cnn.conv_stack)."""
    dev = resolve(device)
    X = np.asarray(X, dtype=np.float32)
    y_labels = np.asarray(y_labels)
    y_onehot = np.eye(config.num_classes, dtype=np.float32)[y_labels]

    results, accs, evals = [], [], []
    for fold, (train_idx, test_idx) in enumerate(KFold(n_splits).split(len(X))):
        model = cnn.init_params(torch.Generator().manual_seed(seed + fold), config)
        res = step.fit(
            model, X[train_idx], y_onehot[train_idx], X[test_idx], y_labels[test_idx],
            epochs=epochs, lr=lr, batch_size=batch_size, optimizer=optimizer,
            seed=seed + fold, log_fn=log_fn, compute_dtype=compute_dtype, device=dev,
        )
        preds = step.predict_classes(res.model, X[test_idx])
        evals.append(evaluation_block(y_labels[test_idx], preds, config.num_classes))
        accs.append(res.best_val_acc)
        results.append(res)
        if log_fn:
            log_fn(f"[FOLD {fold+1}/{n_splits}] best_val_acc={res.best_val_acc:.4f}")

    return CrossValResult(
        fold_results=results,
        fold_accuracies=accs,
        fold_evaluations=evals,
        mean_accuracy=float(np.mean(accs)),
        std_accuracy=float(np.std(accs)),
    )
