"""Evaluation metrics.

Port of `cadx_tpu/train/metrics.py`: the confusion matrix, accuracy, and
the sklearn-shaped classification report the reference persists into
`training_summary_*.json` (training_summary_advanced.json:38-77,
CNNM.py:627-652). Precision, recall and F1 are computed in float32 with
the JAX package's formulas, so the report matches its values exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def _labels(y_true, y_pred) -> tuple[torch.Tensor, torch.Tensor]:
    """Both label vectors as int64 tensors on y_true's device."""
    t, p = (y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
            for y in (y_true, y_pred))
    return t.to(torch.int64), p.to(device=t.device, dtype=torch.int64)


def confusion_matrix(y_true, y_pred, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int32 counts; rows = true class, cols =
    predicted. Labels outside [0, num_classes) are not counted (their
    one-hot rows are zero in JAX)."""
    t, p = _labels(y_true, y_pred)
    ok = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    counts = torch.bincount((t * num_classes + p)[ok], minlength=num_classes ** 2)
    return counts.reshape(num_classes, num_classes).to(torch.int32)


def accuracy(y_true, y_pred) -> torch.Tensor:
    t, p = _labels(y_true, y_pred)
    return (t == p).to(torch.float32).mean()


def precision_recall_f1(cm: torch.Tensor):
    """Per-class precision, recall, F1 and support (float32)."""
    cm = cm.to(torch.float32)
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)
    pred_count = cm.sum(dim=0)
    zero = torch.zeros((), device=cm.device)
    precision = torch.where(pred_count > 0, tp / torch.clamp_min(pred_count, 1), zero)
    recall = torch.where(support > 0, tp / torch.clamp_min(support, 1), zero)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall / torch.clamp_min(denom, 1e-30),
                     zero)
    return precision, recall, f1, support


def classification_report(y_true, y_pred, num_classes: int) -> dict:
    """sklearn-shaped report dict: per class, accuracy, macro and weighted
    averages."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    p, r, f, s = (v.cpu().numpy().astype(np.float64) for v in precision_recall_f1(cm))
    total = float(s.sum())
    report: dict = {}
    for c in range(num_classes):
        report[str(c)] = {
            "precision": float(p[c]),
            "recall": float(r[c]),
            "f1-score": float(f[c]),
            "support": int(s[c]),
        }
    report["accuracy"] = float(accuracy(y_true, y_pred))
    report["macro avg"] = {
        "precision": float(p.mean()),
        "recall": float(r.mean()),
        "f1-score": float(f.mean()),
        "support": int(total),
    }
    w = s / max(total, 1.0)
    report["weighted avg"] = {
        "precision": float((p * w).sum()),
        "recall": float((r * w).sum()),
        "f1-score": float((f * w).sum()),
        "support": int(total),
    }
    return report


def evaluation_block(y_true, y_pred, num_classes: int) -> dict:
    """The reference summary JSON's `evaluation` block."""
    return {
        "test_accuracy": float(accuracy(y_true, y_pred)),
        "confusion_matrix": confusion_matrix(y_true, y_pred, num_classes).tolist(),
        "classification_report": classification_report(y_true, y_pred, num_classes),
    }
