"""Training history and summary JSON in the reference's schemas.

The port's own copy of `cadx_tpu/train/summary.py`, with the schemas of
the artifacts the reference web UI reads:
- training_History_*.json: a JSON list (nested once in a list) of
  {"epoch", "loss", "val_acc"} rows;
- training_summary_*.json: {"dataset", "model", "training",
  "evaluation", "label_encoder", "Training Time"} blocks
  (WebApplicationPrototype/static/trained_model/training_summary_advanced.json).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

from cadx_tpu_torch.models.cnn import CNNConfig
from cadx_tpu_torch.train.metrics import evaluation_block


def format_train_time(seconds: float) -> str:
    """HH:MM:SS like the reference's "Training Time" field."""
    s = int(round(seconds))
    return f"{s // 3600:02d}:{s % 3600 // 60:02d}:{s % 60:02d}"


def write_history(history: Sequence[dict], path: str) -> None:
    _mkdirs(path)
    with open(path, "w") as f:
        json.dump([list(history)], f)  # the reference file nests the list once


def load_history(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    # both the nested ([[...]]) and the flat ([...]) form
    if data and isinstance(data[0], list):
        return data[0]
    return data


def build_summary(
    *,
    config: CNNConfig,
    num_samples: int,
    train_split: int,
    test_split: int,
    epochs: int,
    batch_size: int,
    learning_rate: float,
    device: str,
    best_val_acc: float,
    y_true,
    y_pred,
    label_encoder: dict[str, int],
    train_seconds: float,
    architecture: str = "CNNModel",
) -> dict:
    """The six blocks; `device` is the torch device type ("cuda", "cpu")."""
    return {
        "dataset": {
            "num_samples": num_samples,
            "num_classes": config.num_classes,
            "train_split": train_split,
            "test_split": test_split,
            "input_shape": list(config.input_shape),
        },
        "model": {
            "architecture": architecture,
            "conv_layers": [list(c) for c in config.conv_layers],
            "hidden_units": list(config.hidden_units),
            "dropout_rate": config.dropout_rate,
            # an extension of the reference block: without it a
            # non-default alpha reloads as 0.01
            "leaky_alpha": config.leaky_alpha,
        },
        "training": {
            "epochs": epochs,
            "batch_size": batch_size,
            "learning_rate": learning_rate,
            "device": device,
            "best_val_acc": best_val_acc,
        },
        "evaluation": evaluation_block(y_true, y_pred, config.num_classes),
        "label_encoder": dict(label_encoder),
        "Training Time": format_train_time(train_seconds),
    }


def write_summary(summary: dict, path: str) -> None:
    _mkdirs(path)
    with open(path, "w") as f:
        json.dump(summary, f, indent=4)


def load_summary(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config_from_summary(summary: dict) -> CNNConfig:
    """A CNNConfig from a summary JSON (reference load_trained_model,
    ADCNNM.py:155-188, reads dataset.input_shape and model.* the same way)."""
    return CNNConfig(
        input_shape=tuple(summary["dataset"]["input_shape"]),
        num_classes=int(summary["dataset"]["num_classes"]),
        conv_layers=tuple(tuple(c) for c in summary["model"]["conv_layers"]),
        hidden_units=tuple(summary["model"]["hidden_units"]),
        dropout_rate=float(summary["model"]["dropout_rate"]),
        leaky_alpha=float(summary["model"].get("leaky_alpha", 0.01)),
    )


def _mkdirs(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
