"""Checkpointing: the reference `.npz` schema plus full training state.

Port of `cadx_tpu/checkpoint.py` (orbax is not ported). The reference
persists a model as an `.npz` of a JSON `config` string and per-layer
`W{i}/b{i}` arrays indexed by its interleaved [conv, pool, ..., dense...,
output] layer list (Classes/CNNModel.py:530-555, load at :30-60). The
port reads and writes that exact schema, so a file written by either
package loads in the other.

Layout mapping (reference <- port):
  conv  W{i}: (F, kh, kw, C)  <-  weight (F, C, kh, kw)  [permute 0, 2, 3, 1]
  dense W{i}: (units, prev)   <-  weight (prev, units)   [transpose]
  biases are shared 1-D.

A training state is a tree of dicts, lists, numpy arrays and plain
Python values (tensors are turned into numpy arrays, torch generator
states are uint8 arrays), pickled and replaced atomically, and read back
by an unpickler that resolves only numpy's array reconstructors and
builtin containers.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

import numpy as np
import torch

from cadx_tpu_torch.models.cnn import CNN, CNNConfig


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _mkdirs(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def save_npz(model: CNN, path: str) -> None:
    """Write a reference-schema `.npz` (config JSON + W{i}/b{i})."""
    _mkdirs(path)
    idx = model.config.layer_indices()
    arrays: dict[str, np.ndarray] = {}
    for li, w, b in zip(idx["conv"], model.conv_w, model.conv_b):
        arrays[f"W{li}"] = _np(w).transpose(0, 2, 3, 1)
        arrays[f"b{li}"] = _np(b)
    for li, w, b in zip(idx["dense"], model.dense_w, model.dense_b):
        arrays[f"W{li}"] = _np(w).T
        arrays[f"b{li}"] = _np(b)
    arrays[f"W{idx['output']}"] = _np(model.out_w).T
    arrays[f"b{idx['output']}"] = _np(model.out_b)
    # a file object: np.savez(str) appends ".npz" to a path without it
    with open(path, "wb") as f:
        np.savez(f, config=json.dumps(model.config.to_json_dict()), **arrays)


def load_npz(path: str, device=None) -> tuple[CNNConfig, CNN]:
    """Read a reference-schema `.npz` into (CNNConfig, CNN) on `device`
    (the CPU when None)."""
    def vec(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    try:
        # allow_pickle=False: the schema is a string and numeric arrays;
        # callers pass user-supplied paths
        with np.load(path, allow_pickle=False) as data:
            config = CNNConfig.from_json_dict(json.loads(str(data["config"])))
            idx = config.layer_indices()
            conv = [(vec(data[f"W{li}"].transpose(0, 3, 1, 2)), vec(data[f"b{li}"]))
                    for li in idx["conv"]]
            dense = [(vec(data[f"W{li}"].T), vec(data[f"b{li}"])) for li in idx["dense"]]
            li = idx["output"]
            output = (vec(data[f"W{li}"].T), vec(data[f"b{li}"]))
    except OSError:
        raise  # missing or unreadable: not a format problem
    except Exception as e:  # zip/json/KeyError internals are cryptic
        raise ValueError(
            f"{path!r} is not a readable cnn_model .npz (expected the "
            f"reference schema: a 'config' JSON entry plus W{{i}}/b{{i}} "
            f"arrays for every conv/dense/output layer): "
            f"{type(e).__name__}: {e}") from e
    return config, CNN(config, conv, dense, output).to(device)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def save_train_state(path: str, state: Any) -> None:
    """Persist a training-state tree (tensors become numpy arrays); a
    crash never leaves a torn file."""
    _mkdirs(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(state), f)
    os.replace(tmp, path)


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves only the exact reconstructors a saved state needs: numpy
    array, dtype and scalar rebuilding, and builtin containers. A root of a
    whole module is not safe (numpy holds exec wrappers), so names are
    matched exactly."""

    _SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "complex",
                      "bytearray", "slice"}
    # numpy's reduce functions moved from numpy.core to numpy._core
    _SAFE_EXACT = {
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.numeric", "_frombuffer"),
        ("numpy.core.numeric", "_frombuffer"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.dtypes", None),  # dtype classes (numpy >= 1.25 pickling)
        ("collections", "OrderedDict"),
    }

    def find_class(self, module, name):
        if (module, name) in self._SAFE_EXACT or (module, None) in self._SAFE_EXACT:
            return super().find_class(module, name)
        if module == "builtins" and name in self._SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"train-state checkpoints may not reference {module}.{name}")


def load_train_state(path: str) -> Any:
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()
