"""Advanced-pipeline compat: load the reference's PyTorch checkpoints.

Port of `cadx_tpu/compat/adcnnm.py`, the loader and its inverse, the
exporter. The reference's
"advanced" model is a torch CNN (ADCNNM.py:34-78: Conv2d(padding=1) +
MaxPool2d(2) blocks with LeakyReLU, then a Linear stack) whose best weights
are saved as a state dict (.pth) and rebuilt from the training-summary
JSON (load_trained_model, ADCNNM.py:155-202). Here they become the port's
`models.cnn.CNN`:

- conv weights stay OIHW (the port's layout);
- linear weights (out, in) become (in, out);
- the FIRST linear layer's input is permuted from torch's NCHW flatten
  order (C, H, W) to the port's channel-last flatten (H, W, C).

`torch_state_dict_from_params` and `save_trained_model` go the other way,
so reference-side torch tooling can consume weights the port trained.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from cadx_tpu_torch.models import cnn
from cadx_tpu_torch.train.summary import config_from_summary


def advanced_config_from_summary(summary: dict) -> cnn.CNNConfig:
    """Advanced models use padding=1 convs (ADCNNM.py:48), which equal SAME
    only for 3x3 kernels: other sizes are rejected rather than computing a
    different network."""
    base = config_from_summary(summary)
    bad = [k for _, k in base.conv_layers if k != 3]
    if bad:
        raise ValueError(f"torch-compat import supports 3x3 convs only (padding=1 == "
                         f"SAME); got kernel sizes {bad}")
    return dataclasses.replace(base, conv_padding="SAME")


def _flatten_hwc(config: cnn.CNNConfig) -> tuple[int, int, int]:
    """(h, w, c) after the last pool, from the config's own shape walk."""
    h, w, f = config.conv_output_shapes()[-1]
    return h // 2, w // 2, f


def params_from_torch_state_dict(state_dict: dict, config: cnn.CNNConfig,
                                 device=None) -> cnn.CNN:
    """An ADCNNM-layout torch state dict -> the port's CNN on `device`."""
    def arr(v) -> np.ndarray:
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                          np.float32)

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    conv = [(tensor(arr(state_dict[f"convs.{i}.weight"])),
             tensor(arr(state_dict[f"convs.{i}.bias"])))
            for i in range(len(config.conv_layers))]
    # nn.Sequential indices of the fc stack: a Linear at 0, 3, 6, ..., then the output
    linear_keys = sorted({int(k.split(".")[1]) for k in state_dict
                          if k.startswith("fc.") and k.endswith(".weight")})
    h, w, c = _flatten_hwc(config)
    dense = []
    for pos, li in enumerate(linear_keys):
        wgt = arr(state_dict[f"fc.{li}.weight"])          # (out, in)
        if pos == 0:
            out_dim = wgt.shape[0]
            wgt = wgt.reshape(out_dim, c, h, w).transpose(0, 2, 3, 1).reshape(out_dim, -1)
        dense.append((tensor(wgt.T), tensor(arr(state_dict[f"fc.{li}.bias"]))))
    return cnn.CNN(config, conv, dense[:-1], dense[-1]).to(device)


def load_trained_model(json_path: str, weight_path: str, device=None):
    """Reference load_trained_model (ADCNNM.py:155-202): rebuild from the
    summary JSON and the .pth state dict. Returns (config, CNN)."""
    with open(json_path) as f:
        config = advanced_config_from_summary(json.load(f))
    state_dict = torch.load(weight_path, map_location="cpu", weights_only=True)
    return config, params_from_torch_state_dict(state_dict, config, device)


def torch_state_dict_from_params(model: cnn.CNN, config: cnn.CNNConfig) -> dict:
    """Inverse of params_from_torch_state_dict: the port's CNN as an
    ADCNNM-layout state dict of CPU float32 tensors (conv OIHW as they are,
    dense transposed to (out, in), the first dense input permuted back to
    torch's NCHW flatten order), fc keys at the nn.Sequential indices 0,
    3, 6, ... (each hidden block is Linear, LeakyReLU, Dropout)."""
    def cpu(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32).contiguous()

    h, w, c = _flatten_hwc(config)
    out: dict = {}
    for i, (wgt, b) in enumerate(zip(model.conv_w, model.conv_b)):
        out[f"convs.{i}.weight"] = cpu(wgt).clone()
        out[f"convs.{i}.bias"] = cpu(b).clone()
    dense = list(zip(model.dense_w, model.dense_b)) + [(model.out_w, model.out_b)]
    for pos, (wgt, b) in enumerate(dense):
        wt = cpu(wgt).T                                   # (out, in), HWC order
        if pos == 0:
            out_dim = wt.shape[0]
            wt = wt.reshape(out_dim, h, w, c).permute(0, 3, 1, 2).reshape(out_dim, c * h * w)
        out[f"fc.{3 * pos}.weight"] = wt.contiguous().clone()
        out[f"fc.{3 * pos}.bias"] = cpu(b).clone()
    return out


def save_trained_model(model: cnn.CNN, config: cnn.CNNConfig, weight_path: str) -> None:
    """torch.save an ADCNNM-compatible state dict of the port's model."""
    torch.save(torch_state_dict_from_params(model, config), weight_path)
