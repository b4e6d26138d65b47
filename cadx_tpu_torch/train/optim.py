"""Optimizers of the reference's two trainers.

Port of `cadx_tpu/train/optim.py`:
- "basic": SGD on batch-averaged gradients, each tensor clipped by its
  own norm at 5.0, lr x0.98 per epoch (Classes/CNNModel.py:372-394, :504);
- "advanced": Adam(lr=1e-3), b1 0.9, b2 0.999, eps 1e-8 (ADCNNM.py:86-107),
  in optax's order of operations, so a step from the same state matches
  the JAX package's to float32 rounding.

Both update the parameters in place, under `torch.no_grad`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cadx_tpu_torch.utils.tree import clip_grads_per_leaf


def sgd_reference_update(params, grads, lr: float, max_norm: float = 5.0) -> None:
    """Reference `_apply_grads`: per-tensor clip at max_norm, then
    p - lr * g (lr enters the float32 product rounded to float32, as JAX
    passes it)."""
    with torch.no_grad():
        for p, g in zip(params, clip_grads_per_leaf(grads, max_norm)):
            p.sub_(lr * g)


def decayed_lr(base_lr: float, epoch, decay: float = 0.98):
    """lr after `epoch` epochs of x`decay` (reference: lr *= 0.98 per epoch)."""
    return base_lr * (decay ** epoch)


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the step count and the first and second
    moments, one tensor per parameter, in `parameters()` order."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        params = list(params)
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def _bias_correction(self, decay: float, count: int, device) -> torch.Tensor:
        # 1 - decay**count in float32, a device tensor: CUDA turns division
        # by a Python scalar into a product with its reciprocal
        value = np.float32(1) - np.float32(decay) ** np.float32(count)
        return torch.full((), float(value), device=device)

    def step(self, params, grads, state: AdamState) -> AdamState:
        """One update in place: mu, nu, mu / (1 - b1^t), nu / (1 - b2^t),
        then p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)."""
        count = state.count + 1
        with torch.no_grad():
            for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
                mu.mul_(self.b1).add_((1 - self.b1) * g)
                nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
                mu_hat = mu / self._bias_correction(self.b1, count, mu.device)
                nu_hat = nu / self._bias_correction(self.b2, count, nu.device)
                p.add_(-self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)))
        return AdamState(count, state.mu, state.nu)


def adam(lr: float = 1e-3) -> Adam:
    """The advanced trainer's optimizer (torch.optim.Adam defaults)."""
    return Adam(lr=lr, b1=0.9, b2=0.999, eps=1e-8)
