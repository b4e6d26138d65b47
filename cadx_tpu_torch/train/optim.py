"""Optimizers of the reference's two trainers.

Port of `cadx_tpu/train/optim.py`:
- "basic": SGD on batch-averaged gradients, each tensor clipped by its
  own norm at 5.0, lr x0.98 per epoch (Classes/CNNModel.py:372-394, :504);
- "advanced": Adam(lr=1e-3), b1 0.9, b2 0.999, eps 1e-8 (ADCNNM.py:86-107),
  in optax's order of operations, so a step from the same state matches
  the JAX package's to float32 rounding. On the card one kernel launch
  updates every tensor (`kernels/adam.py`), bit-exact to the plain update
  that CPU tensors take.

Both update the parameters in place, under `torch.no_grad`.
"""

from __future__ import annotations

import dataclasses

import torch

from cadx_tpu_torch.kernels.adam import adam_update
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

    def step(self, params, grads, state: AdamState) -> AdamState:
        """One update in place: mu, nu, mu / (1 - b1^t), nu / (1 - b2^t),
        then p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)."""
        count = state.count + 1
        adam_update(params, grads, state.mu, state.nu, count, self.lr, self.b1, self.b2,
                    self.eps)
        return AdamState(count, state.mu, state.nu)


def adam(lr: float = 1e-3) -> Adam:
    """The advanced trainer's optimizer (torch.optim.Adam defaults)."""
    return Adam(lr=lr, b1=0.9, b2=0.999, eps=1e-8)
