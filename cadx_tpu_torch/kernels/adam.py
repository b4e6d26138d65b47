"""Adam's update over all of a model's parameter tensors — CUDA kernel and
its plain PyTorch version.

Replaces no `pallas_call`: the JAX package leaves Adam to optax under
XLA. The plain version is the port's Adam in optax's order of operations,
one tensor at a time, each step in float32 as PyTorch's eager ops round
it:

    mu = mu * b1 + (1 - b1) * g
    nu = nu * b2 + (1 - b2) * (g * g)
    mu_hat = mu / bc1,  nu_hat = nu / bc2        (true divisions)
    p = p + (-lr) * (mu_hat / (sqrt(nu_hat) + eps))

with each Python scalar (b1, 1 - b1, b2, 1 - b2, eps, -lr) rounded to
float32 and the bias corrections bc = 1 - b^t computed in numpy float32
(`bias_correction`). On the card that is some fourteen launches a tensor,
two of them divisions by a device scalar, and 132 bytes an element.
Source: `csrc/adam.cu`, one launch over up to 64 tensors, with the
pointers in its parameters: the same arithmetic with the round-to-nearest
intrinsics and no contraction (`--fmad=false`), so it is bit-exact to the
plain version on the card. mu and nu are updated in place, as p, and the
wrapper bumps the version counters of p, mu and nu as an in-place op of
PyTorch's would: the copies keyed on them (`parallel/data_parallel.py`)
and autograd's check of saved tensors see the step.

Bound: bytes, 28 an element (p, g, mu and nu read once, p, mu and nu
written once): the advanced classifier's 67,179,234 parameters, 1.881 GB,
take at least 0.561 ms at 3.35 TB/s (H100 SXM). The kernel streams 16-byte
vectors, four of each tensor in flight a thread.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.graph import increment_version

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.utils.profiling import count

SOURCE = "cadx_tpu_torch/csrc/adam.cu"
REPLACES = None     # optax's Adam under XLA: no pallas_call


def bias_correction(decay: float, step: int) -> float:
    """1 - decay**step in numpy float32, as a Python float."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(step))


def adam_update_reference(params, grads, mu, nu, step: int, lr: float, b1: float,
                          b2: float, eps: float) -> None:
    """Plain version: the update of step `step` (1 first), one tensor at a
    time. The bias corrections are device scalars, since CUDA turns
    division by a Python scalar into a product with its reciprocal."""
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            m_hat = m / torch.full((), bias_correction(b1, step), device=m.device)
            v_hat = v / torch.full((), bias_correction(b2, step), device=v.device)
            p.add_(-lr * (m_hat / (torch.sqrt(v_hat) + eps)))


def _check_leaf(leaf, device: torch.device) -> None:
    p = leaf[0]
    for name, t in zip(("parameter", "gradient", "mu", "nu"), leaf):
        if t.device != device or t.dtype != torch.float32 or t.shape != p.shape or (
                name != "gradient" and not t.is_contiguous()):
            raise ValueError(f"adam_update: expected a{'' if name == 'gradient' else ' contiguous'}"
                             f" float32 {name} of shape {tuple(p.shape)} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}"
                             f"{'' if t.is_contiguous() else ', not contiguous'}")


def adam_update(params, grads, mu, nu, step: int, lr: float, b1: float, b2: float,
                eps: float) -> None:
    """One Adam update in place over the leaves (params[i], grads[i],
    mu[i], nu[i]). CPU tensors take the plain version; CUDA tensors, all
    float32 on one card, launch the kernel or raise. Parameters and moments
    must be contiguous; a gradient of another layout is copied to the
    parameter's order first."""
    leaves = list(zip(params, grads, mu, nu))
    if not leaves:
        return
    dev = leaves[0][0].device
    if dev.type == "cpu":
        adam_update_reference(params, grads, mu, nu, step, lr, b1, b2, eps)
        return
    if dev.type != "cuda":
        raise ValueError(f"adam_update: expected CUDA tensors, got {dev}")
    for leaf in leaves:
        _check_leaf(leaf, dev)
    # cuDNN's weight gradients come back channels_last where the conv read
    # an NHWC view (the classifier's first layer, the U-Net's convs): the
    # kernel streams every tensor in the parameter's order
    leaves = [(p, g.contiguous(), m, v) for p, g, m, v in leaves]
    k = len(leaves)
    ptrs = [(ctypes.c_void_p * k)(*(leaf[j].data_ptr() for leaf in leaves))
            for j in range(4)]
    sizes = (ctypes.c_longlong * k)(*(leaf[0].numel() for leaf in leaves))
    lib = _build.load()
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.cadx_adam_step(*ptrs, sizes, k, b1, 1 - b1, b2, 1 - b2, eps, -lr,
                                bias_correction(b1, step), bias_correction(b2, step),
                                ctypes.addressof(launches), _build.stream_ptr(dev))
    _build.check(rc, "cadx_adam_step")
    for leaf in leaves:
        increment_version(leaf[0])
        increment_version(leaf[2])
        increment_version(leaf[3])
    adam_update.launches += launches.value
    count("adam_fused_leaves", k)


adam_update.launches = 0
