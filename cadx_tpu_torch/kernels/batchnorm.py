"""Inference batch norm — CUDA kernel and its plain PyTorch version.

Replaces `cadx_tpu/kernels/nn_kernels.py::batchnorm_pallas` (its
`pl.pallas_call` at :153): (x - mean) * rsqrt(var + eps) * scale + bias,
the batch norm after every convolution of the resnets
(`models/unet.py::bn_apply`). Source: `csrc/batchnorm.cu`.

Layout: the port runs the resnets channel-first, so the kernel takes a
contiguous NCHW float32 tensor (the Pallas kernel's NHWC blocks were the
TPU's layout). A block takes one chunk of 1,024 elements of one (image,
channel) plane and computes that channel's factor once; its threads read
and write float4s, neighbouring threads on neighbouring addresses. Both
versions compute inv = 1 / sqrt(var + eps) with IEEE square root and
division, then ((x - mean) * inv) * scale + bias, each operation rounded
on its own (`--fmad=false`, and the kernel's `__f*_rn` intrinsics), so
they agree bit for bit; JAX's rsqrt form is within 1e-5. Bound: bytes,
the input read once and the output written once (8 bytes an element) at
the card's memory rate (3.35 TB/s on an H100 SXM); e.g. the ResNet-50
stem's (1, 64, 256, 256) cannot take less than 10 us.

Inference only: the kernel has no backward, so a CUDA call with autograd
recording raises instead of returning a tensor cut from the graph.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build

SOURCE = "cadx_tpu_torch/csrc/batchnorm.cu"
REPLACES = "cadx_tpu/kernels/nn_kernels.py:153"


def batchnorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        mean: torch.Tensor, var: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain version: x (B, C, H, W); the four vectors (C,)."""
    inv = torch.reciprocal(torch.sqrt(var + eps))
    shape = (-1, 1, 1)
    return ((x - mean.view(shape)) * inv.view(shape)) * scale.view(shape) + bias.view(shape)


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(B, C, H, W) float32 -> batch-normalised, same shape. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return batchnorm_reference(x, scale, bias, mean, var, eps)
    _build.check_input(x, torch.float32, "batchnorm", ndim=4)
    c = x.shape[1]
    for name, v in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
        _build.check_input(v, torch.float32, f"batchnorm {name}", ndim=1)
        if v.shape[0] != c or v.device != x.device:
            raise ValueError(f"batchnorm: {name} must be ({c},) on {x.device}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias, mean, var)):
        raise ValueError("batchnorm: the CUDA kernel is inference only; run it under "
                         "torch.no_grad()")
    b, _, h, w = x.shape
    out = torch.empty_like(x)
    if out.numel():
        lib = _build.load()
        rc = lib.cadx_batchnorm(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                mean.data_ptr(), var.data_ptr(), out.data_ptr(), b, c, h, w,
                                eps, _build.stream_ptr(x.device))
        _build.check(rc, "cadx_batchnorm")
        batchnorm.launches += 1
    return out


batchnorm.launches = 0
