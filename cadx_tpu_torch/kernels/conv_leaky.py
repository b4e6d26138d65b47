"""Fused k x k convolution + bias + LeakyReLU — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/nn_kernels.py::conv2d_leaky_pallas` (its
`pl.pallas_call` at :63), the classifier's conv blocks. Source:
`csrc/conv_leaky.cu`.

Layout: the port's, x (B, C, H, W) and w (F, C, k, k), float32 (the
wrapper casts, as the TPU kernel does). A block of 256 threads computes a
16x16 output tile for 16 filters, one pixel and 16 accumulators a thread;
it stages 8 input channels at a time of the (16 + k - 1)^2 input window in
shared memory, zero outside the image (that is the SAME padding, so no
padded copy is made), and the weights of its filters laid out [channel]
[tap][filter], so one float4 broadcast load feeds four FMAs. Float32 FMAs
on the CUDA cores, no TF32 and no tensor cores: the contract is float32,
as HIGHEST is in the TPU kernel. The sums run over (channel, tap) in
order, then the bias is added; the plain version sums in cuDNN's or
oneDNN's order, so the two agree to float32 rounding of <= C*k*k terms.
Bound: 2*B*OH*OW*F*C*k*k operations at the card's float32 peak (67
TFLOP/s on an H100 SXM); e.g. the advanced classifier's first layer at
B=32 (77.3 GFLOP) cannot take less than 1.15 ms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.precision import full_fp32

SOURCE = "cadx_tpu_torch/csrc/conv_leaky.cu"
REPLACES = "cadx_tpu/kernels/nn_kernels.py:63"


def conv_leaky_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         alpha: float = 0.01, pad: int = 0) -> torch.Tensor:
    """Plain version: F.conv2d with TF32 off, then where(z > 0, z, alpha z)."""
    with full_fp32():
        z = F.conv2d(x.to(torch.float32), w.to(torch.float32),
                     b.to(torch.float32), padding=pad)
    return torch.where(z > 0, z, alpha * z)


def conv_leaky(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               alpha: float = 0.01, pad: int = 0) -> torch.Tensor:
    """x (B, C, H, W), w (F, C, k, k), b (F,) -> (B, F, H + 2 pad - k + 1,
    W + 2 pad - k + 1) float32, zeros padded `pad` on each side. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if x.device.type == "cpu":
        return conv_leaky_reference(x, w, b, alpha, pad)
    if x.device.type != "cuda" or w.device != x.device or b.device != x.device:
        raise ValueError(f"conv_leaky: expected CUDA tensors on one device, got "
                         f"{x.device}, {w.device}, {b.device}")
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    if x.ndim != 4 or w.ndim != 4 or w.shape[1] != x.shape[1] or (
            w.shape[2] != w.shape[3]) or tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"conv_leaky: expected x (B, C, H, W), w (F, C, k, k), "
                         f"b (F,), got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    oh, ow = h + 2 * pad - k + 1, wd + 2 * pad - k + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv_leaky: a {k}x{k} kernel with pad {pad} leaves no "
                         f"output of a {h}x{wd} input")
    out = torch.empty((bsz, f, oh, ow), dtype=torch.float32, device=x.device)
    if out.numel():
        lib = _build.load()
        rc = lib.cadx_conv_leaky(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), bsz, c, h, wd, f, k, pad,
                                 float(alpha), _build.stream_ptr(x.device))
        _build.check(rc, "cadx_conv_leaky")
        conv_leaky.launches += 1
    return out


conv_leaky.launches = 0
