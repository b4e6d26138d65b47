"""Fused k x k convolution + bias + LeakyReLU — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/nn_kernels.py::conv2d_leaky_pallas` (its
`pl.pallas_call` at :63), the classifier's conv blocks. Source:
`csrc/conv_leaky.cu`.

Contract: x (B, C, H, W), w (F, C, k, k), b (F,), float32 (the wrapper
casts, as the TPU kernel does); the output is NCHW float32, bias and
LeakyReLU fused, z == 0 taking the alpha branch. Float32 FMAs on the CUDA
cores, no TF32 and no tensor cores: the contract is float32, as HIGHEST is
in the TPU kernel.

Design: a direct implicit GEMM, M = B*OH*OW pixels by N = F filters over
K = C*k*k. A thread holds 8 consecutive pixels of a row by 8 filters in
registers (64 accumulators), fed per (channel, kernel row) by the 8 + k - 1
input values of its row, slid across the taps, and per tap by two float4
weight loads: a shared word loaded serves 12-19 FMAs at k = 3. A block
covers 32 pixels by PY rows by BN filters (BN the smallest of 32, 64 and
128 that holds F; PY halved where the taller tile gives fewer than two
blocks an SM), so a layer of F <= 128 stages its input once. The input
window and the weights of a few channels go by cp.async into a ring of 3
stages of dynamic shared memory, one barrier a stage; the kernel stages
the (F, C, k, k) weights transposed, K-major with F contiguous, so no
weight copy is made either. x is read in place in either layout the port gives: NCHW contiguous (the
pool's output) or the channels-last view of NHWC features that
`models/cnn.py::conv_stack` hands the first layer; no copy is made. Each
output sums its C*k*k terms in one thread over (channel, kernel row, kernel
column), then adds the bias; the plain version sums in cuDNN's or oneDNN's
order, so the two agree to float32 rounding of <= C*k*k terms. Bound:
2*B*OH*OW*F*C*k*k operations at the card's float32 peak (67 TFLOP/s on an
H100 SXM); e.g. the advanced classifier's first layer at B=32 (77.3 GFLOP)
cannot take less than 1.15 ms, the basic one's at B=64 (8.49 GFLOP) 0.127.

The bfloat16 form (`conv_leaky_bf16`, source `csrc/conv_leaky_bf16.cu`):
the classifiers' opt-in mixed precision (`models/cnn.py::conv_stack(...,
compute_dtype=torch.bfloat16)`, JAX's `compute_dtype=jnp.bfloat16`). x and
w bfloat16, b float32; the products on the tensor cores (mma.sync
m16n8k16, bf16 operands, float32 accumulators) over an implicit GEMM in
persistent blocks, one an SM, that stage their filters' weights once and
walk output tiles of 256 or 512 pixels by 32 or 64 filters, the halo
windows of the next steps copied ahead by TMA into a ring in shared memory
and each output tile written by one TMA store (the design and its reasons
in the source's note); the epilogue repeats JAX's rounding order: the
sum rounded to bf16 (XLA's conv result type), plus the float32 bias,
rounded to bf16, then LeakyReLU in bf16 with alpha rounded to bf16. The
output is NCHW bfloat16. Its plain version is `F.conv2d` on the bf16
tensors followed by the same epilogue; the two differ only where the sums,
taken in another order, round to neighbouring bf16 values. Bound: the
larger of 2*B*OH*OW*F*C*k*k operations at the card's dense bf16 rate (989
TFLOP/s on an H100 SXM) and the bytes of x, w, b in and the output out at
its memory rate; at the advanced classifier's first layer at B=32 the
bytes bound it (268 MB in, 134 MB out: 0.12 ms).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.precision import full_fp32

SOURCE = "cadx_tpu_torch/csrc/conv_leaky.cu"
BF16_SOURCE = "cadx_tpu_torch/csrc/conv_leaky_bf16.cu"
REPLACES = "cadx_tpu/kernels/nn_kernels.py:63"


def conv_leaky_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         alpha: float = 0.01, pad: int = 0) -> torch.Tensor:
    """Plain version: F.conv2d with TF32 off, then where(z > 0, z, alpha z)."""
    with full_fp32():
        z = F.conv2d(x.to(torch.float32), w.to(torch.float32),
                     b.to(torch.float32), padding=pad)
    return torch.where(z > 0, z, alpha * z)


def _layout(x: torch.Tensor) -> int:
    """0 for NCHW contiguous, 1 for the channels-last (NHWC) view; raises
    on any other stride pattern. A size-1 dimension's stride is free."""
    bsz, c, h, w = x.shape
    for layout, strides in ((0, (c * h * w, h * w, w, 1)), (1, (h * w * c, 1, w * c, c))):
        if all(n == 1 or s == t for n, s, t in zip(x.shape, x.stride(), strides)):
            return layout
    raise ValueError(f"conv_leaky: x must be NCHW contiguous or the NHWC view, got "
                     f"strides {x.stride()} for shape {tuple(x.shape)}")


def conv_leaky(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               alpha: float = 0.01, pad: int = 0) -> torch.Tensor:
    """x (B, C, H, W), w (F, C, k, k), b (F,) -> (B, F, H + 2 pad - k + 1,
    W + 2 pad - k + 1) float32, zeros padded `pad` on each side. x may be
    NCHW contiguous or the NHWC view (`t.permute(0, 3, 1, 2)` of a
    contiguous (B, H, W, C) t), read in place. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return conv_leaky_reference(x, w, b, alpha, pad)
    if x.device.type != "cuda" or w.device != x.device or b.device != x.device:
        raise ValueError(f"conv_leaky: expected CUDA tensors on one device, got "
                         f"{x.device}, {w.device}, {b.device}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[1] != x.shape[1] or (
            w.shape[2] != w.shape[3]) or tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"conv_leaky: expected x (B, C, H, W), w (F, C, k, k), "
                         f"b (F,), got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    x = x.to(torch.float32)
    layout = _layout(x)
    w = w.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
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
                                 out.data_ptr(), bsz, c, h, wd, f, k, pad, layout,
                                 float(alpha), _build.stream_ptr(x.device))
        _build.check(rc, "cadx_conv_leaky")
        conv_leaky.launches += 1
    return out


conv_leaky.launches = 0


def leaky_bf16(v: torch.Tensor, alpha: float) -> torch.Tensor:
    """where(v > 0, v, alpha v) in bfloat16, alpha rounded to bf16 first (a
    Python float meets a bf16 array in JAX as a bf16 scalar) and the
    product rounded once."""
    return torch.where(v > 0, v, v * torch.tensor(alpha, dtype=torch.bfloat16))


def conv_leaky_bf16_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                              alpha: float = 0.01, pad: int = 0) -> torch.Tensor:
    """Plain version: F.conv2d on bf16 x and w (a bf16 result), plus the
    float32 bias rounded to bf16, then the bf16 LeakyReLU."""
    z = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), padding=pad)
    v = (z.to(torch.float32) + b.to(torch.float32)[:, None, None]).to(torch.bfloat16)
    return leaky_bf16(v, alpha)


def conv_leaky_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    alpha: float = 0.01, pad: int = 0) -> torch.Tensor:
    """The bfloat16 form: x (B, C, H, W) and w (F, C, k, k) bfloat16, b (F,)
    float32 -> (B, F, OH, OW) bfloat16. x may be NCHW contiguous or the
    NHWC view, read in place. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return conv_leaky_bf16_reference(x, w, b, alpha, pad)
    if x.device.type != "cuda" or w.device != x.device or b.device != x.device:
        raise ValueError(f"conv_leaky_bf16: expected CUDA tensors on one device, got "
                         f"{x.device}, {w.device}, {b.device}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[1] != x.shape[1] or (
            w.shape[2] != w.shape[3]) or tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"conv_leaky_bf16: expected x (B, C, H, W), w (F, C, k, k), "
                         f"b (F,), got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"conv_leaky_bf16: expected bfloat16 x and w, got {x.dtype}, "
                         f"{w.dtype}")
    layout = _layout(x)
    bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    oh, ow = h + 2 * pad - k + 1, wd + 2 * pad - k + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv_leaky_bf16: a {k}x{k} kernel with pad {pad} leaves no "
                         f"output of a {h}x{wd} input")
    # (k, k, F, C8): channels zero-padded to a multiple of 8, whole 16-byte
    # copies for the kernel
    wt = (F.pad(w, (0, 0, 0, 0, 0, -c % 8)) if c % 8 else w).permute(2, 3, 0, 1).contiguous()
    b = b.to(torch.float32).contiguous()
    out = torch.empty((bsz, f, oh, ow), dtype=torch.bfloat16, device=x.device)
    if out.numel():
        rc = _build.load().cadx_conv_leaky_bf16(
            x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, c, h, wd, f, k,
            pad, layout, float(alpha), _build.stream_ptr(x.device))
        _build.check(rc, "cadx_conv_leaky_bf16")
        conv_leaky_bf16.launches += 1
    return out


conv_leaky_bf16.launches = 0
