"""Batch norm — CUDA kernels and their plain PyTorch versions, for
inference (running statistics) and for training (batch statistics).

**Inference.** Replaces `cadx_tpu/kernels/nn_kernels.py::batchnorm_pallas`
(its `pl.pallas_call` at :153): (x - mean) * rsqrt(var + eps) * scale +
bias, the batch norm after every convolution of the resnets' inference
paths (`models/unet.py::bn_apply`). Source: `csrc/batchnorm.cu`.

Layout: the port runs the resnets channel-first, so the kernel takes a
contiguous NCHW float32 tensor (the Pallas kernel's NHWC blocks were the
TPU's layout). A block's work is sized by elements, not by planes: it
takes 1,024 V consecutive elements of the flat tensor (V float4s a thread,
V = 4, 2 or 1, the most that still gives every SM two blocks), several
whole planes where a plane is small (ResNet-50's layer4: 4 planes of 256
at V = 1) or a chunk of one where it is large, so every thread has work.
The block computes the factors of the planes it spans once, into shared
memory, and each thread issues all its float4 loads (scalars where hw % 4
!= 0 or a pointer is off a 16-byte boundary) before its stores; at V = 1
the loads go out before the factors, so their latencies overlap. Both
versions compute inv = 1 / sqrt(var + eps) with IEEE square root and
division, then ((x - mean) * inv) * scale + bias, each operation rounded
on its own (`--fmad=false`, and the kernel's `__f*_rn` intrinsics), so
they agree bit for bit; JAX's rsqrt form is within 1e-5. Bound: bytes,
the input read once and the output written once (8 bytes an element) at
the card's memory rate (3.35 TB/s on an H100 SXM); e.g. the ResNet-50
stem's (1, 64, 256, 256) cannot take less than 10 us. `batchnorm` records
no autograd graph: a CUDA call with autograd recording raises instead of
returning a tensor cut from the graph.

**Training** (`batchnorm_train`, a `torch.autograd.Function`) replaces no
TPU kernel: the JAX package trains no network with batch norms. The
forward takes each channel's mean and biased variance over (B, H, W),
normalises with them, x_hat = (x - mean) * invstd, invstd = 1 / sqrt(var
+ eps), y = x_hat * weight + bias, optionally max(y, 0) (the ReLU after it,
fused), and updates the running mean and the running unbiased variance in
place with the momentum, and num_batches_tracked, as `nn.BatchNorm2d`
does. The backward gives dbias = sum g, dweight = sum g x_hat and dx =
((g - dbias / n) - x_hat (dweight / n)) (weight invstd), g being dy
masked by the ReLU where it is fused (the mask recomputed from x). Three
launches each way (`csrc/batchnorm.cu`):

- a reduction: block (s, c) of a (S, C) grid takes the s-th of S equal
  runs of channel c's n = B H W elements (S = ceil(n / 16,384)), so one
  design serves ResNet-50's stem at 1152x896, B=16 (64 channels of 4.1 M
  elements, 252 blocks each) and its layer4 (2,048 channels of 16 k, one
  block each); a thread keeps four float4 loads in flight. The forward's
  are Chan, Golub and LeVeque's pairwise moments (count, mean, sum of
  squared deviations), no E[x^2] - E[x]^2; the backward's the two sums;
- a warp a channel merges the S partials in double and writes the
  channel's factors (and the running statistics, dweight and dbias);
- the elementwise pass, laid out as the inference kernel's.

Every elementwise operation is one separately rounded IEEE float32
operation in the plain version's order, so given the same statistics
the elementwise parts agree bit for bit; the statistics and the sums agree
within float32 rounding of their reductions (`tests/test_torch_cuda.py`).
Bound: bytes, each input read once and each output written once: 8 bytes
an element forward (x in, y out), 12 backward (dy and x in, dx out), at
3.35 TB/s. The design moves 12 and 20 (the reduction reads its inputs
once more), so it cannot pass 67% and 60% of that bound. Nothing falls
back: a CUDA tensor launches the kernels or raises, a CPU tensor takes the
plain version. Momentum and eps are BatchNorm2d's defaults, 0.1 and 1e-5
(`MOMENTUM`, `EPS`), the only ones the port trains with.
`count("bn_train_kernel")` counts a pass launched: a forward at its
launch, and the backwards launched inside `backward_counted()` when it
closes, on the caller's thread where the spans are open (autograd runs a
CUDA backward on a thread of its own).
"""

from __future__ import annotations

import contextlib

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.utils.profiling import count

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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

MOMENTUM = 0.1
EPS = 1e-5
SPLIT_ELEMS = 16384   # a reduction block's share of a channel's elements


def splits(n: int) -> int:
    """Reduction blocks a channel of n elements is split over."""
    return max(1, -(-n // SPLIT_ELEMS))


def batchnorm_train_stats_reference(x: torch.Tensor):
    """Plain version of the statistics: (mean, biased var, invstd) of each
    channel of x (B, C, H, W), invstd = 1 / sqrt(var + EPS)."""
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    return mean, var, torch.reciprocal(torch.sqrt(var + EPS))


def batchnorm_train_apply_reference(x: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
                                    weight: torch.Tensor, bias: torch.Tensor,
                                    relu: bool = False) -> torch.Tensor:
    """Plain version of the forward's elementwise pass, given the
    statistics: ((x - mean) * invstd) * weight + bias, then max(., 0)."""
    shape = (-1, 1, 1)
    y = ((x - mean.view(shape)) * invstd.view(shape)) * weight.view(shape) + bias.view(shape)
    return torch.where(y > 0, y, torch.zeros((), device=y.device)) if relu else y


def batchnorm_train_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              running_mean: torch.Tensor, running_var: torch.Tensor,
                              num_batches_tracked: torch.Tensor, relu: bool = False):
    """Plain version of the training forward: (y, mean, invstd); the
    running statistics (the unbiased variance) and num_batches_tracked are
    updated in place."""
    n = x.numel() // x.shape[1]
    if n < 2:
        raise ValueError("batchnorm_train: a channel needs more than one value")
    mean, var, invstd = batchnorm_train_stats_reference(x)
    with torch.no_grad():
        running_mean.copy_(running_mean * (1 - MOMENTUM) + mean * MOMENTUM)
        running_var.copy_(running_var * (1 - MOMENTUM) + var * (n / (n - 1)) * MOMENTUM)
        num_batches_tracked.add_(1)
    return batchnorm_train_apply_reference(x, mean, invstd, weight, bias, relu), mean, invstd


def _masked(dy, x, mean, invstd, weight, bias, relu):
    """(x_hat, g): g is dy where the fused ReLU passed its input, else 0."""
    shape = (-1, 1, 1)
    xh = (x - mean.view(shape)) * invstd.view(shape)
    if relu:
        y = xh * weight.view(shape) + bias.view(shape)
        dy = torch.where(y > 0, dy, torch.zeros((), device=dy.device))
    return xh, dy


def batchnorm_train_dx_reference(dy, x, mean, invstd, weight, bias, dweight, dbias,
                                 relu: bool = False) -> torch.Tensor:
    """Plain version of the backward's elementwise pass, given the sums:
    ((g - dbias / n) - x_hat * (dweight / n)) * (weight * invstd), each a
    separately rounded float32 operation (the divisor a tensor: PyTorch's
    CUDA division by a scalar multiplies by its reciprocal)."""
    shape = (-1, 1, 1)
    n = torch.full((), x.numel() // x.shape[1], dtype=torch.float32, device=x.device)
    xh, g = _masked(dy, x, mean, invstd, weight, bias, relu)
    mdy, mdyx, scale = dbias / n, dweight / n, weight * invstd
    return ((g - mdy.view(shape)) - xh * mdyx.view(shape)) * scale.view(shape)


def batchnorm_train_backward_reference(dy, x, mean, invstd, weight, bias, relu: bool = False):
    """Plain version of the training backward: (dx, dweight, dbias)."""
    xh, g = _masked(dy, x, mean, invstd, weight, bias, relu)
    dbias, dweight = g.sum(dim=(0, 2, 3)), (g * xh).sum(dim=(0, 2, 3))
    return (batchnorm_train_dx_reference(dy, x, mean, invstd, weight, bias, dweight, dbias,
                                         relu), dweight, dbias)


def _check_train(x: torch.Tensor, name: str, vectors) -> None:
    _build.check_input(x, torch.float32, name, ndim=4)
    c = x.shape[1]
    for vname, v in vectors:
        _build.check_input(v, torch.float32, f"{name} {vname}", ndim=1)
        if v.shape[0] != c or v.device != x.device:
            raise ValueError(f"{name}: {vname} must be ({c},) on {x.device}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if x.numel() // max(c, 1) < 2:
        raise ValueError(f"{name}: a channel needs more than one value")


def batchnorm_train_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            running_mean: torch.Tensor, running_var: torch.Tensor,
                            num_batches_tracked: torch.Tensor, relu: bool = False):
    """(y, mean, invstd) of the training forward over x (B, C, H, W)
    float32, the running statistics updated in place. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernels, counting
    `bn_train_kernel`, or raises."""
    if x.device.type == "cpu":
        return batchnorm_train_reference(x, weight, bias, running_mean, running_var,
                                         num_batches_tracked, relu)
    _check_train(x, "batchnorm_train", (("weight", weight), ("bias", bias),
                                        ("running_mean", running_mean),
                                        ("running_var", running_var)))
    if (num_batches_tracked.dtype != torch.int64 or num_batches_tracked.numel() != 1
            or num_batches_tracked.device != x.device):
        raise ValueError("batchnorm_train: num_batches_tracked must be one int64 on "
                         f"{x.device}")
    b, c, h, w = x.shape
    s = splits(b * h * w)
    out = torch.empty_like(x)
    mean = torch.empty(c, device=x.device)
    invstd = torch.empty(c, device=x.device)
    part = torch.empty((c, s, 2), device=x.device)
    lib = _build.load()
    rc = lib.cadx_batchnorm_train(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                  running_mean.data_ptr(), running_var.data_ptr(),
                                  num_batches_tracked.data_ptr(),
                                  mean.data_ptr(), invstd.data_ptr(), part.data_ptr(),
                                  out.data_ptr(), b, c, h, w, s, int(relu),
                                  _build.stream_ptr(x.device))
    _build.check(rc, "cadx_batchnorm_train")
    batchnorm_train_forward.launches += 1
    count("bn_train_kernel")
    return out, mean, invstd


def batchnorm_train_backward(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                             invstd: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             relu: bool = False):
    """(dx, dweight, dbias) of the training forward that gave (mean,
    invstd). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernels or raises (`backward_counted` counts the launches)."""
    if x.device.type == "cpu":
        return batchnorm_train_backward_reference(dy, x, mean, invstd, weight, bias, relu)
    _check_train(x, "batchnorm_train_backward", (("mean", mean), ("invstd", invstd),
                                                 ("weight", weight), ("bias", bias)))
    _build.check_input(dy, torch.float32, "batchnorm_train_backward dy", ndim=4)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"batchnorm_train_backward: dy {tuple(dy.shape)} on {dy.device} "
                         f"against x {tuple(x.shape)} on {x.device}")
    b, c, h, w = x.shape
    s = splits(b * h * w)
    dx = torch.empty_like(x)
    dweight = torch.empty(c, device=x.device)
    dbias = torch.empty(c, device=x.device)
    part = torch.empty((c, s, 2), device=x.device)
    fac = torch.empty((3, c), device=x.device)
    lib = _build.load()
    rc = lib.cadx_batchnorm_train_backward(dy.data_ptr(), x.data_ptr(), weight.data_ptr(),
                                           bias.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                                           part.data_ptr(), fac.data_ptr(), dweight.data_ptr(),
                                           dbias.data_ptr(), dx.data_ptr(), b, c, h, w, s,
                                           int(relu), _build.stream_ptr(x.device))
    _build.check(rc, "cadx_batchnorm_train_backward")
    batchnorm_train_backward.launches += 1
    return dx, dweight, dbias


batchnorm_train_forward.launches = 0
batchnorm_train_backward.launches = 0


@contextlib.contextmanager
def backward_counted():
    """Counts `bn_train_kernel` once for each training backward launched
    inside, when it closes: on the caller's thread, inside the spans it
    opened, which autograd's own thread for a CUDA backward does not see."""
    before = batchnorm_train_backward.launches
    try:
        yield
    finally:
        launched = batchnorm_train_backward.launches - before
        if launched:
            count("bn_train_kernel", launched)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                relu: bool):
        y, mean, invstd = batchnorm_train_forward(x, weight, bias, running_mean, running_var,
                                                  num_batches_tracked, relu)
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        dx, dweight, dbias = batchnorm_train_backward(dy.contiguous(), x, mean, invstd, weight,
                                                      bias, ctx.relu)
        return dx, dweight, dbias, None, None, None, None


def batchnorm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    num_batches_tracked: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """Training batch norm of x (B, C, H, W) float32 with its batch's
    statistics, differentiable in x, weight and bias; max(., 0) after it
    where `relu`. The running statistics and num_batches_tracked are
    updated in place."""
    return _BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                 num_batches_tracked, relu)
