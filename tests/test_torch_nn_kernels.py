"""Port parity: the conv_leaky, pool and upsample kernels' plain versions
(what their wrappers run on CPU tensors) against the JAX package's Pallas
kernels in interpret mode and its ops, and the autograd backwards of the
port's ops against `jax.vjp`.

Tolerances: the conv 1e-5 (float32 sums in another order, as
tests/test_kernels.py holds the Pallas kernel to lax); pools, upsample,
switches and the pool gradients (ReLU zeros, constant windows, odd
sides) bit-exact; the conv backward 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.kernels import nn_kernels as nk
from cadx_tpu.models import unet as JU
from cadx_tpu.ops import conv as JConv
from cadx_tpu.ops import pool as JPool
from cadx_tpu_torch import convert
from cadx_tpu_torch.kernels import conv_leaky as KCL
from cadx_tpu_torch.kernels import pool as KPool
from cadx_tpu_torch.kernels import upsample as KUp
from cadx_tpu_torch.ops import conv as TConv
from cadx_tpu_torch.ops import pool as TPool

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _nchw(a, dtype="float32") -> torch.Tensor:
    """NHWC numpy -> NCHW torch, rounded to `dtype` as JAX rounds it."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(_TORCH[dtype])


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).permute(0, 2, 3, 1).numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _conv_inputs(rng, b, h, w, c, f, k):
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    x[:, : h // 2, : w // 2, :] = 0.0          # z == 0 where the bias is 0
    wt = (rng.standard_normal((k, k, c, f)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    bias[0] = 0.0
    return x, wt, bias


@pytest.mark.parametrize("b,h,w,c,f,k", [(2, 9, 11, 4, 6, 3), (1, 12, 10, 3, 20, 3),
                                         (2, 8, 7, 2, 3, 1), (1, 11, 9, 5, 17, 5)])
def test_conv_leaky_plain_matches_pallas_and_ops(rng, b, h, w, c, f, k):
    x, wt, bias = _conv_inputs(rng, b, h, w, c, f, k)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias)
    pallas = np.asarray(nk.conv2d_leaky_pallas(jx, jw, jb, 0.01, interpret=True))
    ops = np.asarray(JConv.conv2d_leaky(jx, jw, jb, alpha=0.01, padding="VALID"))
    before = KCL.conv_leaky.launches
    ours = _nhwc(KCL.conv_leaky(_nchw(x), convert.hwio_to_oihw(wt),
                                torch.from_numpy(bias), 0.01, 0))
    assert KCL.conv_leaky.launches == before   # a CPU tensor takes the plain version
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, ops, rtol=0, atol=1e-5)
    # SAME: zero-pad k // 2, then the VALID kernel
    p = k // 2
    padded = jnp.pad(jx, ((0, 0), (p, p), (p, p), (0, 0)))
    pallas_same = np.asarray(nk.conv2d_leaky_pallas(padded, jw, jb, 0.01, interpret=True))
    ops_same = np.asarray(JConv.conv2d_leaky(jx, jw, jb, alpha=0.01, padding=p))
    ours_same = _nhwc(TConv.conv2d_leaky(_nchw(x), convert.hwio_to_oihw(wt),
                                         torch.from_numpy(bias), 0.01, "SAME"))
    np.testing.assert_allclose(ours_same, pallas_same, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours_same, ops_same, rtol=0, atol=1e-5)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv2d_leaky_backward_matches_jax(rng, padding):
    x, wt, bias = _conv_inputs(rng, 2, 10, 9, 3, 5, 3)
    pad = "VALID" if padding == "VALID" else 1
    out, vjp = jax.vjp(lambda a, k_, b_: JConv.conv2d_leaky(a, k_, b_, alpha=0.01,
                                                            padding=pad),
                       jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    g = rng.standard_normal(out.shape).astype(np.float32)
    dx, dw, db = vjp(jnp.asarray(g))
    tx = _nchw(x).requires_grad_(True)
    tw = convert.hwio_to_oihw(wt).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    y = TConv.conv2d_leaky(tx, tw, tb, 0.01, padding)
    np.testing.assert_allclose(_nhwc(y), np.asarray(out), rtol=0, atol=1e-5)
    y.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(dx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw).transpose(3, 2, 0, 1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(db), rtol=0, atol=1e-5)


def test_conv2d_leaky_rejects_bad_arguments():
    x = torch.zeros((1, 2, 5, 5))
    w = torch.zeros((3, 2, 3, 3))
    with pytest.raises(ValueError):
        TConv.conv2d_leaky(x, w, torch.zeros(3), -0.1)
    with pytest.raises(ValueError):
        TConv.conv2d_leaky(x, w, torch.zeros(3), 0.01, "FULL")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("hw", [(12, 12), (7, 11)])
def test_pool_plain_matches_pallas_and_ops(rng, dtype, size, hw):
    x = rng.standard_normal((2,) + hw + (5,)).astype(np.float32)
    x[0, :4, :4, :] = 0.5                      # constant windows
    jx = jnp.asarray(x).astype(_JAX[dtype])
    t = _nchw(x, dtype)
    for mode, pallas_fn, ops_fn in (("max", nk.max_pool_pallas, JPool.max_pool_ties),
                                    ("mean", nk.avg_pool_pallas, JPool.avg_pool)):
        ours = KPool.pool(t, size, mode)
        assert ours.dtype == t.dtype
        assert tuple(ours.shape) == (2, 5, hw[0] // size, hw[1] // size)
        np.testing.assert_array_equal(_nhwc(ours), _f32(pallas_fn(jx, size, interpret=True)))
        np.testing.assert_array_equal(_nhwc(ours), _f32(ops_fn(jx, size)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_plain_matches_pallas_and_ops(rng, dtype, factor):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    jx = jnp.asarray(x).astype(_JAX[dtype])
    ours = KUp.upsample_nearest(_nchw(x, dtype), factor)
    assert ours.dtype == _TORCH[dtype]
    pallas = _f32(nk.upsample_nearest_pallas(jx, factor, interpret=True))
    np.testing.assert_array_equal(_nhwc(ours), pallas)
    np.testing.assert_array_equal(_nhwc(TPool.upsample_nearest(_nchw(x, dtype), factor)),
                                  _f32(JPool.upsample_nearest(jx, factor)))


def _tied(rng, hw):
    """Small integers, so windows tie; ReLU zeros; a constant block."""
    x = np.maximum(rng.integers(-2, 3, (2,) + hw + (3,)), 0).astype(np.float32)
    x[1, :4, :4, :] = 1.0
    return x


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_max_pool_gradients_with_ties(rng, size, hw):
    x = _tied(rng, hw)
    g = rng.standard_normal((2, hw[0] // size, hw[1] // size, 3)).astype(np.float32)
    for port_fn, jax_fn in ((TPool.max_pool_ties, lambda v: JPool.max_pool_ties(v, size)),
                            (TPool.max_pool_first, lambda v: JU._max_pool_plain(v, size))):
        out, vjp = jax.vjp(jax_fn, jnp.asarray(x))
        (ref,) = vjp(jnp.asarray(g))
        t = _nchw(x).requires_grad_(True)
        y = port_fn(t, size)
        np.testing.assert_array_equal(_nhwc(y), np.asarray(out))
        y.backward(_nchw(g))
        np.testing.assert_array_equal(_nhwc(t.grad), np.asarray(ref))
    # the two rules differ exactly where a window ties
    t1, t2 = _nchw(x).requires_grad_(True), _nchw(x).requires_grad_(True)
    TPool.max_pool_ties(t1, size).sum().backward()
    TPool.max_pool_first(t2, size).sum().backward()
    assert float(t1.grad.sum()) > float(t2.grad.sum())


def test_max_pool_first_matches_torch_max_pool(rng):
    x = _nchw(_tied(rng, (8, 10))).requires_grad_(True)
    ref = x.detach().clone().requires_grad_(True)
    TPool.max_pool_first(x, 2).sum().backward()
    torch.nn.functional.max_pool2d(ref, 2).sum().backward()
    assert torch.equal(x.grad, ref.grad)


def _pool_grad_loop(x: np.ndarray, g: np.ndarray, size: int, first: bool) -> np.ndarray:
    """dx of the max pool window by window in plain Python: g to each
    element equal to its window max (a NaN window has a NaN max and so no
    such element; -0.0 equals +0.0), or to the first in raster order; 0 in
    the dropped rows and columns."""
    h, w = x.shape[-2:]
    xs, gs = x.reshape(-1, h, w), g.reshape(-1, h // size, w // size)
    dx = np.zeros_like(xs)
    for p in range(xs.shape[0]):
        for oy in range(h // size):
            for ox in range(w // size):
                win = xs[p, oy * size:(oy + 1) * size, ox * size:(ox + 1) * size]
                m = np.nan if np.isnan(win).any() else win.max()
                taken = False
                for i in range(size):
                    for j in range(size):
                        if win[i, j] == m and not (first and taken):
                            dx[p, oy * size + i, ox * size + j] = gs[p, oy, ox]
                            taken = True
    return dx.reshape(x.shape)


def _pool_grad_input(rng, shape, size):
    """Ties, an all-equal window, a NaN window and a window whose maximum
    is -0.0 tied with +0.0, in every plane."""
    x = np.maximum(rng.integers(-2, 3, shape), 0).astype(np.float32)
    planes = x.reshape(-1, *shape[-2:])
    planes[:, :size, :size] = 1.0
    planes[:, size, size] = np.nan
    if shape[-1] >= 3 * size and shape[-2] >= size:
        planes[:, :size, 2 * size:3 * size] = -1.0
        planes[:, 0, 2 * size:2 * size + 2] = (-0.0, 0.0)
        planes[:, size - 1, 2 * size] = -0.0
    return x


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,size", [((7, 9), 2), ((7, 9), 3), ((2, 7, 9), 2),
                                        ((2, 3, 7, 9), 3), ((2, 3, 8, 12), 2),
                                        ((2, 2, 3, 8, 10), 2)])
def test_pool_backward_reference_matches_loop(rng, first, dtype, shape, size):
    """The max pools' plain backward (what `pool_backward` runs on CPU
    tensors, and what the card's kernel is held to bit for bit) against a
    window-by-window loop, with ties, all-equal and NaN windows, ±0.0
    ties, remainders and leading dims of 0 to 3; and autograd through the
    op, with x non-contiguous."""
    x = torch.from_numpy(_pool_grad_input(rng, shape, size)).to(_TORCH[dtype])
    pooled = (*shape[:-2], shape[-2] // size, shape[-1] // size)
    g = torch.from_numpy(rng.standard_normal(pooled).astype(np.float32)).to(_TORCH[dtype])
    g.view(-1)[0] = -0.0
    out = KPool.pool(x, size, "max")
    want = torch.from_numpy(_pool_grad_loop(x.float().numpy(), g.float().numpy(), size,
                                            first)).to(x.dtype)
    got = KPool.pool_backward_reference(x, out, g, size, first)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(KPool.pool_backward(x, out, g, size, first)), _bits(want))
    fn = TPool.max_pool_first if first else TPool.max_pool_ties
    t = x.transpose(-1, -2).detach().contiguous().transpose(-1, -2).requires_grad_(True)
    assert not t.is_contiguous()
    fn(t, size).backward(g)
    assert torch.equal(_bits(t.grad.contiguous()), _bits(want))
    if first and len(shape) in (3, 4):
        # F.max_pool2d picks the first maximum too, where no window is NaN
        # (its backward adds g to zeros: -0.0 comes back +0.0)
        finite = torch.nan_to_num(x, nan=5.0).requires_grad_(True)
        torch.nn.functional.max_pool2d(finite, size).backward(g)
        no_nan = torch.from_numpy(_pool_grad_loop(finite.detach().float().numpy(),
                                                  g.float().numpy(), size, True)).to(x.dtype)
        assert torch.equal(finite.grad, no_nan)


@pytest.mark.parametrize("cuda", [False, True])
@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("grad_enabled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_pool_bwd_kernel_counts_card_inputs_that_need_a_grad(monkeypatch, cuda,
                                                              requires_grad, grad_enabled,
                                                              dtype):
    """`pool_bwd_kernel` counts a max pool at its forward, on the caller's
    thread and spans, exactly when autograd records a node whose backward
    the card's kernel will run: a CUDA float32 or bfloat16 input that
    requires a grad, with grad mode on (float16, which the kernel refuses,
    is not counted). (The op itself is stubbed: this machine has no card.)"""
    from types import SimpleNamespace

    from cadx_tpu_torch.utils import profiling as TProf

    monkeypatch.setattr(TPool._MaxPool, "apply", lambda x, size, first: "pooled")
    x = SimpleNamespace(device=torch.device("cuda" if cuda else "cpu"),
                        requires_grad=requires_grad, dtype=getattr(torch, dtype))
    before = TProf.counts().get("pool_bwd_kernel", 0)
    with torch.set_grad_enabled(grad_enabled):
        for fn in (TPool.max_pool_ties, TPool.max_pool_first):
            assert fn(x, 2) == "pooled"
    counted = TProf.counts().get("pool_bwd_kernel", 0) - before
    routed = cuda and dtype != "float16"
    assert counted == (2 if routed and requires_grad and grad_enabled else 0)


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("layout,shape", [("contiguous", (2, 3, 8, 10)),
                                          ("channels_last", (2, 3, 8, 10)),
                                          ("channels_last", (2, 5, 7, 9)),
                                          ("transposed", (2, 3, 8, 10)),
                                          ("contiguous", (3, 8, 10))])
def test_max_pool_saves_the_input_the_backward_reads(rng, first, layout, shape):
    """The max pool holds for its backward the caller's x where that is
    channels-last (the backward kernel reads it so; the forward's
    contiguous copy is then not kept), else the contiguous tensor it
    pooled; dx keeps the saved input's layout and equals the plain
    backward."""
    x = torch.from_numpy(_pool_grad_input(rng, shape, 2))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "transposed":
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert KPool.channels_last(x) == (layout == "channels_last")
    t = x.detach().requires_grad_(True)
    y = (TPool.max_pool_first if first else TPool.max_pool_ties)(t, 2)
    saved, out = y.grad_fn.saved_tensors
    if layout == "channels_last":
        assert saved.data_ptr() == t.data_ptr() and saved.stride() == t.stride()
    else:
        assert saved.is_contiguous()
        assert (saved.data_ptr() == t.data_ptr()) == (layout == "contiguous")
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    y.backward(g)
    want = KPool.pool_backward_reference(x.contiguous(), out, g, 2, first)
    assert torch.equal(_bits(t.grad.contiguous()), _bits(want))
    if layout == "channels_last":
        assert t.grad.is_contiguous(memory_format=torch.channels_last)


def test_switches_and_avg_upsample_gradients(rng):
    x = _tied(rng, (7, 9))
    out, sw = JPool.max_pool_with_switches(jnp.asarray(x), 2)
    tout, tsw = TPool.max_pool_with_switches(_nchw(x), 2)
    np.testing.assert_array_equal(_nhwc(tout), np.asarray(out))
    np.testing.assert_array_equal(tsw.permute(0, 2, 3, 1).numpy(), np.asarray(sw))

    xf = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    for port_fn, jax_fn, gshape in (
            (lambda v: TPool.avg_pool(v, 3), lambda v: JPool.avg_pool(v, 3), (2, 2, 3, 3)),
            (lambda v: TPool.upsample_nearest(v, 2), lambda v: JPool.upsample_nearest(v, 2),
             (2, 14, 18, 3))):
        g = rng.standard_normal(gshape).astype(np.float32)
        _, vjp = jax.vjp(jax_fn, jnp.asarray(xf))
        (ref,) = vjp(jnp.asarray(g))
        t = _nchw(xf).requires_grad_(True)
        port_fn(t).backward(_nchw(g))
        np.testing.assert_allclose(_nhwc(t.grad), np.asarray(ref), rtol=0, atol=1e-6)


def test_wrappers_reject_bad_arguments():
    with pytest.raises(ValueError):
        KPool.pool(torch.zeros((1, 1, 4, 4)), 2, "min")
    with pytest.raises(ValueError):
        KPool.pool(torch.zeros((1, 1, 4, 4)), 0)
    with pytest.raises(ValueError):
        KUp.upsample_nearest(torch.zeros((1, 1, 4, 4)), 0)
    # odd sides crop: a 1x1 window of a 1-row plane is empty
    assert tuple(KPool.pool(torch.zeros((2, 3, 1, 5)), 2).shape) == (2, 3, 0, 2)
