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
