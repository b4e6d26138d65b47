"""Port parity: the flood (kernels/flood.py's plain version and the
dispatching ops) and conv_leaky's input layouts.

- `kernels/flood.py::flood_from_reference`, what the wrapper runs on a CPU
  tensor, against JAX's `flood_from_pallas` in interpret mode, bit-exact,
  to the fixpoint and after a capped run (a serpentine stopped after two
  sweeps holds the same state in both);
- `ops.components.flood_from` and `fill_holes` on CPU tensors against
  JAX's `ops.components`, bit-exact;
- `conv2d_leaky` fed the channels-last view of NHWC features, as
  `models/cnn.py::conv_stack` feeds its first layer: forward and backward
  against the contiguous input and JAX's `conv2d_leaky_pallas` in
  interpret mode, to 1e-5 of the largest value, at least 1e-5 (float32
  sums of up to B*H*W terms in another order), and the wrapper's
  layout rule, which the CUDA kernel reads from the strides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.kernels import flood as JF
from cadx_tpu.kernels import nn_kernels as nk
from cadx_tpu.ops import components as JC
from cadx_tpu.ops import conv as JConv
from cadx_tpu_torch import convert
from cadx_tpu_torch.kernels import conv_leaky as KCL
from cadx_tpu_torch.kernels import flood as KF
from cadx_tpu_torch.ops import components as TC
from cadx_tpu_torch.ops import conv as TConv


def _close(a, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(a, ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _serpentine(h: int, w: int) -> np.ndarray:
    """A one-pixel corridor that doubles back every 4 rows: reach from the
    top row needs one sweep per turn."""
    m = np.zeros((h, w), bool)
    for r in range(0, h, 4):
        m[r, :] = True
        if r + 1 < h:
            m[r + 1: r + 4, w - 1 if (r // 4) % 2 == 0 else 0] = True
    return m


def _flood_inputs(rng, b, h, w):
    m = rng.random((b, h, w)) < 0.6
    m[0] = _serpentine(h, w)
    seed = np.zeros((b, h, w), bool)
    seed[:, 0, :] = True
    seed[-1] |= rng.random((h, w)) < 0.01
    return m, seed


@pytest.mark.parametrize("hw", [(16, 16), (24, 40), (37, 29)])
@pytest.mark.parametrize("max_iters", [1, 2, 128])
def test_flood_plain_matches_pallas(rng, hw, max_iters):
    m, seed = _flood_inputs(rng, 3, *hw)
    ref = np.asarray(JF.flood_from_pallas(jnp.asarray(m), jnp.asarray(seed), max_iters,
                                          interpret=True))
    ours = KF.flood_from_reference(torch.from_numpy(m), torch.from_numpy(seed), max_iters)
    np.testing.assert_array_equal(ours.numpy(), ref)
    before = KF.flood_from.launches
    wrapped = KF.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters)
    assert KF.flood_from.launches == before        # a CPU tensor takes the plain version
    np.testing.assert_array_equal(wrapped.numpy(), ref)


def test_flood_capped_serpentine_state(rng):
    """Two sweeps on a serpentine stop short of the fixpoint, in JAX and in
    the port, at the same pixels."""
    m = _serpentine(32, 24)[None]
    seed = np.zeros_like(m)
    seed[0, 0, 0] = True
    ref = np.asarray(JF.flood_from_pallas(jnp.asarray(m), jnp.asarray(seed), 2,
                                          interpret=True))
    ours = KF.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters=2).numpy()
    full = KF.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters=32 * 24)
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() < full.numpy().sum() == m.sum()


def test_flood_wrapper_rejects_connectivity():
    m = torch.ones((1, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        KF.flood_from(m, m, connectivity=6)


@pytest.mark.parametrize("max_iters", [2, 128])
def test_ops_flood_from_and_fill_holes_match_jax(rng, max_iters):
    m, seed = _flood_inputs(rng, 3, 40, 36)
    ref = np.stack([np.asarray(JC.flood_from(jnp.asarray(a), jnp.asarray(s), max_iters))
                    for a, s in zip(m, seed)])
    ours = TC.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters).numpy()
    np.testing.assert_array_equal(ours, ref)
    holes = rng.random((3, 40, 36)) > 0.3
    holes[1, 10:20, 10:20] = True
    holes[1, 13:16, 13:16] = False                 # a hole
    ref = np.stack([np.asarray(JC.fill_holes(jnp.asarray(a), max_iters)) for a in holes])
    for fn in (TC.fill_holes, TC.fill_holes_plain):
        np.testing.assert_array_equal(fn(torch.from_numpy(holes), max_iters).numpy(), ref)


def test_conv_leaky_layout_rule():
    x = torch.zeros((2, 5, 7, 9))
    assert KCL._layout(x) == 0
    assert KCL._layout(torch.zeros((2, 7, 9, 5)).permute(0, 3, 1, 2)) == 1
    assert KCL._layout(torch.zeros((1, 1, 7, 9)).permute(0, 1, 2, 3)) == 0
    for odd in (x[:, :, ::2], x.transpose(2, 3), torch.zeros((2, 7, 5, 9)).permute(0, 2, 1, 3)):
        with pytest.raises(ValueError):
            KCL._layout(odd)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv2d_leaky_nhwc_view_matches_contiguous_and_pallas(rng, padding):
    b, h, w, c, f, k = 2, 11, 10, 6, 7, 3
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    x[:, : h // 2] = 0.0
    wt = (rng.standard_normal((k, k, c, f)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    bias[0] = 0.0
    p = 0 if padding == "VALID" else k // 2
    jx = jnp.pad(jnp.asarray(x), ((0, 0), (p, p), (p, p), (0, 0)))
    pallas = np.asarray(nk.conv2d_leaky_pallas(jx, jnp.asarray(wt), jnp.asarray(bias), 0.01,
                                               interpret=True))
    out, vjp = jax.vjp(lambda a, k_, b_: JConv.conv2d_leaky(a, k_, b_, alpha=0.01,
                                                            padding=padding if p == 0 else p),
                       jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    g = rng.standard_normal(out.shape).astype(np.float32)
    dx, dw, db = vjp(jnp.asarray(g))
    grads = {}
    for name, make in (("view", lambda t: t.permute(0, 3, 1, 2)),
                       ("contiguous", lambda t: t.permute(0, 3, 1, 2).contiguous())):
        xt = torch.from_numpy(x).requires_grad_(True)
        tw = convert.hwio_to_oihw(wt).requires_grad_(True)
        tb = torch.from_numpy(bias).requires_grad_(True)
        xin = make(xt)
        assert KCL._layout(xin.detach()) == (1 if name == "view" else 0)
        y = TConv.conv2d_leaky(xin, tw, tb, 0.01, padding)
        y_nhwc = y.detach().permute(0, 2, 3, 1).numpy()
        _close(y_nhwc, pallas)
        _close(y_nhwc, out)
        y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        grads[name] = (xt.grad.numpy(), tw.grad.numpy(), tb.grad.numpy())
        _close(grads[name][0], dx)
        _close(grads[name][1], np.asarray(dw).transpose(3, 2, 0, 1))
        _close(grads[name][2], db)
    for a, c_ in zip(grads["view"], grads["contiguous"]):
        _close(a, c_)
