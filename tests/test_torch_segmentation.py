"""Port parity: the U-Nets (`models/unet.py`) and the segmentation trainer
(`train/segmentation.py`) against the JAX package, on JAX weights
converted by `cadx_tpu_torch.convert` and the same numpy data.

Tolerances: forwards, losses and gradients 1e-5 (float32 convs and sums
in another order); the fit_segmentation epoch losses 1e-5 relative;
IoU/Dice of the same masks to one rounding of the batch mean, and after
training within 0.02 (a pixel near the threshold may land on either
side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.models import unet as JU
from cadx_tpu.train import segmentation as JSeg
from cadx_tpu_torch import convert
from cadx_tpu_torch.models import unet as TU
from cadx_tpu_torch.train import optim as TOpt
from cadx_tpu_torch.train import segmentation as TSeg


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _unet_pair(features=(4, 8, 16), seed=0, **kw):
    jcfg = JU.UNetConfig(features=features, **kw)
    jp = _numpy(jax.jit(JU.init_unet, static_argnums=1)(jax.random.key(seed), jcfg))
    tcfg = TU.UNetConfig(features=features, **kw)
    return jcfg, jp, convert.convert_unet_params(jp, tcfg)


def _blobs(rng, n, hw=16):
    """Images with a bright disk; mask = the disk."""
    X = rng.random((n, hw, hw, 1)).astype(np.float32) * 0.3
    Y = np.zeros((n, hw, hw, 1), np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        cy, cx = rng.integers(4, hw - 4, 2)
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2) < rng.integers(2, 5) ** 2
        X[i, disk, 0] += 0.6
        Y[i, disk, 0] = 1.0
    return X, Y


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("final,features", [("sigmoid", (4, 8, 16)), ("none", (4, 8))])
def test_unet_forward_matches_jax(rng, final, features):
    jcfg, jp, model = _unet_pair(features=features, final_activation=final)
    x = rng.random((2, 16, 16, 1)).astype(np.float32)
    ref = jax.jit(JU.unet_apply, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        ours = TU.unet_apply(model, torch.from_numpy(x))
    assert tuple(ours.shape) == (2, 16, 16, 1)
    _close(ours.numpy(), ref)
    assert [tuple(p.shape) for p in model.head.parameters()] == [(1, 4, 1, 1), (1,)]
    assert len(model.enc) == len(features) - 1


def test_tiny_unet_matches_jax(rng):
    jp = _numpy(JU.init_tiny_unet(jax.random.key(1), in_channels=2))
    model = convert.convert_tiny_unet_params(jp)
    x = rng.random((2, 12, 8, 2)).astype(np.float32)
    with torch.no_grad():
        _close(TU.tiny_unet_apply(model, torch.from_numpy(x)).numpy(),
               jax.jit(JU.tiny_unet_apply)(jp, jnp.asarray(x)))
        _close(TU.tiny_unet_bottleneck(model, torch.from_numpy(x)).numpy(),
               jax.jit(JU.tiny_unet_bottleneck)(jp, jnp.asarray(x)))
    x1 = x[..., :1]
    jp1 = _numpy(JU.init_tiny_unet(jax.random.key(2)))
    m1 = convert.convert_tiny_unet_params(jp1)
    loss, grads = jax.jit(jax.value_and_grad(JU.tiny_unet_mse))(jp1, jnp.asarray(x1))
    tx = torch.from_numpy(x1)
    tloss = TU.tiny_unet_mse(m1, tx)
    tgrads = torch.autograd.grad(tloss, list(m1.parameters()))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    ref = convert.convert_tiny_unet_params(_numpy(grads)).parameters()
    for a, b in zip(tgrads, ref, strict=True):
        _close(a.numpy(), b.detach().numpy())


def test_init_distributions():
    model = TU.init_unet(torch.Generator().manual_seed(0), TU.UNetConfig())
    w = model.enc[0].conv2.weight.detach()
    assert tuple(w.shape) == (16, 16, 3, 3)
    assert abs(float(w.std()) - (2.0 / (9 * 16)) ** 0.5) < 0.01
    assert tuple(model.dec[0].conv1.weight.shape) == (64, 192, 3, 3)
    limit = (6.0 / (16 + 1)) ** 0.5
    assert float(model.head.weight.abs().max()) <= limit
    again = TU.init_unet(torch.Generator().manual_seed(0), TU.UNetConfig())
    assert torch.equal(again.dec[2].conv2.weight, model.dec[2].conv2.weight)
    tiny = TU.init_tiny_unet(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in tiny.out.parameters()] == [(1, 16, 1, 1), (1,)]


def test_dice_bce_loss_and_grads_match_jax(rng):
    jcfg, jp, model = _unet_pair(seed=3)
    X, Y = _blobs(rng, 3)
    loss, grads = jax.jit(jax.value_and_grad(JSeg.dice_bce_loss), static_argnums=3)(
        jp, jnp.asarray(X), jnp.asarray(Y), jcfg)
    tloss = TSeg.dice_bce_loss(model, torch.from_numpy(X), torch.from_numpy(Y))
    tgrads = torch.autograd.grad(tloss, list(model.parameters()))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    ref = convert.convert_unet_params(_numpy(grads), model.config).parameters()
    for a, b in zip(tgrads, ref, strict=True):
        _close(a.numpy(), b.detach().numpy())


def test_iou_dice_matches_jax(rng):
    p = rng.random((3, 8, 8, 1)) > 0.5
    t = rng.random((3, 8, 8, 1)) > 0.4
    ours = TSeg.iou_dice(torch.from_numpy(p), torch.from_numpy(t))
    ref = JSeg.iou_dice(jnp.asarray(p), jnp.asarray(t))
    # the per-image ratios agree exactly; the batch mean may not, as XLA
    # multiplies the sum by the float32 reciprocal of the count
    np.testing.assert_allclose([float(v) for v in ours], [float(v) for v in ref],
                               rtol=1e-7, atol=0)


def test_fit_segmentation_matches_jax(rng):
    """n=10, batch 4: each epoch's tail batch wraps to the permutation's
    start. Two epochs, so the second loss also checks the Adam updates."""
    jcfg, jp, model = _unet_pair(features=(4, 8), seed=4)
    X, Y = _blobs(rng, 10)
    Xv, Yv = _blobs(rng, 4)
    ref = JSeg.fit_segmentation(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, X, Y,
                                Xv, Yv, epochs=2, lr=3e-3, batch_size=4, seed=0)
    before = [p.detach().clone() for p in model.parameters()]
    lines = []
    res = TSeg.fit_segmentation(model, X, Y, Xv, Yv, epochs=2, lr=3e-3, batch_size=4,
                                seed=0, log_fn=lines.append, device="cpu")
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)                 # the caller's model is untouched
    assert len(lines) == 2 and lines[0].startswith("[SEG 1/2] loss=")
    for r, j in zip(res.history, ref.history, strict=True):
        assert r["epoch"] == j["epoch"]
        np.testing.assert_allclose(r["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose([r["val_iou"], r["val_dice"]],
                                   [j["val_iou"], j["val_dice"]], rtol=0, atol=2e-2)


def test_adam_state_of_a_unet_converts(rng):
    """optax mu/nu trees of a U-Net land in the port's parameter order."""
    import optax

    jcfg, jp, model = _unet_pair(seed=5)
    X, Y = _blobs(rng, 2)
    tx = optax.adam(1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    grads = jax.jit(jax.grad(JSeg.dice_bce_loss), static_argnums=3)(
        params, jnp.asarray(X), jnp.asarray(Y), jcfg)
    _, state = jax.jit(tx.update)(grads, tx.init(params))
    ours = TOpt.adam(1e-3)
    tgrads = torch.autograd.grad(
        TSeg.dice_bce_loss(model, torch.from_numpy(X), torch.from_numpy(Y)),
        list(model.parameters()))
    st = ours.step(list(model.parameters()), tgrads, ours.init(model.parameters()))
    ref = convert.convert_adam_state(_numpy(state),
                                     lambda t: convert.convert_unet_params(t, model.config))
    assert st.count == ref.count == 1
    for a, b in zip(st.mu + st.nu, ref.mu + ref.nu, strict=True):
        _close(a.numpy(), b.numpy())


def test_fit_segmentation_needs_a_card_unless_told_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = TU.init_unet(torch.Generator().manual_seed(0), TU.UNetConfig(features=(4, 8)))
    X, Y = _blobs(rng, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSeg.fit_segmentation(model, X, Y, X, Y, epochs=1)
