"""Port parity: the cleaner and the plain versions of its three kernels.

The plain versions beside the CUDA kernels (`kernels/largest_obj.py`,
`kernels/equalize.py`, `kernels/pectoral.py`) are what a CPU tensor runs;
here they are held bit-exact to the JAX cleaner's stages, and the whole
`clean_boundary_gray` chain to JAX's on two input sets. A CPU call of a
kernel wrapper never counts a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.ops import components as JComp
from cadx_tpu.ops import threshold as JT
from cadx_tpu.preprocess import cleaner as JCl
from cadx_tpu_torch.kernels import equalize as KE
from cadx_tpu_torch.kernels import largest_obj as KL
from cadx_tpu_torch.kernels import pectoral as KP
from cadx_tpu_torch.preprocess import cleaner as TCl
from cadx_tpu_torch.synthetic import synthetic_mammograms
from synthetic_mammo import make_mammo


def _inputs(kind, hw):
    if kind == "bench":
        return synthetic_mammograms(2, hw, seed=7)
    return np.stack([make_mammo(s, h=hw, w=hw) for s in (3, 4)])


def _thresholded(imgs, frac):
    th = jax.vmap(lambda x: JT.relative_threshold_value(x, frac))(jnp.asarray(imgs))
    return np.array(jax.vmap(lambda x, t: JT.binary_threshold(x, t, 255))(
        jnp.asarray(imgs), th))


@pytest.mark.parametrize("kind", ["bench", "mammo"])
def test_largest_obj_plain_matches_suppress_site(kind):
    img_bin = _thresholded(_inputs(kind, 64), 0.05)
    ref = np.asarray(jax.vmap(lambda x: JCl.select_largest_obj(
        x, 255, fill_holes_=True, smooth_boundary=True, kernel_size=15))(
            jnp.asarray(img_bin)))
    ours = KL.largest_obj_reference(torch.from_numpy(img_bin) > 0, 8,
                                    fill=True, smooth_k=15)
    np.testing.assert_array_equal(ours.numpy(), ref == 255)
    np.testing.assert_array_equal(
        TCl.select_largest_obj(torch.from_numpy(img_bin), 255, True, True, 15).numpy(),
        ref)


@pytest.mark.parametrize("kind", ["bench", "mammo"])
def test_largest_obj_plain_matches_segment_site(kind):
    img_bin = _thresholded(_inputs(kind, 64), 0.05) > 0
    ref = np.asarray(jax.vmap(lambda x: JComp.largest_component(
        JComp.fill_holes(x), 8))(jnp.asarray(img_bin)))
    ours = KL.largest_obj_reference(torch.from_numpy(img_bin), 8, fill_first=True)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("kind", ["bench", "mammo"])
def test_segment_breast_mask_and_rect(kind):
    imgs = _inputs(kind, 64)
    ref_img, ref_rect = jax.vmap(JCl.segment_breast_mask)(jnp.asarray(imgs))
    ours_img, ours_rect = TCl.segment_breast_mask(torch.from_numpy(imgs))
    np.testing.assert_array_equal(ours_img.numpy(), np.asarray(ref_img))
    for a, b in zip(ours_rect, ref_rect):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bounding_rect_empty_mask():
    x, y, w, h = TCl._bounding_rect(torch.zeros((1, 8, 8), dtype=torch.bool))
    assert (int(x), int(y), int(w), int(h)) == (0, 0, 0, 0)


@pytest.mark.parametrize("kind", ["bench", "mammo"])
def test_remove_pectoral_and_plain_tail(kind):
    imgs = _inputs(kind, 64)
    sup, breast = jax.vmap(lambda x: JCl.suppress_artifacts(x, 0.05, 15))(
        jnp.asarray(imgs))
    seg, _ = jax.vmap(JCl.segment_breast_mask)(sup)
    ref = jax.vmap(JCl.remove_pectoral)(seg, breast)
    seg_t, breast_t = torch.from_numpy(np.asarray(seg)), torch.from_numpy(np.asarray(breast))
    ours = TCl.remove_pectoral(seg_t, breast_t)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    # the plain tail alone, on the inputs the cleaner builds for it
    img_bin = (ours.img_equ > torch.from_numpy(np.asarray(jax.vmap(
        lambda x: JT.relative_threshold_value(x, 0.8))(seg))).view(-1, 1, 1))
    _, boundary, mask = KP.pectoral_tail_reference(
        ours.img_equ, img_bin.to(torch.uint8) * 255, breast_t)
    np.testing.assert_array_equal(boundary.numpy(), np.asarray(ref.boundary))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref.breast_only_mask) == 255)


@pytest.mark.parametrize("hw", [64, 128])
@pytest.mark.parametrize("kind", ["bench", "mammo"])
def test_clean_boundary_gray_exact(kind, hw):
    imgs = _inputs(kind, hw)
    ref = np.asarray(jax.jit(jax.vmap(JCl.clean_boundary_gray))(jnp.asarray(imgs)))
    ours = TCl.clean_boundary_gray(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_cpu_calls_count_no_launch(rng):
    counters = (KL.largest_obj, KE.equalize, KP.pectoral_tail)
    before = [f.launches for f in counters]
    m = torch.from_numpy(rng.random((1, 32, 32)) > 0.5)
    u8 = torch.from_numpy(rng.integers(0, 256, (1, 32, 32)).astype(np.uint8))
    KL.largest_obj(m, fill=True, smooth_k=3)
    KE.equalize(u8)
    KP.pectoral_tail(u8, (u8 > 200).to(torch.uint8) * 255, torch.full_like(u8, 255))
    TCl.clean_boundary_gray(u8)
    assert [f.launches for f in counters] == before == [0, 0, 0]


def test_kernel_wrappers_reject_other_devices():
    meta = torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        KE.equalize(meta)
    with pytest.raises(ValueError, match="CUDA"):
        KL.largest_obj(meta.to(torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        KP.pectoral_tail(meta, meta, meta)
