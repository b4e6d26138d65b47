"""Port parity: the repairs on the serving path, against the JAX package.

Each of these raised in the port before the serving slice and answers
now, held to the JAX function on the same numpy inputs:
- the (distance, label) pair form of the geodesic watershed
  (`ops/geodesic_scan.py`, `ops/watershed.py`): bit-exact;
- connected-component labelling of images too large to pack into int32
  (JAX's tuple-scan form; the port's int64 packed cummin): exact;
- `remove_pectoral` beyond 512 px, through the composed branch and the
  pair form: `clean_boundary_gray` bit-exact;
- `resize_area` at non-integer factors (JAX's antialiased linear resize):
  within 1e-4 on a [0, 255] scale, the summation order being the port's.
Also the plain versions beside the three new kernels, on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.ops import components as JC
from cadx_tpu.ops import geodesic_scan as JG
from cadx_tpu.ops import resize as JR
from cadx_tpu.ops import watershed as JW
from cadx_tpu.preprocess import cleaner as JCl
from cadx_tpu_torch.kernels import ccl as KC
from cadx_tpu_torch.kernels import mode as KM
from cadx_tpu_torch.kernels import watershed as KW
from cadx_tpu_torch.ops import components as TC
from cadx_tpu_torch.ops import geodesic_scan as TG
from cadx_tpu_torch.ops import resize as TR
from cadx_tpu_torch.ops import watershed as TW
from cadx_tpu_torch.preprocess import cleaner as TCl
from synthetic_mammo import make_mammo


def _ws_inputs(rng, h, w):
    """A noise image and a ramp, markers 255 / 128 / 64 and one stray 7."""
    img = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    img[1] = np.clip(np.add.outer(np.arange(h), np.arange(w)) * 2, 0, 255)
    markers = np.zeros((2, h, w), np.int32)
    markers[:, :h // 5, :w // 5] = 255
    markers[:, -h // 5:, -w // 5:] = 128
    markers[:, :3, -3:] = 64
    markers[0, h // 2, :4] = 7
    return img, markers


@pytest.mark.parametrize("max_scan", [8, 256])
@pytest.mark.parametrize("hw", [(64, 48), (96, 80)])
def test_pair_form_watershed_exact(rng, hw, max_scan):
    img, markers = _ws_inputs(rng, *hw)
    ref_l, ref_b = jax.vmap(lambda a, b: JW.marker_watershed(
        a, b, max_scan=max_scan, marker_label_values=()))(
            jnp.asarray(img), jnp.asarray(markers))
    lab, bnd = TW.marker_watershed(torch.from_numpy(img), torch.from_numpy(markers),
                                   max_scan=max_scan)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(bnd.numpy(), np.asarray(ref_b))
    assert set(np.unique(lab.numpy())) <= {0, 7, 64, 128, 255}


def test_pair_form_chosen_beyond_512(rng):
    """With marker values the packed form is taken up to 512 px; beyond,
    the pair form, as in JAX (labels then keep the raw marker values)."""
    img, markers = _ws_inputs(rng, 520, 24)
    values = (255, 128, 64)
    ref_l, ref_b = JW.marker_watershed(jnp.asarray(img[1]), jnp.asarray(markers[1]),
                                       max_scan=8, marker_label_values=values)
    lab, bnd = TW.marker_watershed(torch.from_numpy(img[1:]),
                                   torch.from_numpy(markers[1:]), max_scan=8,
                                   marker_label_values=values)
    np.testing.assert_array_equal(lab[0].numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(bnd[0].numpy(), np.asarray(ref_b))


def test_axis_costs_and_sweep_exact(rng):
    img = rng.random((37, 29)).astype(np.float32) * 255
    srow, scol = JG.axis_costs(JW._shift, jnp.asarray(img))
    ts, tc = TG.axis_costs(torch.from_numpy(img)[None])
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(srow))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(scol))
    markers = np.zeros((37, 29), np.int32)
    markers[:4, :4], markers[-4:, -4:] = 3, 9
    d = np.where(markers > 0, 0.0, JG.BIG).astype(np.float32)
    jd, jl = JG.sweep(JW._shift, jnp.asarray(d), jnp.asarray(markers), srow, scol, 8)
    td, tl = TG.sweep(torch.from_numpy(d)[None], torch.from_numpy(markers)[None],
                      ts, tc, 8)
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))


def test_int64_labelling_exact_at_1024(rng):
    """1024x1024 is the smallest square whose label and segment bits pass
    31, where JAX switches to its tuple-scan form."""
    m = np.zeros((1, 1024, 1024), bool)
    m[0, 100:900, 100:300] = True
    m[0, 50:60, :] = True
    m[0, 500:1000:3, 400:1000] = True
    m |= rng.random(m.shape) > 0.97
    ref = np.asarray(JC.label_components(jnp.asarray(m[0]), 8))
    ours = TC.label_components(torch.from_numpy(m), 8).numpy()[0]
    np.testing.assert_array_equal(ours, ref)
    assert TC.background_label(1024, 1024) == int(ref[~m[0]][0]) == 1 << 30
    assert TC.background_label(1023, 1023) == (1 << 20) - 1


def test_clean_boundary_gray_exact_beyond_512():
    """544x520: the composed remove_pectoral branch and the pair-form
    watershed, against the JAX cleaner."""
    img = make_mammo(5, h=544, w=520)
    ref = np.asarray(jax.jit(JCl.clean_boundary_gray)(jnp.asarray(img)))
    ours = TCl.clean_boundary_gray(torch.from_numpy(img)[None])[0].numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape,out_hw", [((96, 96), (64, 64)),
                                          ((640, 544), (512, 512)),
                                          ((1536, 1280), (512, 512)),
                                          ((2080, 1696), (256, 256)),
                                          ((40, 30), (64, 64)),
                                          ((45, 38, 3), (20, 15))])
def test_resize_area_non_integer(rng, shape, out_hw):
    x = (rng.random(shape) * 255).astype(np.float32)
    ref = np.asarray(JR.resize_area(jnp.asarray(x), out_hw))
    ours = TR.resize_area(torch.from_numpy(x)[None], out_hw)[0].numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_new_kernel_plain_versions_on_cpu(rng):
    m = rng.random((2, 30, 26)) > 0.5
    labels = jax.vmap(lambda x: JC.label_components(x, 8))(jnp.asarray(m))
    largest = jax.vmap(lambda x: JC.largest_component(x, 8))(jnp.asarray(m))
    counters = (KC.label_components, KM.largest_component_mask, KW.marker_watershed)
    before = [f.launches for f in counters]
    t_labels = KC.label_components(torch.from_numpy(m), 8)
    np.testing.assert_array_equal(t_labels.numpy(), np.asarray(labels))
    np.testing.assert_array_equal(
        KM.largest_component_mask(t_labels, torch.from_numpy(m)).numpy(),
        np.asarray(largest))
    img, markers = _ws_inputs(rng, 32, 24)
    for values in ((), (255, 128, 64)):
        ref = jax.vmap(lambda a, b: JW.marker_watershed(
            a, b, max_scan=8, marker_label_values=values))(
                jnp.asarray(img), jnp.asarray(markers))
        got = KW.marker_watershed(torch.from_numpy(img), torch.from_numpy(markers),
                                  max_scan=8, marker_label_values=values)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [f.launches for f in counters] == before


def test_new_kernel_wrappers_reject_other_devices():
    meta = torch.zeros((1, 8, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        KC.label_components(meta)
    with pytest.raises(ValueError, match="CUDA"):
        KM.largest_component_mask(meta.to(torch.int32), meta)
    with pytest.raises(ValueError, match="CUDA"):
        KW.marker_watershed(meta.to(torch.float32), meta.to(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        TC.largest_component(meta)
