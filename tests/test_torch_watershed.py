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


# ---- the pair-form kernel's halo tiles and its stopping rule ----------------------

def _pair_state(rng, b, h, w):
    """A sweep's input planes: noise and a ramp, the markers of _ws_inputs,
    after two plain sweeps (so distances and labels are mixed)."""
    img, markers = _ws_inputs(rng, h, w)
    img = torch.from_numpy(img[:b]).to(torch.float32)
    labels = torch.from_numpy(markers[:b])
    d = torch.where(labels > 0, 0.0, TG.BIG).to(torch.float32)
    srow, scol = TG.axis_costs(img)
    for _ in range(2):
        d, labels = TG.sweep(d, labels, srow, scol, 8)
    return d, labels, srow, scol


def _tiled_sweep(d, l, srow, scol, max_scan, tile_h, tile_w):
    """One sweep computed as the kernel's blocks compute it: each tile from
    copies of the pre-sweep planes cut to the tile and a halo of win - 1
    pixels on every side (the image's edge cuts it too), keeping the
    tile's own pixels only."""
    h, w = d.shape[-2:]
    hr, hc = KW.halo(w, max_scan), KW.halo(h, max_scan)
    out_d, out_l = torch.empty_like(d), torch.empty_like(l)
    for y0 in range(0, h, tile_h):
        for x0 in range(0, w, tile_w):
            ry0, rx0 = max(y0 - hc, 0), max(x0 - hr, 0)
            ry1, rx1 = min(y0 + tile_h + hc, h), min(x0 + tile_w + hr, w)
            y1, x1 = min(y0 + tile_h, h), min(x0 + tile_w, w)
            cut = [t[:, ry0:ry1, rx0:rx1].clone() for t in (d, l, srow, scol)]
            td, tl = TG.sweep(*cut, max_scan)
            own = (slice(None), slice(y0 - ry0, y1 - ry0), slice(x0 - rx0, x1 - rx0))
            out_d[:, y0:y1, x0:x1] = td[own]
            out_l[:, y0:y1, x0:x1] = tl[own]
    return out_d, out_l


@pytest.mark.parametrize("tile", KW.TILES)
@pytest.mark.parametrize("hw", [(150, 140), (45, 70), (70, 1), (1, 70), (5, 9),
                                (65, 127), (130, 257)])
def test_halo_tiled_sweep_exact(rng, hw, tile):
    """The kernel's halo design: a sweep computed tile by tile with each of
    the kernel's tiles and its halo (win - 1) equals geodesic_scan.sweep
    bit for bit, at ragged shapes, sides below the halo and the cleaner's
    max_scan 8, over three sweeps."""
    d, l, srow, scol = _pair_state(rng, 2, *hw)
    assert KW.halo(100, 8) == 7 and KW.halo(5, 8) == 7 and KW.halo(1, 8) == 0
    assert KW.halo(100, 8) <= KW.MAX_HALO < KW.halo(100, 9)
    for _ in range(3):
        want = TG.sweep(d, l, srow, scol, 8)
        got = _tiled_sweep(d, l, srow, scol, 8, *tile)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        d, l = want


def test_tile_choice():
    """64 x 128 where 64 x 64 tiles would fill at most one wave of the card
    (two blocks an SM), else 64 x 64: the 1024x832 upload and the
    1536x1280 bucket at B=1 on 132 SMs."""
    assert KW.tile_for(1, 1024, 832) == (64, 128)
    assert KW.tile_for(1, 1536, 1280) == (64, 64)
    assert KW.tile_for(1, 3328, 2560) == (64, 64)
    assert KW.tile_for(4, 1024, 832) == (64, 64)


@pytest.mark.parametrize("hw", [(45, 70), (24, 20)])
def test_sweeps_after_an_unchanged_sweep_change_nothing(rng, hw):
    """The ground of the kernel's stopping rule: once a sweep changes no
    distance it changes no label either, so every later sweep reads and
    writes the same planes, and running more sweeps than the plain
    version's stop gives its labels."""
    img, markers = _ws_inputs(rng, *hw)
    img = torch.from_numpy(img).to(torch.float32)
    labels = torch.from_numpy(markers)
    d = torch.where(labels > 0, 0.0, TG.BIG).to(torch.float32)
    srow, scol = TG.axis_costs(img)
    for n in range(1, 200):
        new_d, new_l = TG.sweep(d, labels, srow, scol, 8)
        settled = bool((new_d == d).all())
        d, labels = new_d, new_l
        if settled:
            break
    assert settled and n > 1
    assert TG.sweeps_to_fixpoint(img, torch.from_numpy(markers), 256, 8) == n
    for _ in range(3):
        new_d, new_l = TG.sweep(d, labels, srow, scol, 8)
        np.testing.assert_array_equal(new_d.numpy(), d.numpy())
        np.testing.assert_array_equal(new_l.numpy(), labels.numpy())
    plain = TG.relax_to_fixpoint(img, torch.from_numpy(markers), 256, 8)
    np.testing.assert_array_equal(plain.numpy(), labels.numpy())
    capped = TG.relax_to_fixpoint(img, torch.from_numpy(markers), n + 5, 8)
    np.testing.assert_array_equal(capped.numpy(), labels.numpy())
