"""Port parity: components and the packed watershed, bit-exact.

`cadx_tpu_torch.ops.components` / `ops.watershed` against
`cadx_tpu.ops.components` / `ops.watershed` on the same numpy masks,
including inputs where a sweep cap is hit: the plain port mirrors the
JAX algorithm, caps included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.ops import components as JC
from cadx_tpu.ops import watershed as JW
from cadx_tpu_torch.ops import components as TC
from cadx_tpu_torch.ops import watershed as TW


def jax_batched(fn, *xs):
    return np.asarray(jax.vmap(fn)(*[jnp.asarray(x) for x in xs]))


def _masks(rng, shape):
    m = rng.random(shape) > 0.55
    m[0, :3, :] = False
    return m


@pytest.mark.parametrize("hw", [(48, 40), (64, 64), (128, 96)])
@pytest.mark.parametrize("conn", [4, 8])
def test_label_components_exact(rng, hw, conn):
    m = _masks(rng, (2,) + hw)
    ref = jax_batched(lambda x: JC.label_components(x, conn), m)
    ours = TC.label_components(torch.from_numpy(m), conn).numpy()
    np.testing.assert_array_equal(ours[m], ref[m])
    np.testing.assert_array_equal(ours, ref)   # background sentinel too


def _spiral(n):
    """A one-pixel-wide spiral corridor: labels need many sweeps."""
    m = np.zeros((n, n), bool)
    lo, hi = 0, n - 1
    while lo <= hi:
        m[lo, lo:hi + 1] = True
        m[lo:hi + 1, hi] = True
        if lo + 2 <= hi:
            m[hi, lo + 2:hi + 1] = True
            m[lo + 2:hi + 1, lo + 2] = True
        lo, hi = lo + 2, hi - 2
    return m


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_label_components_cap_hit(max_iters):
    m = np.stack([_spiral(40), _spiral(40).T])
    ref = jax_batched(lambda x: JC.label_components(x, 8, max_iters), m)
    ours = TC.label_components(torch.from_numpy(m), 8, max_iters).numpy()
    full = TC.label_components(torch.from_numpy(m), 8).numpy()
    assert not np.array_equal(ours, full)      # the cap really bit
    np.testing.assert_array_equal(ours, ref)


def _tie_and_empty(rng):
    ties = np.zeros((40, 40), bool)
    ties[2:8, 2:8] = True                       # two 36-px squares: the
    ties[20:26, 30:36] = True                   # smaller label must win
    ties[30:33, 2:5] = True
    empty = np.zeros((40, 40), bool)
    return np.stack([ties, empty, rng.random((40, 40)) > 0.5])


def test_largest_component_ties_and_empty(rng):
    m = _tie_and_empty(rng)
    ref = jax_batched(lambda x: JC.largest_component(x, 8), m)
    ours = TC.largest_component(torch.from_numpy(m), 8).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours[0, 2:8, 2:8].all() and not ours[0, 20:26, 30:36].any()
    assert not ours[1].any()


@pytest.mark.parametrize("conn", [4, 8])
def test_largest_component_random(rng, conn):
    m = _masks(rng, (3, 64, 64))
    ref = jax_batched(lambda x: JC.largest_component(x, conn), m)
    np.testing.assert_array_equal(
        TC.largest_component(torch.from_numpy(m), conn).numpy(), ref)


def _disc(n, r):
    yy, xx = np.mgrid[0:n, 0:n]
    return (yy - n // 2) ** 2 + (xx - n // 2) ** 2 < r * r


def test_fill_holes_certificate_fires():
    # a convex disc: every row is one run, so the flood is skipped
    m = np.stack([_disc(48, 15), _disc(48, 20)])
    ref = jax_batched(JC.fill_holes, m)
    ours = TC.fill_holes(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, m)


def test_fill_holes_with_holes(rng):
    ring = _disc(48, 18) & ~_disc(48, 8)
    m = np.stack([ring, _disc(48, 12), rng.random((48, 48)) > 0.4])
    ref = jax_batched(JC.fill_holes, m)
    ours = TC.fill_holes(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours[0, 24, 24]                      # the ring's hole is filled


def test_flood_from_border(rng):
    m = _masks(rng, (2, 64, 56))
    seed = np.zeros_like(m)
    seed[:, 0, :] = seed[:, -1, :] = True
    seed[:, :, 0] = seed[:, :, -1] = True
    ref = jax_batched(lambda a, b: JC.flood_from(a, b), m, seed)
    ours = TC.flood_from(torch.from_numpy(m), torch.from_numpy(seed)).numpy()
    np.testing.assert_array_equal(ours, ref)


def _watershed_inputs(rng, h, w):
    img = rng.integers(0, 256, (2, h, w)).astype(np.uint8)
    img[1] = np.clip(np.add.outer(np.arange(h), np.arange(w)) * 2, 0, 255)
    markers = np.zeros((2, h, w), np.int32)
    markers[:, :h // 5, :w // 5] = 255
    markers[:, -h // 5:, -w // 5:] = 128
    markers[:, :3, -3:] = 64
    markers[0, h // 2, :4] = 64
    return img, markers


@pytest.mark.parametrize("max_scan", [8, 256])
def test_marker_watershed_packed_exact(rng, max_scan):
    img, markers = _watershed_inputs(rng, 48, 40)
    values = (255, 128, 64)
    ref_l, ref_b = jax.vmap(lambda a, b: JW.marker_watershed(
        a, b, max_scan=max_scan, marker_label_values=values))(
            jnp.asarray(img), jnp.asarray(markers))
    lab, bnd = TW.marker_watershed(torch.from_numpy(img),
                                   torch.from_numpy(markers),
                                   max_scan=max_scan,
                                   marker_label_values=values)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(bnd.numpy(), np.asarray(ref_b))


def test_marker_watershed_pair_form_not_ported():
    """Without marker values the pair form runs (it raised before it was
    ported) and agrees with JAX, here on an unmarked and a marked image."""
    img = np.zeros((2, 8, 8), np.float32)
    img[1, :, 4:] = 50.0
    markers = np.zeros((2, 8, 8), np.int32)
    markers[1, 0, 0], markers[1, 7, 7] = 2, 5
    ref_l, ref_b = jax.vmap(lambda a, b: JW.marker_watershed(a, b))(
        jnp.asarray(img), jnp.asarray(markers))
    lab, bnd = TW.marker_watershed(torch.from_numpy(img), torch.from_numpy(markers))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(bnd.numpy(), np.asarray(ref_b))
