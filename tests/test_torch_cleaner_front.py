"""Port parity: the fused cleaner front, the density-seeded largest
component, median_blur, process, clean_for_unet and the 8-connected flood.

The plain versions beside the two CUDA kernels (`kernels/cleaner_front.py`,
`kernels/largest_obj.py::largest_component_seeded_reference`) are what a
CPU tensor runs. They are held bit-exact to the JAX Pallas kernels run in
interpret mode (one 64² batch each, as `tests/test_kernels.py` runs them),
to JAX's composed cleaner stages and to `largest_component_plain`; the
cleaner's entry points to JAX's on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cadx_tpu.kernels import largest_obj as JL
from cadx_tpu.kernels.cleaner_front import cleaner_front_pallas
from cadx_tpu.kernels.flood import flood_relax
from cadx_tpu.ops import morphology as JM
from cadx_tpu.preprocess import cleaner as JCl
from cadx_tpu_torch.kernels import cleaner_front as KF
from cadx_tpu_torch.kernels import largest_obj as KL
from cadx_tpu_torch.ops import components as TC
from cadx_tpu_torch.ops import morphology as TM
from cadx_tpu_torch.preprocess import cleaner as TCl
from cadx_tpu_torch.synthetic import synthetic_mammograms, tile_edge_cases
from synthetic_mammo import make_mammo


def _front_cases(rng, hw):
    """JAX's own cases (tests/test_kernels.py:222-230): a synthetic breast
    with an isolated artifact, uniform noise, an all-dark image."""
    yy, xx = np.mgrid[0:hw, 0:hw]
    img = np.zeros((hw, hw), np.uint8)
    breast = ((xx - hw + 1) ** 2 + (yy - hw // 2) ** 2) < (hw // 2) ** 2
    tissue = (110 + rng.normal(0, 25, (hw, hw))).clip(40, 185).astype(np.uint8)
    img[breast] = tissue[breast]
    img[10:16, 4:10] = 255
    noise = (rng.random((hw, hw)) * 255).astype(np.uint8)
    return np.stack([img, noise, np.zeros((hw, hw), np.uint8)])


def _rects(mask):
    return [tuple(int(v[i]) for v in TCl._bounding_rect(mask)) for i in range(mask.shape[0])]


def test_cleaner_front_plain_matches_pallas_kernel(rng):
    x = _front_cases(rng, 64)
    bo, m1, contour = cleaner_front_pallas(jnp.asarray(x), interpret=True)
    t_bo, t_m1, t_contour = KF.cleaner_front_reference(torch.from_numpy(x))
    assert t_bo.dtype == torch.uint8 and t_m1.dtype == torch.bool
    np.testing.assert_array_equal(t_bo.numpy().astype(np.int32), np.asarray(bo))
    np.testing.assert_array_equal(t_m1.numpy(), np.asarray(m1))
    np.testing.assert_array_equal(t_contour.numpy(), np.asarray(contour))
    assert int(t_m1[0].sum()) > 0 and not bool(t_m1[2].any())
    # the wrapper takes the plain version on a CPU tensor, with no launch
    before = KF.cleaner_front.launches
    got = KF.cleaner_front(torch.from_numpy(x))
    assert KF.cleaner_front.launches == before == 0
    for a, b in zip(got, (t_bo, t_m1, t_contour)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,shape", [("bench", (256, 256)), ("mammo", (256, 256)),
                                        ("mammo", (48, 80))])
def test_cleaner_front_plain_matches_composed_stages(kind, shape):
    h, w = shape
    if kind == "bench":
        x = synthetic_mammograms(2, h, seed=7)
    else:
        x = np.stack([make_mammo(s, h=h, w=w) for s in (3, 4)])
    sup, breast = jax.vmap(lambda v: JCl.suppress_artifacts(v, 0.05, 15))(jnp.asarray(x))
    seg, rect = jax.vmap(lambda v: JCl.segment_breast_mask(v, 0.05))(sup)
    bo, m1, contour = KF.cleaner_front_reference(torch.from_numpy(x))
    np.testing.assert_array_equal(bo.numpy(), np.asarray(seg))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(breast) == 255)
    assert _rects(contour) == [tuple(int(np.asarray(v)[i]) for v in rect)
                               for i in range(x.shape[0])]


@pytest.mark.parametrize("smooth_k", [0, 3])
def test_cleaner_front_plain_matches_pallas_on_tile_edge_cases(smooth_k):
    """The inputs that break a tiled CCL (`synthetic.tile_edge_cases`: tile
    edges, corners, ties across tiles, border gaps) through JAX's Pallas
    front in interpret mode and the port's plain version, at 64² (2 x 2
    tiles of the card's kernel)."""
    x = tile_edge_cases(64, 64)
    bo, m1, contour = cleaner_front_pallas(jnp.asarray(x), smooth_k=smooth_k, interpret=True)
    t_bo, t_m1, t_contour = KF.cleaner_front_reference(torch.from_numpy(x), smooth_k)
    np.testing.assert_array_equal(t_bo.numpy().astype(np.int32), np.asarray(bo))
    np.testing.assert_array_equal(t_m1.numpy(), np.asarray(m1))
    np.testing.assert_array_equal(t_contour.numpy(), np.asarray(contour))
    # what each case is for: the tie goes to the square whose first pixel
    # has the smaller raster index (in the later tile); blocks that meet
    # only at a tile corner are one component; the pocket the channel does
    # not reach is a 4-connected hole; the frame's gap on a tile edge keeps
    # its inside open
    assert bool(t_m1[1, 0, 40]) and not bool(t_m1[1, 4, 2])
    assert int(t_m1[4].sum()) == 2 * 14 * 14
    assert bool(t_m1[5, 33, 33]) and not bool(t_m1[5, 30, 30])
    assert not bool(t_m1[6, 20, 20])
    if smooth_k == 3:   # the opening cut the bridge: the tie falls to stage 2
        assert int(t_m1[2].sum()) == 200 and int(t_contour[2].sum()) == 100
        assert bool(t_contour[2, 0, 40])


@pytest.mark.parametrize("shape", [(45, 70), (1, 70), (70, 1)])
def test_cleaner_front_plain_on_tile_edge_cases_at_odd_shapes(shape):
    """Sides that are multiples of no tile, 1 x n and n x 1: the plain
    version against JAX's composed cleaner stages (the Pallas front takes
    powers of two only)."""
    x = tile_edge_cases(*shape)
    sup, breast = jax.vmap(lambda v: JCl.suppress_artifacts(v, 0.05, 3))(jnp.asarray(x))
    seg, rect = jax.vmap(lambda v: JCl.segment_breast_mask(v, 0.05))(sup)
    bo, m1, contour = KF.cleaner_front_reference(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(bo.numpy(), np.asarray(seg))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(breast) == 255)
    assert _rects(contour) == [tuple(int(np.asarray(v)[i]) for v in rect)
                               for i in range(x.shape[0])]
    assert x.shape == (12,) + shape and x.dtype == np.uint8
    assert set(np.unique(x)) <= {0, 200}


def test_cleaner_front_threshold_table():
    # the float64 truncation table, not floor(f32(0.7) * max): float32
    # rounds 90 * 0.7 to 63.0, float64 int(90 * 0.7) is 62
    table = KF._threshold_table(0.7, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (256,)
    assert int(table[90]) == 62 and int(table[255]) == 178
    assert torch.equal(KF._threshold_table(30.0, torch.device("cpu")),
                       torch.full((256,), 30, dtype=torch.int32))


def _seeded_cases(rng, hw):
    """JAX's cases (tests/test_kernels.py:178-185): a majority blob with a
    small extra (the flood path), an exact tie (the fallback), a random
    mask, an empty mask."""
    yy, xx = np.mgrid[0:hw, 0:hw]
    blob = ((yy - hw // 2) ** 2 + (xx - 3 * hw // 4) ** 2) < (hw // 2 - 8) ** 2
    blob[5:9, 2:6] = True
    tie = np.zeros((hw, hw), bool)
    tie[5:10, 5:10] = True
    tie[40:45, 40:45] = True
    return np.stack([blob, tie, rng.random((hw, hw)) > 0.55, np.zeros((hw, hw), bool)])


def _jax_seeded(masks):
    """JAX's largest_component_mask inside an interpreted pallas_call, as
    tests/test_kernels.py:187-205 wraps it (one grid step an image)."""
    b, h, w = masks.shape
    lbl_bits = int(np.ceil(np.log2(h * w + 1)))

    def kernel(mask_ref, out_ref):
        m = mask_ref[0] != 0
        rs, cs = JL._segs(m)
        out = JL.largest_component_mask(m, rs, cs, lbl_bits=lbl_bits,
                                        connectivity=8, max_iters=128)
        out_ref[0] = out.astype(jnp.int32)

    spec = pl.BlockSpec((1, h, w), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((b, h, w), jnp.int32),
                         grid=(b,), in_specs=[spec], out_specs=spec,
                         interpret=True)(jnp.asarray(masks).astype(jnp.int32))
    return np.asarray(out) == 1


def test_seeded_largest_component_matches_jax(rng):
    masks = _seeded_cases(rng, 64)
    ref = _jax_seeded(masks)
    m = torch.from_numpy(masks)
    ours = KL.largest_component_seeded_reference(m)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), TC.largest_component_plain(m).numpy())
    # the flood path on the blob, the fallback on the tie (first component)
    seed = KL._density_seed(m)
    assert int(seed[0].sum()) == 1 and bool((seed[0] & m[0]).any())
    assert int(ours[1].sum()) == 25 and bool(ours[1, 5, 5]) and not bool(ours[3].any())
    before = KL.largest_component_seeded.launches
    assert torch.equal(KL.largest_component_seeded(m), ours)
    assert KL.largest_component_seeded.launches == before == 0


def test_seeded_plain_at_connectivity_4_and_odd_shape(rng):
    m = torch.from_numpy(rng.random((3, 37, 53)) > 0.4)
    m[1] = False
    m[2, 3:30, 4:50] = True
    for conn in (4, 8):
        np.testing.assert_array_equal(
            KL.largest_component_seeded_reference(m, conn, max_iters=37 * 53).numpy(),
            TC.largest_component_plain(m, conn, max_iters=37 * 53).numpy())


def test_density_window_sum_is_the_box_sum(rng):
    x = torch.from_numpy(rng.integers(0, 2, (2, 23, 19)).astype(np.int32))
    got = KL._axis_window_sum(KL._axis_window_sum(x, 17, -2), 17, -1)
    pad = np.pad(x.numpy(), ((0, 0), (8, 8), (8, 8)))
    want = np.zeros_like(x.numpy())
    for dy in range(17):
        for dx in range(17):
            want += pad[:, dy:dy + 23, dx:dx + 19]
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_flood8(mask, seed):
    h, w = mask.shape

    def kernel(m_ref, s_ref, out_ref):
        m = m_ref[0]
        rs, cs = JL._segs(m != 0)
        out_ref[0] = flood_relax(m, s_ref[0], rs, cs, max_iters=128, connectivity=8)

    spec = pl.BlockSpec((1, h, w), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((1, h, w), jnp.int32),
                         grid=(1,), in_specs=[spec, spec], out_specs=spec, interpret=True)(
        jnp.asarray(mask, jnp.int32)[None], jnp.asarray(seed, jnp.int32)[None])
    return np.asarray(out[0]) == 1


def test_flood_from_connectivity_8_diagonal_chain():
    # a diagonal chain: 4-connectivity splits it at every step
    mask = np.zeros((16, 16), bool)
    for i in range(12):
        mask[i + 2, i + 1] = True
    mask[14, 3:6] = True                       # a separate run stays out
    seed = np.zeros_like(mask)
    seed[2, 1] = True
    m, s = torch.from_numpy(mask)[None], torch.from_numpy(seed)[None]
    eight = TC.flood_from(m, s, connectivity=8)[0].numpy()
    np.testing.assert_array_equal(eight, _jax_flood8(mask, seed))
    chain = mask.copy()
    chain[14, 3:6] = False
    np.testing.assert_array_equal(eight, chain)
    four = TC.flood_from(m, s)[0].numpy()
    assert four.sum() == 1 and four[2, 1]
    with pytest.raises(ValueError):
        TC.flood_from(m, s, connectivity=6)


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_median_blur_matches_jax(rng, ksize, dtype):
    top = 256 if dtype == np.uint8 else 65536
    imgs = rng.integers(0, top, (2, 37, 53)).astype(dtype)
    ref = np.stack([np.asarray(JM.median_blur(jnp.asarray(im), ksize)) for im in imgs])
    ours = TM.median_blur(torch.from_numpy(imgs), ksize)
    assert ours.dtype == torch.from_numpy(imgs).dtype
    np.testing.assert_array_equal(ours.numpy(), ref)
    if ksize == 3:
        np.testing.assert_array_equal(TM.median_blur3(torch.from_numpy(imgs)).numpy(), ref)
    with pytest.raises(ValueError):
        TM.median_blur(torch.from_numpy(imgs), 4)


@pytest.fixture(scope="module")
def mammos():
    return np.stack([make_mammo(s, h=128, w=96) for s in (5, 6)])


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(median_filtering=True, pect_removal=True),
    dict(median_filtering=True, blur_kn_size=5, artif_suppression=False, pect_removal=True),
])
def test_process_matches_jax(mammos, kwargs):
    ours, res = TCl.process(torch.from_numpy(mammos), **kwargs)
    for i, img in enumerate(mammos):
        ref, ref_res = JCl.process(jnp.asarray(img), **kwargs)
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref))
        assert (res is None) == (ref_res is None)
        if res is not None:
            for name in ref_res._fields:
                np.testing.assert_array_equal(getattr(res, name)[i].numpy(),
                                              np.asarray(getattr(ref_res, name)), err_msg=name)
    if kwargs.get("pect_removal"):
        assert torch.equal(ours, res.img_breast_only)


def test_process_and_suppress_uint16(mammos):
    img16 = mammos.astype(np.uint16) * 257
    ours, mask = TCl.suppress_artifacts(torch.from_numpy(img16), 0.05, 15)
    assert ours.dtype == torch.uint16 and int(ours.to(torch.int32).max()) > 255
    proc, res = TCl.process(torch.from_numpy(img16))
    assert res is None
    for i, img in enumerate(img16):
        ref, ref_mask = JCl.suppress_artifacts(jnp.asarray(img), 0.05, 15)
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(ref_mask))
        np.testing.assert_array_equal(proc[i].numpy(), np.asarray(JCl.process(jnp.asarray(img))[0]))


@pytest.mark.parametrize("kind,shape", [("bench", (256, 256)), ("mammo", (200, 136))])
def test_clean_boundary_gray_through_the_front(kind, shape):
    h, w = shape
    if kind == "bench":
        x = synthetic_mammograms(2, h, seed=11)
    else:
        x = np.stack([make_mammo(s, h=h, w=w) for s in (8, 9)])
    ref = np.asarray(jax.jit(jax.vmap(JCl.clean_boundary_gray))(jnp.asarray(x)))
    np.testing.assert_array_equal(TCl.clean_boundary_gray(torch.from_numpy(x)).numpy(), ref)


def test_clean_for_unet_within_resize_tolerance():
    # 200x136 -> 512x512 is a non-integer factor: jax.image's antialiased
    # linear resize, held to 1e-4 on [0, 255] (tests/test_torch_watershed.py),
    # so 1e-6 after the division by 255
    x = np.stack([make_mammo(s, h=200, w=136) for s in (8, 9)]).astype(np.float32)
    ours = TCl.clean_for_unet(torch.from_numpy(x)).numpy()
    assert ours.shape == (2, 512, 512) and ours.dtype == np.float32
    assert 0.0 <= ours.min() and ours.max() <= 1.0 and ours.std() > 0.01
    for i, img in enumerate(x):
        np.testing.assert_allclose(ours[i], np.asarray(JCl.clean_for_unet(jnp.asarray(img))),
                                   rtol=0, atol=1e-6)
