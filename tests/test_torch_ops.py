"""Port parity: the image ops of `cadx_tpu_torch.ops` against `cadx_tpu.ops`.

The same numpy inputs go through the JAX function (per image, on the
CPU) and the port (batched, on CPU tensors). Exact ops are held
bit-exact; the linear resizes to 1e-5 relative / 1e-6 absolute, since
their summation order differs by about an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.ops import colormap as JC
from cadx_tpu.ops import histogram as JH
from cadx_tpu.ops import morphology as JM
from cadx_tpu.ops import pool as JP
from cadx_tpu.ops import resize as JR
from cadx_tpu.ops import threshold as JT
from cadx_tpu_torch.ops import colormap as TCm
from cadx_tpu_torch.ops import histogram as TH
from cadx_tpu_torch.ops import morphology as TM
from cadx_tpu_torch.ops import pool as TP
from cadx_tpu_torch.ops import resize as TR
from cadx_tpu_torch.ops import threshold as TT
from cadx_tpu_torch.synthetic import synthetic_mammograms


def jax_batched(fn, x, *args):
    return np.asarray(jax.vmap(lambda im: fn(im, *args))(jnp.asarray(x)))


def port(fn, x, *args):
    return fn(torch.from_numpy(np.ascontiguousarray(x)), *args).numpy()


def _u8_images(rng):
    imgs = rng.integers(0, 256, (3, 40, 52)).astype(np.uint8)
    # a max of 90: f32 floor(90 * 0.7) = 63 but float64 int() gives 62
    imgs[1] = np.where(imgs[1] > 128, 90, imgs[1] // 4)
    return imgs


def test_relative_threshold_value_uses_float64_truncation(rng):
    imgs = _u8_images(rng)
    for frac in (0.05, 0.1, 0.7, 0.8, 3.0):
        ref = jax_batched(JT.relative_threshold_value, imgs, frac)
        np.testing.assert_array_equal(port(TT.relative_threshold_value, imgs, frac), ref)
    assert np.floor(np.float32(90) * np.float32(0.7)) == 63
    assert port(TT.relative_threshold_value, imgs[1:2], 0.7)[0] == 62


def test_binary_threshold_per_image(rng):
    imgs = _u8_images(rng)
    th = jax_batched(JT.relative_threshold_value, imgs, 0.1).copy()
    ref = np.stack([np.asarray(JT.binary_threshold(jnp.asarray(im), t, 255))
                    for im, t in zip(imgs, th)])
    ours = TT.binary_threshold(torch.from_numpy(imgs),
                               torch.from_numpy(th), 255).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.uint16])
def test_to_uint8_per_image_max(rng, dtype):
    scale = {np.float32: 3.7, np.uint8: 1, np.uint16: 250}[dtype]
    imgs = (rng.random((3, 33, 21)) * 255 * scale).astype(dtype)
    imgs[2] //= 3   # each image has its own max: reduce per image
    np.testing.assert_array_equal(port(TT.to_uint8, imgs),
                                  jax_batched(JT.to_uint8, imgs))


def _equalize_inputs(name, rng):
    if name == "random":
        return rng.integers(0, 256, (3, 48, 64)).astype(np.uint8)
    if name == "synthetic":
        return synthetic_mammograms(2, 64, seed=3)
    if name == "single_level":
        return np.full((2, 32, 32), 77, np.uint8)
    # narrow range: many LUT entries land on .5 and round half to even
    return rng.integers(100, 104, (2, 30, 34)).astype(np.uint8)


@pytest.mark.parametrize("name", ["random", "synthetic", "single_level", "narrow"])
def test_equalize_hist_exact(rng, name):
    imgs = _equalize_inputs(name, rng)
    np.testing.assert_array_equal(port(TH.equalize_hist, imgs),
                                  jax_batched(JH.equalize_hist, imgs))


def test_equalize_hist_rejects_uint16():
    with pytest.raises(ValueError, match="uint8"):
        TH.equalize_hist(torch.zeros((1, 4, 4), dtype=torch.uint16))


@pytest.mark.parametrize("k,n", [(3, 7), (15, 1), (25, 1), (4, 2)])
@pytest.mark.parametrize("op", ["erode", "dilate", "opening"])
def test_morphology_exact(rng, op, k, n):
    imgs = rng.integers(0, 256, (2, 45, 38)).astype(np.uint8)
    masks = ((rng.random((2, 45, 38)) > 0.4) * 255).astype(np.uint8)
    for x in (imgs, masks):
        np.testing.assert_array_equal(port(getattr(TM, op), x, k, n),
                                      jax_batched(getattr(JM, op), x, k, n))


def test_apply_jet_all_levels():
    levels = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    np.testing.assert_array_equal(port(TCm.apply_jet, levels),
                                  jax_batched(JC.apply_jet, levels))


def test_resize_area_integer_factor_exact(rng):
    imgs = rng.integers(0, 256, (2, 64, 96)).astype(np.uint8)
    for out_hw in ((32, 48), (16, 32), (64, 96)):
        np.testing.assert_array_equal(port(TR.resize_area, imgs, out_hw),
                                      jax_batched(JR.resize_area, imgs, out_hw))
    # a non-integer factor takes the antialiased linear resize (it raised
    # before it was ported), within 1e-4 of JAX's
    np.testing.assert_allclose(port(TR.resize_area, imgs, (20, 30)),
                               jax_batched(JR.resize_area, imgs, (20, 30)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,out_hw", [((2, 128, 128, 5), (32, 32)),
                                          ((2, 40, 30), (20, 15)),
                                          ((1, 8, 8, 3), (64, 64)),
                                          ((2, 40, 30), (17, 45))])
def test_resize_linear_matches_jax_image(rng, shape, out_hw):
    # values in [0, 1], like the cleaned images, features and CAMs
    x = rng.random(shape).astype(np.float32)
    ref = jax_batched(JR.resize_linear, x, out_hw)
    np.testing.assert_allclose(port(TR.resize_linear, x, out_hw), ref,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(8, 64), (32, 256), (30, 17)])
def test_resize_linear_mxu(rng, n_in, n_out):
    np.testing.assert_array_equal(TR._interp_matrix(n_out, n_in),
                                  JR._interp_matrix(n_out, n_in))
    x = rng.random((2, n_in, n_in)).astype(np.float32)
    ref = np.asarray(JR.resize_linear_mxu(jnp.asarray(x), (n_out, n_out)))
    ours = TR.resize_linear_mxu(torch.from_numpy(x), (n_out, n_out)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, jax_batched(JR.resize_linear, x, (n_out, n_out)),
                               rtol=1e-5, atol=1e-6)


def _resample_fresh_tables(x, dim, n_out):
    """`_resample_axis`'s arithmetic on tap tables made anew for the call."""
    idx, taps = TR._triangle_taps(x.shape[dim], n_out)
    idx_t, w_t = torch.as_tensor(idx.copy()), torch.as_tensor(taps.copy())
    shape = [1] * x.ndim
    shape[dim] = n_out
    out = None
    for t in range(idx.shape[1]):
        term = torch.index_select(x, dim, idx_t[:, t]) * w_t[:, t].view(shape)
        out = term if out is None else out + term
    return out


@pytest.mark.parametrize("n_in,n_out", [(3328, 512), (2560, 512), (4608, 512), (2656, 512),
                                        (40, 17), (30, 45), (7, 7)])
@pytest.mark.parametrize("dim", [1, 2])
def test_resample_axis_cached_tables_same_bits(rng, n_in, n_out, dim):
    """The cached tap tables give the bits of tables made for each call,
    on every axis, down (the cleaner's 512² area resize) and up."""
    shape = (2, n_in, 3) if dim == 1 else (2, 3, n_in)
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32))
    want = _resample_fresh_tables(x, dim, n_out)
    for _ in range(2):                     # a miss, then a hit
        got = TR._resample_axis(x, dim, n_out)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_resample_axis_reuses_cached_tables():
    """A second call of a shape hands back the same tensors, made once."""
    TR._device_taps.cache_clear()
    x = torch.rand(1, 3328, 4)
    TR._resample_axis(x, 1, 512)
    first = TR._device_taps(3328, 512, x.device)
    TR._resample_axis(x, 1, 512)
    info = TR._device_taps.cache_info()
    assert (info.misses, info.hits, info.currsize) == (1, 2, 1)
    assert all(a is b for a, b in zip(TR._device_taps(3328, 512, x.device), first))


def test_resample_axis_cache_is_bounded():
    """The tables of at most 64 shapes are kept, the least recent dropped."""
    TR._device_taps.cache_clear()
    for n_in in range(20, 100):
        TR._resample_axis(torch.rand(1, n_in, 1), 1, 11)
    info = TR._device_taps.cache_info()
    assert info.maxsize == 64 and info.currsize == 64 and info.misses == 80
    TR._device_taps.cache_clear()


def test_featurize_on_the_cpu_takes_the_host_path():
    """On the CPU a uint16 scan is widened on the host, as before: nothing
    is staged or pinned, and the features equal the float32 scan's."""
    from cadx_tpu_torch.models import unet
    from cadx_tpu_torch.synthetic import synthetic_native_mammogram
    from cadx_tpu_torch.tools import train
    from cadx_tpu_torch.utils import profiling, staging

    stem = unet.init_resnet_stem(torch.Generator().manual_seed(0))
    img = synthetic_native_mammogram(96, 80, seed=3)
    assert img.dtype == np.uint16
    profiling.reset()
    got = train.featurize(stem, img, (8, 8), "cpu")
    assert "staged_uploads" not in profiling.counts()
    assert staging._stage.cache_info().currsize == 0
    np.testing.assert_array_equal(got, train.featurize(stem, img.astype(np.float32), (8, 8),
                                                       "cpu"))


def test_max_pool_forward_crops_remainders(rng):
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 0] = 5.0          # a tie in one window
    ref = np.asarray(JP.max_pool_ties(jnp.asarray(x), 2))
    ours = TP.max_pool_ties(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)
