"""The premise of the tiled pectoral tail, on the CPU.

The CUDA plan (`csrc/pectoral.cu`) runs the packed watershed
(dist << 2) | label as JAX's sweeps over 64 x 64 halo tiles
(`csrc/tiled_watershed.cuh`, modelled in numpy by
`test_torch_packed_watershed.sweep_model`): on the pectoral tail's own
markers at 64² that model gives the labels of the port's
`marker_watershed_plain` and of the JAX package's packed watershed
(`cadx_tpu/ops/watershed.py::marker_watershed`, which takes
`geodesic_scan.relax_to_fixpoint_packed` at these sizes) after as many
sweeps. Also the wrapper's host-side helpers, and that a CPU call
launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.ops import watershed as JW
from cadx_tpu_torch.kernels import cleaner_front as KF
from cadx_tpu_torch.kernels import gradcam_tail as KGT
from cadx_tpu_torch.kernels import pectoral as KP
from cadx_tpu_torch.kernels import watershed as KW
from cadx_tpu_torch.kernels.largest_obj import largest_obj_reference
from cadx_tpu_torch.ops.morphology import dilate, erode
from cadx_tpu_torch.ops.watershed import marker_watershed_plain
from cadx_tpu_torch.synthetic import pectoral_tile_edge_inputs
from test_torch_packed_watershed import model_labels, sweep_model

HW = 64
VALUES = (255, 128, 64)


def _markers(equ, img_bin, breast):
    """The pectoral tail's watershed markers, from the plain stages."""
    pect = largest_obj_reference(torch.from_numpy(img_bin)[None] > 0, 8, fill=True,
                                 max_iters=HW * HW).to(torch.uint8)
    markers = torch.zeros(pect.shape, dtype=torch.int32)
    markers = torch.where(erode(pect, 3, 7) > 0, 255, markers)
    markers = torch.where(dilate(pect, 3, 7) == 0, 128, markers)
    return torch.where(torch.from_numpy(breast)[None] == 0, 64, markers)[0].numpy()


@pytest.mark.parametrize("image", [0, 3, 8, 9])
def test_tile_relaxation_reaches_the_plain_and_jax_labels(image):
    equ, img_bin, breast = (a[image] for a in pectoral_tile_edge_inputs(HW, HW))
    markers = _markers(equ, img_bin, breast)
    plain, _ = marker_watershed_plain(torch.from_numpy(equ)[None],
                                      torch.from_numpy(markers)[None], max_iters=HW * HW,
                                      max_scan=8, marker_label_values=VALUES)
    jax_labels, _ = JW.marker_watershed(jnp.asarray(equ, jnp.float32), jnp.asarray(markers),
                                        max_iters=HW * HW, max_scan=8,
                                        marker_label_values=VALUES)
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(jax_labels))
    pk, sweeps = sweep_model(equ.astype(np.float32), markers, VALUES, HW * HW, 8)
    np.testing.assert_array_equal(model_labels(pk, VALUES), plain[0].numpy())
    assert 1 <= sweeps < HW * HW


def test_watershed_tiles_fill_the_card():
    """The plan's steps run cleaner_front's tiles, which give one image of
    the 512² upload 256 blocks a launch, at least one an SM of the H100's
    132; so do the watershed's sweeps there (32 x 32, there being fewer
    64 x 64 tiles than SMs), and 64 x 64 at run_pipeline's B=64 256²."""
    assert KP.TILE == KF.TILE
    assert KW.sweep_tiles(1, 512, 512) == (-(-512 // KP.TILE)) ** 2
    assert KW.sweep_tile(64, 256, 256) == 2 * KP.TILE
    assert (-(-512 // KP.TILE)) ** 2 >= 132


def test_scratch_bytes():
    """A uint64 key an image, four int32 (the watershed's changed flags and
    sweeps), four int32 planes, three byte planes and two bytes a tile;
    under the one-block kernel's six int32 planes an image."""
    assert KP.scratch_bytes(2, 45, 70) == 8 * 2 + 16 + 19 * 2 * 45 * 70 + 2 * 2 * 2 * 3
    assert KP.scratch_bytes(64, 256, 256) < 24 * 64 * 256 * 256


@pytest.mark.parametrize("case", ["cpu tensors", "even morph_k"])
def test_wrapper_refuses_before_launching(case):
    """The plan takes CUDA tensors only (a CPU tensor reaches it only by a
    direct call, which raises), and the tail refuses an even morph_k with
    n_morph > 1, whose composed window the fused bands do not anchor as
    the composed erode and dilate do; neither launches anything."""
    equ, img_bin, breast = (torch.from_numpy(a[:1]) for a in pectoral_tile_edge_inputs(45, 70))
    before = KP.pectoral_tail.launches
    with pytest.raises(ValueError):
        if case == "cpu tensors":
            KP.run_plan(equ, img_bin, breast)
        else:
            KP.pectoral_tail(equ, img_bin, breast, morph_k=4, n_morph=7)
    assert KP.pectoral_tail.launches == before


def test_gradcam_bands_fill_the_card():
    """16 rows a band where that gives two blocks an SM, else fewer rows."""
    assert KGT.band_rows(64, 256) == 16
    for b, oh in ((1, 256), (2, 256), (8, 512), (64, 256), (3, 37)):
        rows = KGT.band_rows(b, oh)
        assert 1 <= rows <= 16
        assert rows == 1 or b * -(-oh // rows) >= 2 * 132


def test_cpu_call_launches_nothing():
    equ, img_bin, breast = (torch.from_numpy(a[:2]) for a in pectoral_tile_edge_inputs(45, 70))
    before = KP.pectoral_tail.launches
    got = KP.pectoral_tail(equ, img_bin, breast)
    assert KP.pectoral_tail.launches == before
    for a, b in zip(got, KP.pectoral_tail_reference(equ, img_bin, breast)):
        assert torch.equal(a, b)
