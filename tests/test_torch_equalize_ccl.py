"""Port parity: equalize and ccl against the JAX Pallas kernels.

The plain versions beside the two CUDA kernels
(`kernels/equalize.py::equalize_reference`,
`kernels/ccl.py::label_components_reference`) are what a CPU tensor runs.
They are held bit-exact to `equalize_hist_pallas` and
`label_components_pallas` run in interpret mode, as `tests/test_kernels.py`
runs them: equalize on the inputs that break an equalize kernel
(`synthetic.equalize_edge_cases`), ccl on the inputs that break a tiled CCL
(`synthetic.tile_edge_cases`) at the serving path's CAM sides and ragged
shapes, both at the JAX function's sweep cap of 128. The wrappers' own
layout logic (the output placed at the input's address modulo 16, the
choice of ccl's form) is plain Python and is tested here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.kernels.ccl import label_components_pallas
from cadx_tpu.kernels.equalize import equalize_hist_pallas
from cadx_tpu_torch.kernels import ccl as KC
from cadx_tpu_torch.kernels import equalize as KE
from cadx_tpu_torch.synthetic import equalize_edge_cases, tile_edge_cases


@pytest.mark.parametrize("case", sorted(equalize_edge_cases()))
def test_equalize_matches_pallas(case):
    """Zero background (64² mammograms), all zero, one level, one nonzero
    pixel, a 0-255 ramp, LUT entries on .5 and an odd-n batch."""
    x = equalize_edge_cases()[case]
    want = np.asarray(equalize_hist_pallas(jnp.asarray(x), interpret=True))
    got = KE.equalize(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_equalize_narrow_case_rounds_half_to_even():
    """The narrow image's LUT entries (cdf - cdf_min) * 255 / 510 are 0.5,
    1.5, ..., 50.5: half to even maps them to 0, 2, 2, 4, 4, ..., 50, 50."""
    x = torch.from_numpy(equalize_edge_cases()["narrow, LUT on .5"])
    out = KE.equalize(x)
    for level in range(11, 62):
        half = (2 * (level - 11) + 1) / 2
        assert int(out[x == level][0]) == 2 * round(half / 2)
    assert int(out[x == 10][0]) == 0 and int(out[x == 62][0]) == 255


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("hw", [(62, 62), (6, 6), (64, 64), (45, 70), (1, 70), (70, 1)])
def test_ccl_matches_pallas(hw, conn):
    """The twelve tile edge cases, labels and background value alike."""
    m = tile_edge_cases(*hw) > 0
    want = np.asarray(label_components_pallas(jnp.asarray(m), connectivity=conn,
                                              interpret=True))
    got = KC.label_components(torch.from_numpy(m), conn)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ccl_matches_pallas_cam_masks():
    """The serving path's CAM masks (CAM >= 0.6 of its peak) at B=3 62x62."""
    rng = np.random.default_rng(5)
    cams = rng.random((3, 62, 62)).astype(np.float32)
    m = cams >= 0.6 * cams.max(axis=(1, 2), keepdims=True)
    want = np.asarray(label_components_pallas(jnp.asarray(m), interpret=True))
    np.testing.assert_array_equal(KC.label_components(torch.from_numpy(m)).numpy(), want)


@pytest.mark.parametrize("offset", [0, 1, 7, 15])
def test_equalize_output_alignment(offset):
    """The wrapper places its output at the input's address modulo 16 (the
    kernel pairs 16-byte loads and stores), for views at any offset."""
    base = torch.zeros(4 * 37 * 53 + 16, dtype=torch.uint8)
    x = base[offset:offset + 3 * 37 * 53].view(3, 37, 53)
    out = KE._aligned_like(x)
    assert out.shape == x.shape and out.dtype == x.dtype and out.is_contiguous()
    assert (out.data_ptr() - x.data_ptr()) % 16 == 0


@pytest.mark.parametrize("hw,form", [((62, 62), "cluster"), ((6, 6), "cluster"),
                                     ((64, 64), "cluster"), ((1, 64), "cluster"),
                                     ((65, 64), "tiled"), ((64, 65), "tiled"),
                                     ((256, 256), "tiled")])
def test_ccl_form_for(hw, form):
    """The cluster form up to 64 x 64 (the serving CAM masks), the tiled
    form beyond."""
    assert KC.form_for(*hw) == form
