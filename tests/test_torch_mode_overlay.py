"""Port parity: mode against the JAX Pallas kernel, and the form rules of
the mode and jet_blend kernels.

`kernels/mode.py::largest_component_mask_reference` is what a CPU tensor
runs beside the CUDA kernel. It is held bit-exact to
`largest_component_mask_pallas` run in interpret mode, as
`tests/test_kernels.py` runs it, on the CCL labels of CAM-like masks
(CAM >= 0.6 of its peak, as `xai/roi.py` forms them) at the Pallas
kernel's power-of-two sides, with an exact area tie and an empty image in
each batch. The wrappers' choice of form (`form_for`, the C entry points'
rule) is plain Python and is pinned at its edges here, and so is the
premise of the jet_blend kernel's division (one residual correction gives
the rounded quotient exactly); the kernels themselves run only on the
card (`tests/test_torch_cuda.py`).
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.kernels.mode import largest_component_mask_pallas
from cadx_tpu_torch.kernels import ccl as KC
from cadx_tpu_torch.kernels import mode as KM
from cadx_tpu_torch.kernels import overlay as KOv


def _cam_batch(side: int, seed: int) -> np.ndarray:
    """B=3: a CAM mask, two equal squares (an exact tie), an empty mask."""
    rng = np.random.default_rng(seed)
    cam = rng.random((side, side)).astype(np.float32)
    m = np.zeros((3, side, side), bool)
    m[0] = cam >= 0.6 * cam.max()
    q = max(side // 4, 1)
    m[1, :q, :q] = True
    m[1, side - q:, side - q:] = True
    return m


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("side", [8, 64])
def test_mode_plain_matches_pallas(side, conn):
    m = _cam_batch(side, seed=side + conn)
    labels = KC.label_components_reference(torch.from_numpy(m), conn, side * side)
    want = np.asarray(largest_component_mask_pallas(jnp.asarray(labels.numpy()), jnp.asarray(m),
                                                    interpret=True))
    before = KM.largest_component_mask.launches
    got = KM.largest_component_mask(labels, torch.from_numpy(m))
    assert KM.largest_component_mask.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    # the tie goes to the smaller label (the top-left square); empty stays empty
    q = max(side // 4, 1)
    assert got[1].sum() == q * q and bool(got[1, 0, 0]) and not got[2].any()


def test_mode_plain_skips_labels_out_of_range():
    """A foreground label outside [0, H*W) is not counted and never chosen:
    the kernel's rule, which the plain version states."""
    m = torch.zeros((3, 12, 12), dtype=torch.bool)
    m[0, :, :6] = True
    m[1, 5, 5] = True
    m[2, 2:4, 2:4] = True
    labels = torch.zeros((3, 12, 12), dtype=torch.int32)
    labels[0, :, :3] = -5           # 36 pixels, negative
    labels[0, :2, 3:6] = 144        # 6 pixels, = H*W
    labels[0, 2:, 3:6] = 7          # 30 pixels, counted
    labels[1, 5, 5] = 1000
    labels[2, 2:4, 2:4] = 26
    got = KM.largest_component_mask(labels, m)
    want = torch.zeros_like(m)
    want[0, 2:, 3:6] = True
    want[2, 2:4, 2:4] = True
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw,form", [((64, 64), "cluster"), ((65, 64), "wide"),
                                     ((64, 65), "wide"), ((1, 64), "block"),
                                     ((6, 6), "block"), ((62, 62), "cluster"),
                                     ((32, 32), "block"), ((32, 33), "cluster"),
                                     ((256, 256), "wide"), ((1, 4096), "wide")])
def test_mode_form_for(hw, form):
    """The block form up to 1,024 pixels, the cluster form up to 64 x 64 (a
    side, not an area), the wide form beyond; the C entry point's codes."""
    assert KM.form_for(*hw) == form
    assert KM.FORM_CODES == {"wide": 0, "block": 1, "cluster": 2}
    assert KM.ONE_BLOCK_PIXELS == 32 * 32 and KM.CLUSTER_BLOCKS == 8


@pytest.mark.parametrize("bhw,form", [((1, 512, 512), "once"), ((8, 512, 512), "wide"),
                                      ((4, 512, 512), "once"), ((1, 1536, 1280), "wide"),
                                      ((1, 1024, 1056), "once"), ((1, 1024, 1057), "wide"),
                                      ((132, 64, 64), "once"), ((133, 64, 64), "wide"),
                                      ((16, 256, 256), "once"), ((17, 256, 256), "wide"),
                                      ((64, 256, 256), "wide"), ((3, 37, 53), "once"),
                                      ((1, 1, 1), "once")])
def test_overlay_form_for(bhw, form):
    """The one-launch form where the images fit 132 blocks (an H100 SXM's
    SMs, one block an SM) of 512 threads, 16 pixels a thread; else the wide
    form. Fewer SMs move the edge."""
    assert KOv.MAX_THREADS * KOv.GROUP == 8192 and KOv.H100_SMS == 132
    assert KOv.form_for(*bhw) == form
    b, h, w = bhw
    blocks = b * max(1, -(-(h * w // 16) // 512))
    assert KOv.form_for(b, h, w, sms=blocks) == "once"
    assert KOv.form_for(b, h, w, sms=blocks - 1) == "wide"


def _rn32(fr: Fraction) -> np.float32:
    """A rational rounded to the nearest float32, ties to even (normal
    range; a negative one by symmetry)."""
    if fr < 0:
        return -_rn32(-fr)
    if fr == 0:
        return np.float32(0.0)
    e = fr.numerator.bit_length() - fr.denominator.bit_length()
    while Fraction(2) ** e > fr:
        e -= 1
    while Fraction(2) ** (e + 1) <= fr:
        e += 1
    scaled = fr / Fraction(2) ** (e - 23)
    n, r = divmod(scaled.numerator, scaled.denominator)
    if 2 * r > scaled.denominator or (2 * r == scaled.denominator and n % 2):
        n += 1
    return np.float32(n * 2.0 ** (e - 23))


def test_jet_quotient_correction_is_exact():
    """The jet_blend kernel's exact path (csrc/overlay.cu::fast_byte): with
    rcp = RN(1 / peak), q0 = RN(b * rcp), e = b - q0 * peak and q = q0 + e *
    rcp each rounded once (two FMAs, computed here in exact rationals), q
    is RN(b / peak), so trunc(RN(q * 255)) is the plain version's byte.
    Blends as the paths make them (the table's jet / 255 plus u8 / 255
    images), anywhere in the path's range [2^-40, peak <= 2^40], and
    quotients next to a byte boundary."""
    rng = np.random.default_rng(7)
    table = np.arange(256, dtype=np.float32) * np.float32(1.0 / 255.0)
    cases = []
    for _ in range(1500):
        b, p = (table[rng.integers(0, 256)] + np.float32(rng.integers(0, 256)) / np.float32(255)
                for _ in range(2))
        cases.append((min(b, p), max(b, p, np.float32(1e-7))))
    for _ in range(1500):
        p = np.float32(2.0 ** rng.uniform(-23, 40))
        cases.append((np.float32(p * 2.0 ** rng.uniform(-40, 0)), p))
    for _ in range(1000):
        p = np.float32(rng.uniform(0.5, 2.0))
        b = np.float32(p * (rng.integers(0, 256) / 255.0))
        cases.append((np.nextafter(b, np.float32(rng.choice([-1, 1]) * np.inf)) if b > 0 else b, p))
    checked = 0
    for b, p in cases:
        if b > p or (0 < b < 2.0 ** -40):
            continue
        checked += 1
        rcp = np.float32(1.0) / p
        q0 = np.float32(b * rcp)
        e = _rn32(Fraction(float(b)) - Fraction(float(q0)) * Fraction(float(p)))
        q = _rn32(Fraction(float(q0)) + Fraction(float(e)) * Fraction(float(rcp)))
        assert q == np.float32(b / p), (b, p)
        v = np.float32(q * np.float32(255.0))
        assert int(math.floor(v)) == int(v.astype(np.int64)) % 256
    assert checked > 3500
