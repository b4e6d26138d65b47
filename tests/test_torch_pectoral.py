"""The premise of the tiled pectoral tail, on the CPU.

The CUDA plan (`csrc/pectoral.cu`) relaxes the packed watershed
(dist << 2) | label a tile at a time, each tile to its own fixpoint under
a 1-pixel halo of its neighbours' current values, in whatever order the
blocks run, until no tile is dirty. Every step cost is positive and
values only fall, so the min-plus fixpoint is unique: here a numpy
relaxation done that way, 8 x 8 tiles at 64² in shuffled tile orders,
gives the labels of the port's `marker_watershed_plain` and of the JAX
package's packed watershed (`cadx_tpu/ops/watershed.py::marker_watershed`,
which takes `geodesic_scan.relax_to_fixpoint_packed` at these sizes) on the
same seeded inputs. Also the wrapper's host-side helpers, and that a CPU
call launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.ops import watershed as JW
from cadx_tpu_torch.kernels import cleaner_front as KF
from cadx_tpu_torch.kernels import gradcam_tail as KGT
from cadx_tpu_torch.kernels import pectoral as KP
from cadx_tpu_torch.kernels.largest_obj import largest_obj_reference
from cadx_tpu_torch.ops.morphology import dilate, erode
from cadx_tpu_torch.ops.watershed import marker_watershed_plain
from cadx_tpu_torch.synthetic import pectoral_tile_edge_inputs

HW = 64
TILE = 8
VALUES = (255, 128, 64)
UNREACHED = 1 << 30


def _markers(equ, img_bin, breast):
    """The pectoral tail's watershed markers, from the plain stages."""
    pect = largest_obj_reference(torch.from_numpy(img_bin)[None] > 0, 8, fill=True,
                                 max_iters=HW * HW).to(torch.uint8)
    markers = torch.zeros(pect.shape, dtype=torch.int32)
    markers = torch.where(erode(pect, 3, 7) > 0, 255, markers)
    markers = torch.where(dilate(pect, 3, 7) == 0, 128, markers)
    return torch.where(torch.from_numpy(breast)[None] == 0, 64, markers)[0].numpy()


def _relax_tile(pk, q, y0, x0, log_k):
    """One tile of pk (in place) to its fixpoint under its halo's current
    values: rows left to right and back, then columns down and up, until a
    round changes nothing; returns which of its edges (top, bottom, left,
    right) a pixel fell on."""
    h, w = pk.shape
    ys, xs = slice(y0, min(y0 + TILE, h)), slice(x0, min(x0 + TILE, w))
    start = pk[ys, xs].copy()

    def scan(line_pk, line_q, lo, hi, step):
        prev = line_pk[lo - step] if 0 <= lo - step < len(line_pk) else UNREACHED
        qprev = line_q[lo - step] if 0 <= lo - step < len(line_q) else 0
        fell = False
        for i in range(lo, hi, step):
            cand = prev + (((abs(int(line_q[i]) - int(qprev)) << log_k) + 1) << 2)
            if cand < line_pk[i]:
                line_pk[i] = cand
                fell = True
            prev, qprev = line_pk[i], line_q[i]
        return fell

    more = True
    while more:
        more = False
        for y in range(ys.start, ys.stop):
            more |= scan(pk[y], q[y], xs.start, xs.stop, 1)
            more |= scan(pk[y], q[y], xs.stop - 1, xs.start - 1, -1)
        for x in range(xs.start, xs.stop):
            more |= scan(pk[:, x], q[:, x], ys.start, ys.stop, 1)
            more |= scan(pk[:, x], q[:, x], ys.stop - 1, ys.start - 1, -1)
    fell = pk[ys, xs] < start
    last_row, last_col = fell.shape[0] == TILE, fell.shape[1] == TILE
    return (fell[0].any(), last_row and fell[-1].any(), fell[:, 0].any(),
            last_col and fell[:, -1].any())


def _tiled_watershed(equ, markers, order_seed):
    """The packed watershed relaxed tile by tile in shuffled orders: each
    pass takes the dirty tiles in a random order, and a tile whose edge
    pixel fell marks that neighbour dirty for the next pass."""
    h, w = equ.shape
    log_k = max(h + w - 1, 1).bit_length()
    small = np.zeros(markers.shape, np.int64)
    for i, v in enumerate(VALUES):
        small[markers == v] = i + 1
    pk = np.where(small > 0, small, UNREACHED)
    ty, tx = -(-h // TILE), -(-w // TILE)
    dirty = {(a, b) for a in range(ty) for b in range(tx)}
    rng = np.random.default_rng(order_seed)
    passes = 0
    while dirty:
        passes += 1
        todo, dirty = sorted(dirty), set()
        for k in rng.permutation(len(todo)):
            a, b = todo[k]
            top, bottom, left, right = _relax_tile(pk, equ, a * TILE, b * TILE, log_k)
            for on, nb in ((top, (a - 1, b)), (bottom, (a + 1, b)), (left, (a, b - 1)),
                           (right, (a, b + 1))):
                if on and 0 <= nb[0] < ty and 0 <= nb[1] < tx:
                    dirty.add(nb)
    labels = np.zeros(markers.shape, np.int32)
    for i, v in enumerate(VALUES):
        labels[(pk & 3) == i + 1] = v
    return labels, passes


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
    for seed in range(3):
        labels, passes = _tiled_watershed(equ.astype(np.int64), markers, seed)
        np.testing.assert_array_equal(labels, plain[0].numpy())
        assert passes >= 1


def test_watershed_tiles_fill_the_card():
    """The watershed runs the tiles of the plan's other steps, which give
    one image of the 512² upload 256 blocks a launch, at least one an SM
    of the H100's 132."""
    assert KP.TILE == KF.TILE
    assert (-(-512 // KP.TILE)) ** 2 >= 132


def test_scratch_bytes():
    """A uint64 key an image, four int32 (the watershed's changed flags and
    rounds), two int32 planes, three byte planes and two dirty bytes a
    tile; under the one-block kernel's six int32 planes an image."""
    assert KP.scratch_bytes(2, 45, 70) == 8 * 2 + 16 + 11 * 2 * 45 * 70 + 2 * 2 * 2 * 3
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
