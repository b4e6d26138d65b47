"""The premise of the packed marker watershed's tiled kernel, on the CPU.

`cadx_watershed_packed` (`csrc/watershed.cu`) runs a prologue (q =
rint(image), the packed markers, the first round's dirty flags), rounds
of the shared tile relaxation (`csrc/tiled_watershed.cuh`: every dirty
32 x 32 tile relaxed to its own fixpoint under a 1-pixel halo of its
neighbours' current values, in whatever order the blocks run, marking
dirty in the other parity each neighbour along an edge where a pixel
fell) until a round marks no tile, and an epilogue (the labels and the
ridge). A numpy model of those three steps, in shuffled tile orders, is
held against the port's `marker_watershed_plain` and the JAX package's
`geodesic_scan.relax_to_fixpoint_packed` on float images with ranges
beyond 255 and half-integer values (rint's ties). Also: the even-kernel
`process` path, which runs the packed form, against JAX's; a serpentine
where JAX's 256-sweep cap binds; the wrapper's host-side helpers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.ops import geodesic_scan as JG
from cadx_tpu.ops import watershed as JW
from cadx_tpu.preprocess import cleaner as JCl
from cadx_tpu_torch.kernels import watershed as KW
from cadx_tpu_torch.ops.watershed import marker_watershed_plain
from cadx_tpu_torch.preprocess import cleaner as TCl
from cadx_tpu_torch.synthetic import synthetic_mammograms

TILE = KW.PACKED_TILE
UNREACHED = 1 << 30


def _scan_lines(pk, q, log_k, reverse):
    """Relax every line (row) of the (n, len) tile views from the previous
    pixel in the scan, in place, the lines together; returns whether any
    value fell. Column 0 (or the last) is the halo."""
    fell = False
    cols = range(pk.shape[1] - 2, 0, -1) if reverse else range(1, pk.shape[1] - 1)
    step = 1 if reverse else -1
    for x in cols:
        cand = pk[:, x + step] + (((np.abs(q[:, x] - q[:, x + step]) << log_k) + 1) << 2)
        low = cand < pk[:, x]
        if low.any():
            pk[low, x] = cand[low]
            fell = True
    return fell


def _relax_tile(pk, q, y0, x0, log_k):
    """relax_one: tile (y0, x0) of pk to its fixpoint under its halo; pixels
    outside the image stay unreached. Returns the edges (top, bottom, left,
    right) along which a pixel of the tile fell."""
    h, w = pk.shape
    ys, xs = slice(max(y0 - 1, 0), min(y0 + TILE + 1, h)), slice(max(x0 - 1, 0),
                                                                 min(x0 + TILE + 1, w))
    # the region with its halo, cut to the image and padded with unreached
    region = np.full((TILE + 2, TILE + 2), UNREACHED, np.int64)
    rq = np.zeros((TILE + 2, TILE + 2), np.int64)
    oy, ox = ys.start - (y0 - 1), xs.start - (x0 - 1)
    region[oy:oy + ys.stop - ys.start, ox:ox + xs.stop - xs.start] = pk[ys, xs]
    rq[oy:oy + ys.stop - ys.start, ox:ox + xs.stop - xs.start] = q[ys, xs]
    rows, cols = min(TILE, h - y0), min(TILE, w - x0)
    start = region[1:1 + rows, 1:1 + cols].copy()
    # the tile's own pixels outside the image are never relaxed: a scan
    # only runs over the first rows x cols of a line
    more = True
    while more:
        more = False
        for reverse in (False, True):
            sub = region[1:1 + rows, 0:cols + 2].copy()
            more |= _scan_lines(sub, rq[1:1 + rows, 0:cols + 2], log_k, reverse)
            region[1:1 + rows, 0:cols + 2] = sub
        for reverse in (False, True):
            sub = region[0:rows + 2, 1:1 + cols].T.copy()
            more |= _scan_lines(sub, rq[0:rows + 2, 1:1 + cols].T, log_k, reverse)
            region[0:rows + 2, 1:1 + cols] = sub.T
    now = region[1:1 + rows, 1:1 + cols]
    fell = now < start
    pk[y0:y0 + rows, x0:x0 + cols] = np.minimum(pk[y0:y0 + rows, x0:x0 + cols], now)
    return (fell[0].any(), rows == TILE and fell[-1].any(), fell[:, 0].any(),
            cols == TILE and fell[:, -1].any())


def _kernel_model(img, markers, values, order_seed):
    """The kernel's three steps in numpy: (labels, boundary, rounds)."""
    h, w = img.shape
    log_k = max(h + w - 1, 1).bit_length()
    # prologue: q = rint, the packed markers (later values win), dirty
    q = np.rint(img).astype(np.int64)
    small = np.zeros(markers.shape, np.int64)
    for i, v in enumerate(values):
        small[markers == v] = i + 1
    pk = np.where(small > 0, small, UNREACHED)
    ty, tx = -(-h // TILE), -(-w // TILE)
    dirty = np.zeros((2, ty, tx), bool)
    for a in range(ty):
        for b in range(tx):
            dirty[0, a, b] = (small[a * TILE:(a + 1) * TILE, b * TILE:(b + 1) * TILE] == 0).any()
    # rounds: parity r & 1 read, the other marked, until a round marks none
    rng = np.random.default_rng(order_seed)
    rounds = 0
    while True:
        cur, nxt = dirty[rounds & 1], dirty[(rounds + 1) & 1]
        rounds += 1
        marked = False
        for k in rng.permutation(ty * tx):
            a, b = divmod(int(k), tx)
            if not cur[a, b]:
                continue
            cur[a, b] = False
            edges = _relax_tile(pk, q, a * TILE, b * TILE, log_k)
            for on, (na, nb) in zip(edges, ((a - 1, b), (a + 1, b), (a, b - 1), (a, b + 1))):
                if on and 0 <= na < ty and 0 <= nb < tx:
                    nxt[na, nb] = True
                    marked = True
        if not marked:
            break
    # epilogue: values back, the ridge between positive labels, the frame
    table = np.array((0,) + tuple(values), np.int64)
    labels = table[pk & 3]
    pad = np.pad(labels, 1)
    ridge = np.zeros((h, w), bool)
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        nb = pad[dy:dy + h, dx:dx + w]
        ridge |= (nb > 0) & (labels > 0) & (nb != labels)
    ridge[0], ridge[-1], ridge[:, 0], ridge[:, -1] = True, True, True, True
    return labels.astype(np.int32), ridge, rounds


def _inputs(h, w, seed, top, n_values):
    """A smooth field plus noise in [0, top], half of its pixels at x.5
    (rint's ties to even), and markers: discs and bands of up to three
    values with the rest unlabeled."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = top * (0.5 + 0.5 * np.sin(xx / (3 + w / 9)) * np.cos(yy / (4 + h / 11)))
    img = np.clip(field + rng.normal(0, top / 20, (h, w)), 0, top)
    img = np.floor(img) + np.where(rng.random((h, w)) < 0.5, 0.5, 0.0)
    values = (255, 128, 64)[:n_values]
    markers = np.zeros((h, w), np.int32)
    for i, v in enumerate(values):
        for _ in range(2):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            markers[(yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) // 10 + 1) ** 2] = v
    markers[-1, : w // 3] = values[-1]
    return img.astype(np.float32), markers, values


@pytest.mark.parametrize("h,w,top,n_values", [(64, 64, 1500, 3), (200, 136, 1000, 3),
                                              (64, 64, 4000, 2), (200, 136, 300, 1)])
def test_kernel_model_reaches_the_plain_and_jax_labels(h, w, top, n_values):
    img, markers, values = _inputs(h, w, h * w + top, top, n_values)
    plain, plain_ridge = marker_watershed_plain(
        torch.from_numpy(img)[None], torch.from_numpy(markers)[None], max_iters=h * w,
        max_scan=8, marker_label_values=values)
    jax_labels = JG.relax_to_fixpoint_packed(JW._shift, jnp.asarray(img), jnp.asarray(markers),
                                             h * w, 8, label_values=values)
    jax_ridge = JG.label_boundary(JW._shift, jax_labels) == 1
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(jax_labels))
    np.testing.assert_array_equal(plain_ridge[0].numpy(), np.asarray(jax_ridge))
    for seed in range(2):
        labels, ridge, rounds = _kernel_model(img, markers, values, seed)
        np.testing.assert_array_equal(labels, plain[0].numpy())
        np.testing.assert_array_equal(ridge, plain_ridge[0].numpy())
        assert 1 <= rounds <= h * w + 1


@pytest.mark.parametrize("case", ["no markers", "all markers", "one pixel"])
def test_kernel_model_edge_inputs(case):
    """Nothing to relax: every tile dirty and no pixel falls (1 round), or
    no tile dirty (1 round); and a 1 x 1 image."""
    h, w = (1, 1) if case == "one pixel" else (45, 70)
    img = np.arange(h * w, dtype=np.float32).reshape(h, w) % 7
    markers = np.full((h, w), 128 if case == "all markers" else 0, np.int32)
    values = (255, 128, 64)
    plain, plain_ridge = marker_watershed_plain(
        torch.from_numpy(img)[None], torch.from_numpy(markers)[None], max_iters=h * w + 1,
        max_scan=8, marker_label_values=values)
    labels, ridge, rounds = _kernel_model(img, markers, values, 0)
    np.testing.assert_array_equal(labels, plain[0].numpy())
    np.testing.assert_array_equal(ridge, plain_ridge[0].numpy())
    assert rounds == 1


def _serpentine(side, wall):
    """A 1-pixel corridor of value 0 winding down rows 0, 2, 4, ... (joined
    at alternate ends) between walls of value `wall`; marker 255 at its
    start, marker 128 on the wall's far corner."""
    img = np.full((side, side), wall, np.float32)
    img[::2] = 0
    for r in range(1, side, 2):
        img[r, side - 1 if (r // 2) % 2 == 0 else 0] = 0
    markers = np.zeros((side, side), np.int32)
    markers[0, 0] = 255
    markers[1, 0] = 128
    return img, markers


def test_serpentine_where_jax_cap_binds():
    """JAX's packed relaxation stops at its 256-sweep cap (max_scan 8, as
    the cleaner calls it) before the corridor is flooded; the port's plain
    version is capped the same way and gives JAX's labels; the kernel runs
    to the fixpoint (its numpy model, and the plain version uncapped),
    where marker 255 holds the whole corridor."""
    side, values = 128, (255, 128, 64)
    img, markers = _serpentine(side, 200)
    jax_capped = np.asarray(JG.relax_to_fixpoint_packed(
        JW._shift, jnp.asarray(img), jnp.asarray(markers), 256, 8, label_values=values))
    capped, _ = marker_watershed_plain(torch.from_numpy(img)[None],
                                       torch.from_numpy(markers)[None], max_iters=256,
                                       max_scan=8, marker_label_values=values)
    np.testing.assert_array_equal(capped[0].numpy(), jax_capped)
    fixpoint, _ = marker_watershed_plain(torch.from_numpy(img)[None],
                                         torch.from_numpy(markers)[None], max_iters=side * side,
                                         max_scan=8, marker_label_values=values)
    labels, _, _ = _kernel_model(img, markers, values, 0)
    np.testing.assert_array_equal(labels, fixpoint[0].numpy())
    corridor = img == 0
    assert (labels[corridor] == 255).all()
    # the cap binds: the corridor's far end is still held by 128 or unreached
    differ = labels != jax_capped
    assert differ.sum() > side
    assert (jax_capped[corridor] != 255).sum() == differ[corridor].sum()


@pytest.mark.parametrize("h,w", [(256, 256), (200, 136)])
def test_even_kernel_process_matches_jax(h, w):
    """process(..., pect_removal=True, morph_kn_size=4, n_morph_op=7): the
    composed pectoral branch with the packed watershed, which the card runs
    through `cadx_watershed_packed`; exact against JAX's process."""
    mammos = synthetic_mammograms(2, max(h, w), seed=7)[:, :h, :w]
    kwargs = dict(pect_removal=True, morph_kn_size=4, n_morph_op=7)
    ours, res = TCl.process(torch.from_numpy(np.ascontiguousarray(mammos)), **kwargs)
    for i, img in enumerate(mammos):
        ref, ref_res = JCl.process(jnp.asarray(img), **kwargs)
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref))
        for name in ref_res._fields:
            np.testing.assert_array_equal(getattr(res, name)[i].numpy(),
                                          np.asarray(getattr(ref_res, name)), err_msg=name)
        assert np.asarray(ref_res.boundary)[1:-1, 1:-1].any()


def test_packed_host_helpers():
    """Scratch: q and pk (int32 planes), four int32, two dirty bytes a
    tile; the design's floor: 16 + 12 a round + 9 bytes a pixel."""
    assert KW.packed_tiles(2, 45, 70) == 2 * 2 * 3
    assert KW.packed_tiles(1, 512, 512) == 256
    assert KW.packed_scratch_bytes(2, 45, 70) == 8 * 2 * 45 * 70 + 16 + 2 * 12
    assert KW.packed_floor_bytes(1, 512, 512, 5) == (16 + 60 + 9) * 512 * 512


def test_cpu_call_takes_the_plain_version():
    img, markers, values = _inputs(45, 70, 3, 300, 3)
    before = KW.packed_form.launches, KW.marker_watershed.launches
    got = KW.marker_watershed(torch.from_numpy(img)[None], torch.from_numpy(markers)[None],
                              max_scan=8, marker_label_values=values)
    assert (KW.packed_form.launches, KW.marker_watershed.launches) == before
    want = marker_watershed_plain(torch.from_numpy(img)[None], torch.from_numpy(markers)[None],
                                  max_scan=8, marker_label_values=values)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
