"""The packed marker watershed's kernel design, on the CPU.

`cadx_watershed_packed` (`csrc/watershed.cu`) and the pectoral tail
(`csrc/pectoral.cu`) run the same relaxation
(`csrc/tiled_watershed.cuh::relax_capped`): JAX's packed sweeps
(`cadx_tpu/ops/geodesic_scan.py::relax_to_fixpoint_packed`) until one
changes nothing or `max_iters` ran. Where both scan windows are at most 8
a sweep runs over 64 x 64 tiles (32 x 32 where there would be fewer of
those than SMs), each copied with a halo of win - 1 pixels (cut to the
image) and relaxed by the four directional passes in
its own copy, each pass leaving valid a region smaller by its halo on
the side it reads from; wider windows run each pass a line at a time. A
numpy model of that design, with every value a pass does not define
poisoned so that a read of one would show, is held against JAX's sweeps
after each sweep (the packed planes, the labels and the sweeps run) at
several `max_iters` and `max_scan`; on a serpentine where JAX's 256-sweep
cap binds it gives JAX's capped labels. Also: the pectoral tail on a
serpentine equalized image against JAX's `pectoral_tail_pallas` in
interpret mode, the even-kernel `process` path against JAX's, and the
wrapper's host-side helpers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.kernels.pectoral import pectoral_tail_pallas
from cadx_tpu.ops import geodesic_scan as JG
from cadx_tpu.ops import watershed as JW
from cadx_tpu.preprocess import cleaner as JCl
from cadx_tpu_torch.kernels import pectoral as KP
from cadx_tpu_torch.kernels import watershed as KW
from cadx_tpu_torch.ops.watershed import marker_watershed_plain
from cadx_tpu_torch.preprocess import cleaner as TCl
from cadx_tpu_torch.synthetic import synthetic_mammograms

UNREACHED = 1 << 30
POISON = -(1 << 50)   # a value no pass defines; reading one would corrupt the result
VALUES = (255, 128, 64)


def _window(length, max_scan):
    n, win, k = min(length, max_scan), 1, 1
    while k < n:
        win += k
        k *= 2
    return win


def _pass(a, s, reverse, win):
    """One directional pass along the last axis: min over the window of
    the pre-pass t = a -/+ s, positions outside the line unreached."""
    t = a + s if reverse else a - s
    pad = np.full(t.shape[:-1] + (win - 1,), UNREACHED, np.int64)
    tp = np.concatenate([t, pad] if reverse else [pad, t], axis=-1)
    length = t.shape[-1]
    w = np.min([tp[..., j:j + length] for j in range(win)], axis=0)
    return np.minimum(a, w - s if reverse else w + s)


def _costs(img):
    """srow, scol: the packed prefix sums, int64."""
    h, w = img.shape
    k = 1
    while k < h + w:
        k *= 2
    q = np.rint(img).astype(np.int64)
    crow = np.zeros_like(q)
    crow[:, 1:] = np.abs(np.diff(q, axis=1)) * k + 1
    ccol = np.zeros_like(q)
    ccol[1:] = np.abs(np.diff(q, axis=0)) * k + 1
    return np.cumsum(crow, axis=1) << 2, np.cumsum(ccol, axis=0) << 2


def _tile_sweep(pk, srow, scol, win_r, win_c, y0, x0, tile):
    """One sweep of the tile at (y0, x0) as the kernel runs it: the tile's
    region copied, the four passes on it (values outside each pass's
    outputs poisoned); returns the tile's own pixels."""
    h, w = pk.shape
    hr, hc = win_r - 1, win_c - 1
    ry0, rx0 = max(y0 - hc, 0), max(x0 - hr, 0)
    ry1, rx1 = min(y0 + tile + hc, h), min(x0 + tile + hr, w)
    a, sr, sc = (m[ry0:ry1, rx0:rx1] for m in (pk, srow, scol))
    oy0, oy1 = y0 - ry0, min(y0 + tile, h) - ry0
    ox0, ox1 = x0 - rx0, min(x0 + tile, w) - rx0
    b = np.full_like(a, POISON)
    b[:, ox0:] = _pass(a, sr, False, win_r)[:, ox0:]
    c = np.full_like(a, POISON)
    c[:, ox0:ox1] = _pass(b, sr, True, win_r)[:, ox0:ox1]
    d = np.full_like(a, POISON)
    d[oy0:, ox0:ox1] = _pass(c.T, sc.T, False, win_c).T[oy0:, ox0:ox1]
    return _pass(d.T, sc.T, True, win_c).T[oy0:oy1, ox0:ox1]


def _line_sweep(pk, srow, scol, win_r, win_c):
    pk = _pass(pk, srow, False, win_r)
    pk = _pass(pk, srow, True, win_r)
    pk = _pass(pk.T, scol.T, False, win_c).T
    return _pass(pk.T, scol.T, True, win_c).T


def sweep_model(img, markers, values, max_iters, max_scan, tile=64):
    """The kernel's relaxation in numpy, on tiles of `tile` (64 or 32):
    (packed plane, sweeps run). Tiled sweeps ping-pong two planes (the
    second starts poisoned) and skip a tile whose region (itself and its
    8 neighbours) had no pixel fall in the last sweep, as the kernel does;
    each sweep's plane is checked against the unskipped line form."""
    h, w = img.shape
    srow, scol = _costs(img)
    small = np.zeros(markers.shape, np.int64)
    for i, v in enumerate(values):
        small[markers == v] = i + 1
    pk = np.where(small > 0, small, UNREACHED)
    win_r, win_c = _window(w, max_scan), _window(h, max_scan)
    tiled = max(win_r, win_c) <= 8
    assert tiled == KW.sweep_tiled(h, w, max_scan)
    planes = [pk, np.full_like(pk, POISON)]
    ty, tx = -(-h // tile), -(-w // tile)
    fell = np.ones((ty, tx), bool)
    sweeps = 0
    while sweeps < max_iters:
        src = planes[sweeps & 1]
        want = _line_sweep(src, srow, scol, win_r, win_c)
        if tiled:
            dst = planes[(sweeps + 1) & 1]
            now = np.zeros((ty, tx), bool)
            for a in range(ty):
                for b in range(tx):
                    if sweeps and not fell[max(a - 1, 0):a + 2, max(b - 1, 0):b + 2].any():
                        continue
                    out = _tile_sweep(src, srow, scol, win_r, win_c, a * tile, b * tile, tile)
                    ys, xs = slice(a * tile, (a + 1) * tile), slice(b * tile, (b + 1) * tile)
                    now[a, b] = (out < src[ys, xs]).any()
                    dst[ys, xs] = out
            fell = now
            np.testing.assert_array_equal(dst, want)
            changed = bool(now.any())
        else:
            planes[(sweeps + 1) & 1] = want
            planes[sweeps & 1] = want
            changed = bool((want != src).any())
        sweeps += 1
        if not changed:
            break
    return planes[sweeps & 1], sweeps


def model_labels(pk, values):
    table = np.array((0,) + tuple(values), np.int64)
    return table[pk & 3].astype(np.int32)


def model_ridge(labels):
    h, w = labels.shape
    pad = np.pad(labels, 1)
    ridge = np.zeros((h, w), bool)
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
        nb = pad[dy:dy + h, dx:dx + w]
        ridge |= (nb > 0) & (labels > 0) & (nb != labels)
    ridge[0], ridge[-1], ridge[:, 0], ridge[:, -1] = True, True, True, True
    return ridge


def _jax_sweeps(img, markers, values, max_iters, max_scan):
    """JAX's own sweeps (`sweep_packed`), one at a time: (packed plane after
    each sweep, sweeps run)."""
    h, w = img.shape
    k, big = JG._pack_params(h, w)
    srow, scol = JG.axis_costs_packed(JW._shift, jnp.asarray(img), k)
    small = np.zeros(markers.shape, np.int32)
    for i, v in enumerate(values):
        small[markers == v] = i + 1
    pk = jnp.asarray(np.where(small > 0, small, big).astype(np.int32))
    states = []
    while len(states) < max_iters:
        new = JG.sweep_packed(JW._shift, pk, srow, scol, max_scan, jnp.int32(big))
        states.append(np.asarray(new))
        changed = bool(jnp.any(new != pk))
        pk = new
        if not changed:
            break
    return states, len(states)


def _inputs(h, w, seed, top, n_values):
    """A smooth field plus noise in [0, top], half of its pixels at x.5
    (rint's ties to even), and markers: discs and bands of up to three
    values with the rest unlabeled."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = top * (0.5 + 0.5 * np.sin(xx / (3 + w / 9)) * np.cos(yy / (4 + h / 11)))
    img = np.clip(field + rng.normal(0, top / 20, (h, w)), 0, top)
    img = np.floor(img) + np.where(rng.random((h, w)) < 0.5, 0.5, 0.0)
    values = VALUES[:n_values]
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
    """Uncapped, at the cleaner's max_scan 8: the model's labels and ridge
    equal the plain version's and JAX's, after as many sweeps."""
    img, markers, values = _inputs(h, w, h * w + top, top, n_values)
    plain, plain_ridge = marker_watershed_plain(
        torch.from_numpy(img)[None], torch.from_numpy(markers)[None], max_iters=h * w,
        max_scan=8, marker_label_values=values)
    jax_labels = JG.relax_to_fixpoint_packed(JW._shift, jnp.asarray(img), jnp.asarray(markers),
                                             h * w, 8, label_values=values)
    jax_ridge = JG.label_boundary(JW._shift, jax_labels) == 1
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(jax_labels))
    np.testing.assert_array_equal(plain_ridge[0].numpy(), np.asarray(jax_ridge))
    pk, sweeps = sweep_model(img, markers, values, h * w, 8)
    labels = model_labels(pk, values)
    np.testing.assert_array_equal(labels, plain[0].numpy())
    np.testing.assert_array_equal(model_ridge(labels), plain_ridge[0].numpy())
    assert 1 <= sweeps < h * w


@pytest.mark.parametrize("max_scan", [2, 8, 256])
@pytest.mark.parametrize("max_iters", [1, 2, 5])
def test_kernel_model_capped_sweeps_match_jax(max_iters, max_scan):
    """Random integer images, 150 x 100 (tiles cut by the image on both
    sides): after the same capped sweeps the model's packed plane, on
    64 x 64 and on 32 x 32 tiles, is JAX's (unreached pixels lowered by
    the shift fill included), and so are the labels of
    `relax_to_fixpoint_packed` and the plain version's."""
    rng = np.random.default_rng(max_iters * 1000 + max_scan)
    h, w = 150, 100
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    markers = np.zeros((h, w), np.int32)
    markers[rng.random((h, w)) < 0.004] = 255
    markers[rng.random((h, w)) < 0.004] = 128
    markers[:, -3:] = 64
    states, jax_sweeps = _jax_sweeps(img, markers, VALUES, max_iters, max_scan)
    pk, sweeps = sweep_model(img, markers, VALUES, max_iters, max_scan)
    assert sweeps == jax_sweeps == max_iters
    np.testing.assert_array_equal(pk, states[-1])
    pk32, _ = sweep_model(img, markers, VALUES, max_iters, max_scan, tile=32)
    np.testing.assert_array_equal(pk32, states[-1])
    jax_labels = JG.relax_to_fixpoint_packed(JW._shift, jnp.asarray(img), jnp.asarray(markers),
                                             max_iters, max_scan, label_values=VALUES)
    np.testing.assert_array_equal(model_labels(pk, VALUES), np.asarray(jax_labels))
    plain, _ = marker_watershed_plain(torch.from_numpy(img)[None],
                                      torch.from_numpy(markers)[None], max_iters=max_iters,
                                      max_scan=max_scan, marker_label_values=VALUES)
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(jax_labels))


@pytest.mark.parametrize("case", ["no markers", "all markers", "one pixel"])
def test_kernel_model_edge_inputs(case):
    """Nothing to relax but the shift fill's lowering of unreached pixels,
    or nothing at all; and a 1 x 1 image: the model stops after JAX's
    sweeps with JAX's planes."""
    h, w = (1, 1) if case == "one pixel" else (45, 70)
    img = np.arange(h * w, dtype=np.float32).reshape(h, w) % 7
    markers = np.full((h, w), 128 if case == "all markers" else 0, np.int32)
    states, jax_sweeps = _jax_sweeps(img, markers, VALUES, 64, 8)
    pk, sweeps = sweep_model(img, markers, VALUES, 64, 8)
    assert sweeps == jax_sweeps
    np.testing.assert_array_equal(pk, states[-1])
    plain, plain_ridge = marker_watershed_plain(
        torch.from_numpy(img)[None], torch.from_numpy(markers)[None], max_iters=64,
        max_scan=8, marker_label_values=VALUES)
    np.testing.assert_array_equal(model_labels(pk, VALUES), plain[0].numpy())
    np.testing.assert_array_equal(model_ridge(model_labels(pk, VALUES)),
                                  plain_ridge[0].numpy())
    if case != "no markers":
        assert sweeps == 1


def serpentine(side, wall):
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
    the cleaner calls it) before the corridor is flooded. The kernel's
    model runs the same 256 sweeps and gives JAX's capped labels, as the
    port's plain version does; the fixpoint (the plain version uncapped),
    where marker 255 holds the whole corridor, differs from them in more
    than a row of pixels."""
    side = 128
    img, markers = serpentine(side, 200)
    jax_capped = np.asarray(JG.relax_to_fixpoint_packed(
        JW._shift, jnp.asarray(img), jnp.asarray(markers), 256, 8, label_values=VALUES))
    capped, _ = marker_watershed_plain(torch.from_numpy(img)[None],
                                       torch.from_numpy(markers)[None], max_iters=256,
                                       max_scan=8, marker_label_values=VALUES)
    np.testing.assert_array_equal(capped[0].numpy(), jax_capped)
    pk, sweeps = sweep_model(img, markers, VALUES, 256, 8, tile=32)
    assert sweeps == 256
    labels = model_labels(pk, VALUES)
    np.testing.assert_array_equal(labels, jax_capped)
    fixpoint, _ = marker_watershed_plain(torch.from_numpy(img)[None],
                                         torch.from_numpy(markers)[None], max_iters=side * side,
                                         max_scan=8, marker_label_values=VALUES)
    corridor = img == 0
    assert (fixpoint[0].numpy()[corridor] == 255).all()
    differ = labels != fixpoint[0].numpy()
    assert differ.sum() > side
    assert (labels[corridor] != 255).sum() == differ[corridor].sum()


def serpentine_pectoral_inputs(side):
    """(equ, bin, breast) uint8 for the pectoral tail: the serpentine of
    `serpentine` as the equalized image (walls 200), the high-threshold
    mask the top-left quarter (the pectoral object), the breast mask all
    but the right column."""
    img, _ = serpentine(side, 200)
    equ = img.astype(np.uint8)
    img_bin = np.zeros((side, side), np.uint8)
    img_bin[: side // 2, : side // 2] = 255
    breast = np.full((side, side), 255, np.uint8)
    breast[:, -1] = 0
    return equ, img_bin, breast


@pytest.mark.parametrize("ws_max_iters", [1, 3, 256])
def test_pectoral_tail_serpentine_matches_jax(ws_max_iters):
    """The pectoral tail at 64² on a serpentine equalized image, capped at
    1, 3 and 256 sweeps: the port's plain tail and the kernel's model of
    its relaxation (on the tail's own markers) give the labels, ridge and
    mask of JAX's `pectoral_tail_pallas` in interpret mode."""
    side = 64
    equ, img_bin, breast = serpentine_pectoral_inputs(side)
    j_labels, j_boundary, j_mask = (np.asarray(a[0]) for a in pectoral_tail_pallas(
        jnp.asarray(equ)[None], jnp.asarray(img_bin)[None], jnp.asarray(breast)[None], 3, 7, 25,
        ws_max_iters=ws_max_iters, max_scan=8, interpret=True))
    t_equ, t_bin, t_breast = (torch.from_numpy(a)[None] for a in (equ, img_bin, breast))
    labels, boundary, mask = KP.pectoral_tail(t_equ, t_bin, t_breast,
                                              ws_max_iters=ws_max_iters, max_scan=8)
    np.testing.assert_array_equal(labels[0].numpy(), j_labels)
    np.testing.assert_array_equal(boundary[0].numpy(), j_boundary == 1)
    np.testing.assert_array_equal(mask[0].numpy(), j_mask == 1)
    # the kernel's relaxation on the tail's markers
    from cadx_tpu_torch.kernels.largest_obj import largest_obj_reference
    from cadx_tpu_torch.ops.morphology import dilate, erode
    pect = largest_obj_reference(t_bin > 0, 8, fill=True, max_iters=128).to(torch.uint8)
    markers = np.zeros((side, side), np.int32)
    markers[erode(pect, 3, 7)[0].numpy() > 0] = 255
    markers[dilate(pect, 3, 7)[0].numpy() == 0] = 128
    markers[breast == 0] = 64
    pk, sweeps = sweep_model(equ.astype(np.float32), markers, VALUES, ws_max_iters, 8)
    np.testing.assert_array_equal(model_labels(pk, VALUES), j_labels)
    assert sweeps <= ws_max_iters


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
    """Scratch: four int32 planes, four int32 and two bytes a 32 x 32
    tile; the design's floor: 8 + 12 + 16 a sweep + 9 bytes a pixel; tiled
    sweeps up to max_scan 8."""
    assert KW.packed_tiles(2, 45, 70) == 2 * 2 * 3
    assert KW.packed_tiles(1, 512, 512) == 256
    assert KW.sweep_tile(1, 512, 512) == 32 and KW.sweep_tiles(1, 512, 512) == 256
    assert KW.sweep_tile(8, 512, 512) == 64 and KW.sweep_tiles(8, 512, 512) == 512
    assert KW.sweep_tile(64, 256, 256) == 64 and KW.sweep_tile(16, 256, 256) == 64
    assert KW.sweep_tile(1, 128, 128) == 32
    assert KW.sweep_tiles(2, 45, 70) == 2 * 2 * 3
    assert KW.packed_scratch_bytes(2, 45, 70) == 16 * 2 * 45 * 70 + 16 + 2 * 12
    assert KW.packed_floor_bytes(1, 512, 512, 7) == (8 + 12 + 112 + 9) * 512 * 512
    assert KW.sweep_tiled(512, 512, 8) and KW.sweep_tiled(512, 512, 5)
    assert not KW.sweep_tiled(512, 512, 9) and not KW.sweep_tiled(512, 512, 256)
    assert KW.sweep_tiled(3, 5, 256)   # windows cut to the lines: 4 and 8


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
