"""Port parity: the flood (kernels/flood.py's plain version and the
dispatching ops) and conv_leaky's input layouts.

- `kernels/flood.py::flood_from_reference`, what the wrapper runs on a CPU
  tensor, against JAX's `flood_from_pallas` in interpret mode, bit-exact,
  to the fixpoint and after a capped run (a serpentine stopped after two
  sweeps holds the same state in both);
- `ops.components.flood_from` and `fill_holes` on CPU tensors against
  JAX's `ops.components`, bit-exact;
- `conv2d_leaky` fed the channels-last view of NHWC features, as
  `models/cnn.py::conv_stack` feeds its first layer: forward and backward
  against the contiguous input and JAX's `conv2d_leaky_pallas` in
  interpret mode, to 1e-5 of the largest value, at least 1e-5 (float32
  sums of up to B*H*W terms in another order), and the wrapper's
  layout rule, which the CUDA kernel reads from the strides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.kernels import flood as JF
from cadx_tpu.kernels import nn_kernels as nk
from cadx_tpu.ops import components as JC
from cadx_tpu.ops import conv as JConv
from cadx_tpu_torch import convert
from cadx_tpu_torch.kernels import conv_leaky as KCL
from cadx_tpu_torch.kernels import flood as KF
from cadx_tpu_torch.ops import components as TC
from cadx_tpu_torch.ops import conv as TConv


def _close(a, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(a, ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _serpentine(h: int, w: int) -> np.ndarray:
    """A one-pixel corridor that doubles back every 4 rows: reach from the
    top row needs one sweep per turn."""
    m = np.zeros((h, w), bool)
    for r in range(0, h, 4):
        m[r, :] = True
        if r + 1 < h:
            m[r + 1: r + 4, w - 1 if (r // 4) % 2 == 0 else 0] = True
    return m


def _flood_inputs(rng, b, h, w):
    m = rng.random((b, h, w)) < 0.6
    m[0] = _serpentine(h, w)
    seed = np.zeros((b, h, w), bool)
    seed[:, 0, :] = True
    seed[-1] |= rng.random((h, w)) < 0.01
    return m, seed


@pytest.mark.parametrize("hw", [(16, 16), (24, 40), (37, 29)])
@pytest.mark.parametrize("max_iters", [1, 2, 128])
def test_flood_plain_matches_pallas(rng, hw, max_iters):
    m, seed = _flood_inputs(rng, 3, *hw)
    ref = np.asarray(JF.flood_from_pallas(jnp.asarray(m), jnp.asarray(seed), max_iters,
                                          interpret=True))
    ours = KF.flood_from_reference(torch.from_numpy(m), torch.from_numpy(seed), max_iters)
    np.testing.assert_array_equal(ours.numpy(), ref)
    before = KF.flood_from.launches
    wrapped = KF.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters)
    assert KF.flood_from.launches == before        # a CPU tensor takes the plain version
    np.testing.assert_array_equal(wrapped.numpy(), ref)


def test_flood_capped_serpentine_state(rng):
    """Two sweeps on a serpentine stop short of the fixpoint, in JAX and in
    the port, at the same pixels."""
    m = _serpentine(32, 24)[None]
    seed = np.zeros_like(m)
    seed[0, 0, 0] = True
    ref = np.asarray(JF.flood_from_pallas(jnp.asarray(m), jnp.asarray(seed), 2,
                                          interpret=True))
    ours = KF.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters=2).numpy()
    full = KF.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters=32 * 24)
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() < full.numpy().sum() == m.sum()


def test_flood_wrapper_rejects_connectivity():
    m = torch.ones((1, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        KF.flood_from(m, m, connectivity=6)


@pytest.mark.parametrize("max_iters", [2, 128])
def test_ops_flood_from_and_fill_holes_match_jax(rng, max_iters):
    m, seed = _flood_inputs(rng, 3, 40, 36)
    ref = np.stack([np.asarray(JC.flood_from(jnp.asarray(a), jnp.asarray(s), max_iters))
                    for a, s in zip(m, seed)])
    ours = TC.flood_from(torch.from_numpy(m), torch.from_numpy(seed), max_iters).numpy()
    np.testing.assert_array_equal(ours, ref)
    holes = rng.random((3, 40, 36)) > 0.3
    holes[1, 10:20, 10:20] = True
    holes[1, 13:16, 13:16] = False                 # a hole
    ref = np.stack([np.asarray(JC.fill_holes(jnp.asarray(a), max_iters)) for a in holes])
    for fn in (TC.fill_holes, TC.fill_holes_plain):
        np.testing.assert_array_equal(fn(torch.from_numpy(holes), max_iters).numpy(), ref)


def test_conv_leaky_layout_rule():
    x = torch.zeros((2, 5, 7, 9))
    assert KCL._layout(x) == 0
    assert KCL._layout(torch.zeros((2, 7, 9, 5)).permute(0, 3, 1, 2)) == 1
    assert KCL._layout(torch.zeros((1, 1, 7, 9)).permute(0, 1, 2, 3)) == 0
    for odd in (x[:, :, ::2], x.transpose(2, 3), torch.zeros((2, 7, 5, 9)).permute(0, 2, 1, 3)):
        with pytest.raises(ValueError):
            KCL._layout(odd)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv2d_leaky_nhwc_view_matches_contiguous_and_pallas(rng, padding):
    b, h, w, c, f, k = 2, 11, 10, 6, 7, 3
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    x[:, : h // 2] = 0.0
    wt = (rng.standard_normal((k, k, c, f)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    bias[0] = 0.0
    p = 0 if padding == "VALID" else k // 2
    jx = jnp.pad(jnp.asarray(x), ((0, 0), (p, p), (p, p), (0, 0)))
    pallas = np.asarray(nk.conv2d_leaky_pallas(jx, jnp.asarray(wt), jnp.asarray(bias), 0.01,
                                               interpret=True))
    out, vjp = jax.vjp(lambda a, k_, b_: JConv.conv2d_leaky(a, k_, b_, alpha=0.01,
                                                            padding=padding if p == 0 else p),
                       jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    g = rng.standard_normal(out.shape).astype(np.float32)
    dx, dw, db = vjp(jnp.asarray(g))
    grads = {}
    for name, make in (("view", lambda t: t.permute(0, 3, 1, 2)),
                       ("contiguous", lambda t: t.permute(0, 3, 1, 2).contiguous())):
        xt = torch.from_numpy(x).requires_grad_(True)
        tw = convert.hwio_to_oihw(wt).requires_grad_(True)
        tb = torch.from_numpy(bias).requires_grad_(True)
        xin = make(xt)
        assert KCL._layout(xin.detach()) == (1 if name == "view" else 0)
        y = TConv.conv2d_leaky(xin, tw, tb, 0.01, padding)
        y_nhwc = y.detach().permute(0, 2, 3, 1).numpy()
        _close(y_nhwc, pallas)
        _close(y_nhwc, out)
        y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        grads[name] = (xt.grad.numpy(), tw.grad.numpy(), tb.grad.numpy())
        _close(grads[name][0], dx)
        _close(grads[name][1], np.asarray(dw).transpose(3, 2, 0, 1))
        _close(grads[name][2], db)
    for a, c_ in zip(grads["view"], grads["contiguous"]):
        _close(a, c_)


# ---- the flood kernel's design on the CPU -----------------------------------
#
# A numpy model of `csrc/flood.cu`, step for step at the level of its words:
# the row-packed and column-packed planes; `fill_line`'s segmented scan 32
# words at a time (a Kogge-Stone fill inside each word, one over the ballots
# of words that end reached (G) and words that are all mask (P), forward,
# then backward on bit-reversed ballots) and `fill_short`'s several lines a
# pass up to 16 words; the 3x3 step on words folded into the next sweep's
# row step; and the stop rule on the rotating flags. It must give
# `flood_from_plain`'s state and sweep count on the inputs that break such a
# layout: runs across word borders, ragged last words, lines longer than a
# warp's 32 words, capped runs.

_M32 = np.uint64(0xFFFFFFFF)


def _fill_up(r, m):
    for s in (1, 2, 4, 8):
        r = r | (m & ((r << np.uint64(s)) & _M32))
        m = m & ((m << np.uint64(s)) & _M32)
    return r | (m & ((r << np.uint64(16)) & _M32))


def _fill_down(r, m):
    for s in (1, 2, 4, 8):
        r = r | (m & (r >> np.uint64(s)))
        m = m & (m >> np.uint64(s))
    return r | (m & (r >> np.uint64(16)))


_LANES = np.arange(32, dtype=np.uint64)


def _ballot(pred):
    """(L, 32) bool -> (L,) words, bit k from lane k."""
    return (pred.astype(np.uint64) << _LANES).sum(axis=1, dtype=np.uint64)


def _brev(v):
    bits = (v[:, None] >> _LANES) & np.uint64(1)
    return (bits[:, ::-1] << _LANES).sum(axis=1, dtype=np.uint64)


def _lane_bit(word, lane_of):
    """(L,) words -> (L, 32) bools: bit lane_of[k] of the word at lane k."""
    return ((word[:, None] >> lane_of) & np.uint64(1)).astype(bool)


_STARTS = {1: 0xFFFFFFFF, 2: 0x55555555, 4: 0x11111111, 8: 0x01010101, 16: 0x00010001}


def _fill_short_lines(m, r):
    """`fill_short` on L lines of n <= 16 words: 32 // S lines a pass, lane l
    word l % S of line l // S, S the power of two >= n."""
    lines, n = m.shape
    size = 1 << (n - 1).bit_length()
    per = 32 // size
    passes = -(-lines // per)
    lane_line, lane_word = np.arange(32) // size, np.arange(32) % size
    on = lane_word < n
    mp = np.zeros((passes * per, size), np.uint64)
    rp = np.zeros_like(mp)
    mp[:lines, :n], rp[:lines, :n] = m, r
    mm = np.where(on, mp.reshape(passes, per * size), np.uint64(0))
    v = _fill_up(np.where(on, rp.reshape(passes, per * size), np.uint64(0)), mm)
    starts = np.uint64(_STARTS[size])
    ends_rev = _brev(np.array([(_STARTS[size] << (size - 1)) & 0xFFFFFFFF], np.uint64))[0]
    p = _ballot(mm == _M32)
    g = _ballot((v >> np.uint64(31)) == 1)
    x = _fill_up(g, g | (p & ~starts & _M32))
    carried = _lane_bit(((x << np.uint64(1)) & _M32) & ~starts, _LANES)
    v = np.where(carried, _fill_up(v | (mm & np.uint64(1)), mm), v)
    v = _fill_down(v, mm)
    pr = _brev(p)
    g = _brev(_ballot((v & np.uint64(1)) == 1))
    x = _fill_up(g, g | (pr & ~ends_rev & _M32))
    carried = _lane_bit(((x << np.uint64(1)) & _M32) & ~ends_rev, np.uint64(31) - _LANES)
    v = np.where(carried, _fill_down(v | (mm & np.uint64(0x80000000)), mm), v)
    return v.reshape(passes * per, size)[:lines, :n]


def _fill_lines(m, r):
    """`fill_band` on L lines of n words at once: (L, n) uint64 -> (L, n);
    `fill_short` up to 16 words, else `fill_line`."""
    lines, n = m.shape
    if n <= 16:
        return _fill_short_lines(m, r)
    chunks = -(-n // 32)
    mp = np.zeros((lines, 32 * chunks), np.uint64)
    rp = np.zeros_like(mp)
    mp[:, :n], rp[:, :n] = m, r
    cin = np.zeros(lines, np.uint64)
    for c in range(chunks):
        mm = mp[:, 32 * c:32 * c + 32]
        v = _fill_up(rp[:, 32 * c:32 * c + 32], mm)
        p, g = _ballot(mm == _M32), _ballot((v >> np.uint64(31)) == 1)
        x = _fill_up(g | (cin & p), g | p)
        carried = _lane_bit(((x << np.uint64(1)) & _M32) | cin, _LANES)
        v = np.where(carried, _fill_up(v | (mm & np.uint64(1)), mm), v)
        rp[:, 32 * c:32 * c + 32] = v
        cin = x >> np.uint64(31)
    cin = np.zeros(lines, np.uint64)
    for c in reversed(range(chunks)):
        mm = mp[:, 32 * c:32 * c + 32]
        v = _fill_down(rp[:, 32 * c:32 * c + 32], mm)
        p = _brev(_ballot(mm == _M32))
        g = _brev(_ballot((v & np.uint64(1)) == 1))
        x = _fill_up(g | (cin & p), g | p)
        carried = _lane_bit(((x << np.uint64(1)) & _M32) | cin, np.uint64(31) - _LANES)
        v = np.where(carried, _fill_down(v | (mm & np.uint64(0x80000000)), mm), v)
        rp[:, 32 * c:32 * c + 32] = v
        cin = x >> np.uint64(31)
    return rp[:, :n]


def _pack_rows(bits):
    """(B, H, W) bool -> (B, H, ceil(W / 32)) words, bit k of word j: x = 32 j + k."""
    b, h, w = bits.shape
    nw = -(-w // 32)
    padded = np.zeros((b, h, 32 * nw), np.uint64)
    padded[:, :, :w] = bits
    return (padded.reshape(b, h, nw, 32) << _LANES).sum(axis=3, dtype=np.uint64)


def _unpack_rows(words, w):
    return ((words[..., None] >> _LANES) & np.uint64(1)).astype(bool).reshape(
        *words.shape[:-1], -1)[..., :w]


def _dilate3_words(u, m):
    """The 3x3 step on row words: rows above and below ORed, then each word
    and its neighbours' edge bits shifted in, with the mask."""
    vert = u.copy()
    vert[:, 1:] |= u[:, :-1]
    vert[:, :-1] |= u[:, 1:]
    left = np.zeros_like(vert)
    right = np.zeros_like(vert)
    left[:, :, 1:], right[:, :, :-1] = vert[:, :, :-1], vert[:, :, 1:]
    one, top = np.uint64(1), np.uint64(31)
    h = (vert | ((vert << one) & _M32) | (left >> top) | (vert >> one)
         | ((right << top) & _M32))
    return h & m


def _flood_model(mask, seed, max_iters, conn):
    """(state, sweeps) of csrc/flood.cu's loop on (B, H, W) bool inputs."""
    b, h, w = mask.shape
    mr, mc = _pack_rows(mask), _pack_rows(mask.transpose(0, 2, 1))
    rr = _pack_rows(mask & seed)
    ur = None
    flags = [0, 0, 0]
    t, sweeps = 1, 0
    while max_iters > 0:
        dilate = conn == 8 and t >= 2
        flags[(t + 1) % 3] = 0
        if dilate:                      # the 3x3 step of sweep t - 1
            new = _dilate3_words(ur, mr)
            if (new != rr).any():
                flags[(t - 1) % 3] = 1
            rr = new
        rows = _fill_lines(mr.reshape(b * h, -1), rr.reshape(b * h, -1)).reshape(rr.shape)
        tc = _pack_rows(_unpack_rows(rows, w).transpose(0, 2, 1))
        if dilate and (not flags[(t - 1) % 3] or t - 1 >= max_iters):
            sweeps = t - 1
            break
        cols = _fill_lines(mc.reshape(b * w, -1), tc.reshape(b * w, -1)).reshape(tc.shape)
        back = _pack_rows(_unpack_rows(cols, h).transpose(0, 2, 1))
        if conn == 8:
            ur = back
        else:
            if (back != rr).any():
                flags[t % 3] = 1
            rr = back
            if not flags[t % 3] or t >= max_iters:
                sweeps = t
                break
        t += 1
    return _unpack_rows(rr, w), sweeps


def _plain_with_sweeps(monkeypatch, mask, seed, max_iters, conn):
    """flood_from_plain's state and the sweeps its loop ran."""
    count = [0]
    run = TC._run_to_fixpoint

    def counting(sweep, state, cap):
        def counted(x):
            count[0] += 1
            return sweep(x)
        return run(counted, state, cap)

    monkeypatch.setattr(TC, "_run_to_fixpoint", counting)
    out = TC.flood_from_plain(torch.from_numpy(mask), torch.from_numpy(seed), max_iters, conn)
    return out.numpy(), count[0]


def _model_cases(rng):
    """(name, mask, seed): runs across word borders and ragged words at W =
    31, 32, 33, B*H*W not a multiple of 32, lines of more than 32 words both
    ways, a serpentine, an all-mask image, an empty mask."""
    cases = []
    for w in (31, 32, 33, 70):
        m = rng.random((3, 9, w)) < 0.7
        m[0, 4] = True                         # one run across every word border
        s = np.zeros_like(m)
        s[:, :, 0] = True
        cases.append((f"random 3x9x{w}", m, s))
    m = rng.random((2, 3, 1100)) < 0.97        # rows of 35 words
    s = np.zeros_like(m)
    s[:, 1, 1099] = True
    cases.append(("long rows 2x3x1100", m, s))
    m = rng.random((1, 1090, 3)) < 0.97        # columns of 35 words
    s = np.zeros_like(m)
    s[0, 0, :] = True
    cases.append(("long columns 1x1090x3", m, s))
    serp = _serpentine(45, 37)[None]
    s = np.zeros_like(serp)
    s[0, 0, 0] = True
    cases.append(("serpentine 45x37", serp, s))
    full = np.ones((1, 5, 40), bool)
    s = np.zeros_like(full)
    s[0, 4, 39] = True
    cases.append(("all mask 5x40", full, s))
    cases.append(("empty 2x7x9", np.zeros((2, 7, 9), bool), np.ones((2, 7, 9), bool)))
    return cases


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("max_iters", [0, 1, 2, 17, None])
def test_flood_kernel_model_matches_plain(rng, monkeypatch, conn, max_iters):
    for name, m, s in _model_cases(rng):
        cap = m.shape[1] * m.shape[2] if max_iters is None else max_iters
        got, sweeps = _flood_model(m, s, cap, conn)
        ref, ref_sweeps = _plain_with_sweeps(monkeypatch, m, s, cap, conn)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert sweeps == ref_sweeps, name


def test_flood_kernel_model_fill_lines_across_chunks(rng):
    """`fill_line` and `fill_short` alone: every run of the mask that holds
    a reach bit, set in full, on lines of 1-70 words with runs that cross
    words, lines' segments of lanes and chunks."""
    for n in (1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 64, 70):
        bits = rng.random((40, 32 * n)) < rng.choice([0.5, 0.9, 0.99], size=(40, 1))
        bits[0] = True
        reach = bits & (rng.random(bits.shape) < 0.002)
        reach[0, -1] = True
        want = np.zeros_like(bits)
        for i in range(bits.shape[0]):
            run_start = 0
            for x in range(bits.shape[1] + 1):
                if x == bits.shape[1] or not bits[i, x]:
                    if reach[i, run_start:x].any():
                        want[i, run_start:x] = True
                    run_start = x + 1
        got = _fill_lines(_pack_rows(bits[None])[0], _pack_rows(reach[None])[0])
        np.testing.assert_array_equal(_unpack_rows(got, 32 * n), want, err_msg=f"n={n}")


@pytest.mark.parametrize("b,h,w,words", [(1, 1, 1, 3 + 3 + 2), (64, 256, 256, 3 + 64 * 5 * 2048),
                                         (1, 1536, 1280, 3 + 3 * 61440 + 2 * 61440),
                                         (2, 33, 31, 3 + 2 * (3 * 33 + 2 * 31 * 2))])
def test_flood_scratch_words(b, h, w, words):
    assert KF.scratch_words(b, h, w) == words


@pytest.mark.parametrize("h,w,nbytes", [(256, 256, 2 * 32 * 33 * 4), (1536, 1280, 2 * 32 * 49 * 4),
                                        (3328, 2560, 2 * 32 * 105 * 4), (1, 70, 2 * 32 * 33 * 4),
                                        (1100, 3, 2 * 32 * 35 * 4), (29024, 5, 2 * 32 * 907 * 4)])
def test_flood_shared_bytes(h, w, nbytes):
    assert KF.shared_bytes(h, w) == nbytes
    assert KF.shared_bytes(h, w) <= 227 * 1024


def _transpose32_by_shuffles(words):
    """`transpose32` on (L, 32) tiles, lane i word i: five exchanges with the
    lane s apart, each swapping the off-diagonal s x s blocks."""
    v = words.copy()
    lanes = np.arange(32)
    for s, right in ((16, 0xFFFF0000), (8, 0xFF00FF00), (4, 0xF0F0F0F0), (2, 0xCCCCCCCC),
                     (1, 0xAAAAAAAA)):
        p = v[:, lanes ^ s]
        r, su = np.uint64(right), np.uint64(s)
        lower = (v & r) | ((p & r) >> su)
        upper = (v & ~r & _M32) | (((p & ~r & _M32) << su) & _M32)
        v = np.where((lanes & s) != 0, lower, upper)
    return v


def test_flood_transpose32_by_shuffles(rng):
    """The kernel's tile transpose: lane k ends with column k of the tile
    (bit i: word i's bit k)."""
    bits = rng.random((50, 32, 32)) < 0.5
    bits[0] = np.eye(32, dtype=bool)
    bits[1, :, 0] = True
    words = (bits.astype(np.uint64) << _LANES).sum(axis=2, dtype=np.uint64)
    got = _transpose32_by_shuffles(words)
    want = (bits.transpose(0, 2, 1).astype(np.uint64) << _LANES).sum(axis=2, dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
