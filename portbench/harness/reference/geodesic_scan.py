"""Min-plus line scans for the geodesic watershed, in both of its forms.

A frozen copy of the port's plain `ops/geodesic_scan.py` (itself a port of
`cadx_tpu/ops/geodesic_scan.py`, batched over a leading B.

Pair form (`relax_to_fixpoint`): float32 distances and int32 labels. The
edge cost between two neighbours is |dI| + 1e-3; `axis_costs` takes its
prefix sums along rows and columns with the Hillis-Steele doubling order
of JAX, and each directional pass of `sweep` takes the running min of
d -/+ s over a window (`scan_min_carry`), carrying the argmin's label,
ties to the nearest pixel. The float fixpoint depends on that order of
arithmetic, so the port keeps it op for op.

Packed form (`relax_to_fixpoint_packed`): the packed value of a pixel is
(dist_q << 2) | label, where dist_q = K * sum|grad| + path length and K
is the next power of two >= H + W, so the two keys never mix. Labels
1..3 stand for the caller's marker values; unreached pixels hold 1 << 30,
whose label bits are 0. The fixpoint is the minimum, over the markers, of
the packed path value: equal distances go to the smaller label index.
"""

from __future__ import annotations

import torch

BIG = 1e30
BIG_PK = 1 << 30
EDGE_EPS = 1e-3


def shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., i, j] = x[..., i - dy, j - dx]; vacated cells get `fill`."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        x[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def doubling_steps(n: int) -> tuple[int, ...]:
    """Shift offsets 1, 2, 4, ... covering a window of >= n."""
    steps, k = [], 1
    while k < n:
        steps.append(k)
        k *= 2
    return tuple(steps)


def _axis_shift(axis: int, k: int) -> tuple[int, int]:
    """(dy, dx) of a shift by k along image axis 0 (rows) or 1 (columns)."""
    return (k, 0) if axis == 0 else (0, k)


def scan_min_carry(w: torch.Tensor, l: torch.Tensor, axis: int,
                   reverse: bool, max_scan: int):
    """Running min of w along image `axis` (prefix, or suffix if reverse)
    over a window of up to max_scan, carrying the argmin's label. Strict
    < keeps the nearest minimiser on ties."""
    n = min(w.shape[-2 + axis], max_scan)
    sgn = -1 if reverse else 1
    for k in doubling_steps(n):
        dy, dx = _axis_shift(axis, sgn * k)
        w_sh = shift(w, dy, dx, BIG)
        l_sh = shift(l, dy, dx, 0)
        take = w_sh < w
        w = torch.where(take, w_sh, w)
        l = torch.where(take, l_sh, l)
    return w, l


def doubling_cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Inclusive prefix sum along image `axis` by shift-doubling adds,
    the association order of JAX's."""
    for k in doubling_steps(x.shape[-2 + axis]):
        dy, dx = _axis_shift(axis, k)
        x = x + shift(x, dy, dx, 0.0)
    return x


def axis_costs(img: torch.Tensor):
    """Prefix sums (srow, scol) of the float32 step costs |dI| + 1e-3 along
    rows and columns; the first column / row costs nothing, so
    srow[i, j] - srow[i, k] is the path cost k -> j along row i."""
    crow = (img - shift(img, 0, 1, 0.0)).abs() + EDGE_EPS
    crow[..., :, 0] = 0.0
    ccol = (img - shift(img, 1, 0, 0.0)).abs() + EDGE_EPS
    ccol[..., 0, :] = 0.0
    return doubling_cumsum(crow, 1), doubling_cumsum(ccol, 0)


def _relax(d, l, lw, cand):
    take = cand < d
    return torch.where(take, cand, d), torch.where(take, lw, l)


def sweep(d: torch.Tensor, l: torch.Tensor, srow: torch.Tensor,
          scol: torch.Tensor, max_scan: int):
    """One Gauss-Seidel sweep: LR, RL, TB, BT line relaxations, each seeing
    the previous one's output. Left-to-right relaxes d[i] to
    min_{j<=i}(d[j] - s[j]) + s[i] where that is smaller; right-to-left
    uses min_{j>=i}(d[j] + s[j]) - s[i]; then the same along columns."""
    for axis, s in ((1, srow), (0, scol)):
        w, lw = scan_min_carry(d - s, l, axis, False, max_scan)
        d, l = _relax(d, l, lw, w + s)
        w, lw = scan_min_carry(d + s, l, axis, True, max_scan)
        d, l = _relax(d, l, lw, w - s)
    return d, l


def _pair_fixpoint(img: torch.Tensor, markers: torch.Tensor,
                   max_iters: int, max_scan: int) -> tuple[torch.Tensor, int]:
    """(labels, sweeps run): pair-form sweeps until one changes no distance
    (that sweep counted) or `max_iters` ran."""
    labels = markers.to(torch.int32)
    dist = torch.where(labels > 0, 0.0, BIG).to(torch.float32)
    srow, scol = axis_costs(img.to(torch.float32))
    sweeps = 0
    for _ in range(max_iters):
        new_d, new_l = sweep(dist, labels, srow, scol, max_scan)
        sweeps += 1
        changed = bool((new_d != dist).any())
        dist, labels = new_d, new_l
        if not changed:
            break
    return labels, sweeps


def relax_to_fixpoint(img: torch.Tensor, markers: torch.Tensor,
                      max_iters: int, max_scan: int) -> torch.Tensor:
    """Pair-form sweeps until no distance changes (at most `max_iters`);
    returns the labels, the markers' own values, 0 where unreached."""
    return _pair_fixpoint(img, markers, max_iters, max_scan)[0]


def sweeps_to_fixpoint(img: torch.Tensor, markers: torch.Tensor,
                       max_iters: int, max_scan: int) -> int:
    """The sweeps `relax_to_fixpoint` runs on these inputs: up to the first
    that changes no distance, at most `max_iters`."""
    return _pair_fixpoint(img, markers, max_iters, max_scan)[1]


def _pack_params(h: int, w: int) -> tuple[int, int]:
    """K = next power of two >= h + w, and the unreached value 1 << 30."""
    k = 1
    while k < h + w:
        k *= 2
    return k, BIG_PK


def use_packed(shape, n_marker_labels: int) -> bool:
    """Labels fit 2 bits and quantized distances fit int32 up to 512."""
    return max(shape) <= 512 and n_marker_labels <= 3


def axis_costs_packed(img: torch.Tensor, k: int):
    """Prefix sums of the integer step costs |dq| * K + 1 along rows and
    columns, in packed units (<< 2). Column 0 / row 0 cost nothing."""
    q = torch.round(img).to(torch.int32)
    crow = (q - shift(q, 0, 1, 0)).abs() * k + 1
    crow[..., :, 0] = 0
    ccol = (q - shift(q, 1, 0, 0)).abs() * k + 1
    ccol[..., 0, :] = 0
    srow = torch.cumsum(crow, dim=-1, dtype=torch.int32)
    scol = torch.cumsum(ccol, dim=-2, dtype=torch.int32)
    return srow << 2, scol << 2


def sweep_packed(pk, srow_pk, scol_pk, max_scan: int, big_pk: int):
    """One Gauss-Seidel sweep: left-right, right-left, top-bottom and
    bottom-top relaxations, each a windowed running min of pk -/+ s."""
    for axis, s_pk, reverse in ((1, srow_pk, False), (1, srow_pk, True),
                                (0, scol_pk, False), (0, scol_pk, True)):
        t = pk + s_pk if reverse else pk - s_pk
        n = min(pk.shape[-2 + axis], max_scan)
        sgn = -1 if reverse else 1
        for kk in doubling_steps(n):
            dy, dx = (sgn * kk, 0) if axis == 0 else (0, sgn * kk)
            t = torch.minimum(t, shift(t, dy, dx, big_pk))
        cand = t - s_pk if reverse else t + s_pk
        pk = torch.minimum(pk, cand)
    return pk


def relax_to_fixpoint_packed(img: torch.Tensor, markers: torch.Tensor,
                             max_iters: int, max_scan: int,
                             label_values: tuple = ()) -> torch.Tensor:
    """Sweeps to the packed fixpoint (at most `max_iters`); returns the
    marker values (label_values[i] for label i + 1, 0 where unreached)."""
    h, w = img.shape[-2:]
    k, big = _pack_params(h, w)
    srow_pk, scol_pk = axis_costs_packed(img, k)
    m32 = markers.to(torch.int32)
    small = torch.zeros_like(m32)
    for i, v in enumerate(label_values):
        small = torch.where(m32 == v, i + 1, small)
    pk = torch.where(small > 0, small, big)
    for _ in range(max_iters):
        new = sweep_packed(pk, srow_pk, scol_pk, max_scan, big)
        changed = bool((new != pk).any())
        pk = new
        if not changed:
            break
    small = pk & 3
    labels = torch.zeros_like(small)
    for i, v in enumerate(label_values):
        labels = torch.where(small == i + 1, v, labels)
    return labels


def label_boundary(labels: torch.Tensor) -> torch.Tensor:
    """cv2.watershed ridge as int32 0/1: 4-neighbour disagreements between
    positive labels, plus the 1-px image frame."""
    h, w = labels.shape[-2:]
    boundary = torch.zeros_like(labels, dtype=torch.bool)
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nl = shift(labels, dy, dx, 0)
        boundary |= (nl > 0) & (labels > 0) & (nl != labels)
    boundary[..., 0, :] = True
    boundary[..., h - 1, :] = True
    boundary[..., :, 0] = True
    boundary[..., :, w - 1] = True
    return boundary.to(torch.int32)
