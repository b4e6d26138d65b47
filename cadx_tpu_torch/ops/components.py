"""Connected components, largest component, flood and hole fill — the
plain PyTorch forms, batched over a leading B.

Port of `cadx_tpu/ops/components.py`. These mirror the JAX algorithm
step for step (packed segmented cummin/cummax line scans, the 3x3
neighbour min for 8-connectivity, the 4x-coarse multigrid hint and the
`max_iters` sweep caps), so they give the JAX outputs even on an input
where a cap is hit. Their contract, which the CUDA kernels meet by other
means, is the fixpoint:

- a foreground pixel's label is the minimum raster index of its
  component; background holds `background_label(H, W)`;
- the largest component is chosen by area, the smallest label on ties;
- holes are background pixels that a 4-connected flood from the image
  border cannot reach.

A sweep that changes nothing is a fixpoint, so running further sweeps on
an image that has already converged leaves it as it is; the batched loops
below therefore stop when no image of the batch changed, which is what a
per-image loop gives.

`label_components` and `largest_component` dispatch on the device: a CPU
tensor takes the `*_plain` form, a CUDA tensor the kernels of
`kernels/ccl.py` and `kernels/mode.py` (imported at the call, so the
kernel modules, which build on these plain forms, import this module and
not the other way round). The kernels' own plain versions call the
`*_plain` forms, so they stay plain on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# background of the labels where H*W is too large to pack into int32
_INF = 1 << 30


def _label_bits(h: int, w: int) -> int:
    """The sentinel (1 << bits) - 1 exceeds the largest label h*w - 1."""
    return int(math.ceil(math.log2(h * w + 1)))


def _seg_bits(h: int, w: int) -> int:
    return int(math.ceil(math.log2(max(h, w) + 2)))


def _cummin(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return torch.cummin(x.flip(dim), dim).values.flip(dim)
    return torch.cummin(x, dim).values


def _cummax(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def _window3(x: torch.Tensor, dim: int, fill: int, op=torch.minimum) -> torch.Tensor:
    """`op` (min or max) over the 3-window centred on each pixel along
    `dim`, `fill` outside the image."""
    pad = (0, 0, 1, 1) if dim == -2 else (1, 1)
    xp = F.pad(x, pad, value=fill)
    n = x.shape[dim]
    a, b, c = (xp.narrow(dim, s, n) for s in range(3))
    return op(op(a, b), c)


def _run_to_fixpoint(sweep, state: torch.Tensor, max_iters: int) -> torch.Tensor:
    """lax.while_loop(changed & it < max_iters) over the whole batch."""
    for _ in range(max_iters):
        new = sweep(state)
        changed = bool((new != state).any())
        state = new
        if not changed:
            break
    return state


def _make_packed_sweep(mask: torch.Tensor, connectivity: int, lbl_bits: int,
                       dtype: torch.dtype = torch.int32):
    """One packed-cummin labelling sweep: rows both ways, then columns,
    then (8-connectivity) the 3x3 neighbour min. Values are packed as
    (segment_id << lbl_bits) | label; the segment order is inverted for
    the forward scans so a foreign segment never wins the min."""
    h, w = mask.shape[-2:]
    lbl_mask = (1 << lbl_bits) - 1
    barriers = (~mask).to(dtype)
    row_seg = torch.cumsum(barriers, dim=-1, dtype=dtype)
    col_seg = torch.cumsum(barriers, dim=-2, dtype=dtype)
    row_f, row_b = (w + 1 - row_seg) << lbl_bits, row_seg << lbl_bits
    col_f, col_b = (h + 1 - col_seg) << lbl_bits, col_seg << lbl_bits
    sentinel = torch.full((), lbl_mask, dtype=dtype, device=mask.device)

    def sweep(labels: torch.Tensor) -> torch.Tensor:
        vals = torch.where(mask, labels, sentinel)
        for dim, seg_f, seg_b in ((-1, row_f, row_b), (-2, col_f, col_b)):
            f = _cummin(seg_f | vals, dim) & lbl_mask
            b = _cummin(seg_b | vals, dim, reverse=True) & lbl_mask
            vals = torch.where(mask, torch.minimum(f, b), sentinel)
        if connectivity == 8:
            nb = _window3(_window3(vals, -2, lbl_mask), -1, lbl_mask)
            vals = torch.where(mask, torch.minimum(vals, nb), sentinel)
        return vals

    return sweep, sentinel


def _packs_int32(h: int, w: int) -> bool:
    """Segment id and label fit 31 bits: JAX's packed form, else its
    tuple-scan form."""
    return _label_bits(h, w) + _seg_bits(h, w) <= 31


def background_label(h: int, w: int) -> int:
    """The background value of `label_components` at (h, w): the packed
    form's (1 << label_bits) - 1, or JAX's 2**30 where the image is too
    large to pack into int32 (its tuple-scan form)."""
    return (1 << _label_bits(h, w)) - 1 if _packs_int32(h, w) else _INF


def _label_core(mask: torch.Tensor, connectivity: int, max_iters: int,
                init: torch.Tensor | None = None) -> torch.Tensor:
    """Sweeps to the fixpoint. Up to 31 bits of segment id and label the
    values pack into int32. Beyond, the same packed cummin runs on int64:
    it computes the same segmented min as JAX's tuple scan, whose
    background value 2**30 is put back at the end."""
    h, w = mask.shape[-2:]
    lbl_bits = _label_bits(h, w)
    packed32 = _packs_int32(h, w)
    dtype = torch.int32 if packed32 else torch.int64
    own = torch.arange(h * w, dtype=dtype, device=mask.device).view(h, w)
    sweep, sentinel = _make_packed_sweep(mask, connectivity, lbl_bits, dtype)
    start = own.expand_as(mask) if init is None else torch.minimum(own, init.to(dtype))
    start = torch.where(mask, start, sentinel)
    labels = _run_to_fixpoint(sweep, start, max_iters)
    if packed32:
        return labels
    return torch.where(mask, labels, _INF).to(torch.int32)


def label_components(mask: torch.Tensor, connectivity: int = 8,
                     max_iters: int = 128) -> torch.Tensor:
    """(B, H, W) bool -> int32 labels (component min raster index;
    background holds `background_label(H, W)`). A CPU tensor takes the
    plain form (`label_components_plain`, with its sweep cap); a CUDA
    tensor launches the CCL kernel, which runs to the fixpoint, or
    raises."""
    if mask.device.type == "cpu":
        return label_components_plain(mask, connectivity, max_iters)
    from cadx_tpu_torch.kernels.ccl import label_components as ccl_kernel

    return ccl_kernel(mask.to(torch.bool).contiguous(), connectivity)


def label_components_plain(mask: torch.Tensor, connectivity: int = 8,
                           max_iters: int = 128) -> torch.Tensor:
    """The JAX algorithm on any device: a 4x-coarse labelling of
    all-foreground blocks seeds the fine one, as in JAX."""
    mask = mask.to(torch.bool)
    b, h, w = mask.shape
    init = None
    if h % 4 == 0 and w % 4 == 0 and min(h, w) >= 64:
        cmask = mask.view(b, h // 4, 4, w // 4, 4).all(dim=4).all(dim=2)
        clabels = _label_core(cmask, connectivity, max_iters)
        wc = w // 4
        fine_root = (clabels // wc) * 4 * w + (clabels % wc) * 4
        hint = torch.where(cmask, fine_root, torch.full_like(fine_root, h * w))
        init = hint.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    return _label_core(mask, connectivity, max_iters, init)


def largest_from_labels(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mask of the most frequent foreground label, the smallest label on
    ties (argmax returns the first maximum); empty for an empty mask."""
    b, h, w = mask.shape
    n = h * w
    flat = torch.where(mask, labels, torch.full_like(labels, n)).view(b, n).long()
    areas = torch.zeros((b, n + 1), dtype=torch.int32, device=mask.device)
    areas.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    best = areas[:, :n].argmax(dim=1).to(torch.int32)
    return mask & (labels == best.view(b, 1, 1))


def largest_component(mask: torch.Tensor, connectivity: int = 8,
                      max_iters: int = 128) -> torch.Tensor:
    """Bool mask of the largest connected foreground object per image. A
    CPU tensor takes the plain form; a CUDA tensor launches the CCL
    kernel and then the largest-component-mask kernel, as the JAX op
    dispatches its two Pallas kernels, or raises."""
    if mask.device.type == "cpu":
        return largest_component_plain(mask, connectivity, max_iters)
    from cadx_tpu_torch.kernels.mode import largest_component_mask

    mask = mask.to(torch.bool).contiguous()
    return largest_component_mask(label_components(mask, connectivity), mask)


def largest_component_plain(mask: torch.Tensor, connectivity: int = 8,
                            max_iters: int = 128) -> torch.Tensor:
    """The plain form on any device: labels, then the most frequent one."""
    mask = mask.to(torch.bool)
    labels = label_components_plain(mask, connectivity, max_iters)
    return largest_from_labels(labels, mask)


def flood_from(mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 128,
               connectivity: int = 4) -> torch.Tensor:
    """Pixels of `mask` connected to `seed`: one payload bit packed under
    the segment id, spread by cummax scans along rows and columns; the
    8-connected form adds a 3x3 max pass to each sweep, as JAX's
    `flood_relax` does."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    mask = mask.to(torch.bool)
    h, w = mask.shape[-2:]
    barriers = (~mask).to(torch.int32)
    row_seg = torch.cumsum(barriers, dim=-1, dtype=torch.int32)
    col_seg = torch.cumsum(barriers, dim=-2, dtype=torch.int32)
    rf, rb = row_seg << 1, (w + 1 - row_seg) << 1
    cf, cb = col_seg << 1, (h + 1 - col_seg) << 1
    m = mask.to(torch.int32)

    def sweep(reach: torch.Tensor) -> torch.Tensor:
        bit = (reach & mask).to(torch.int32)
        f = _cummax(rf | bit, -1)
        b = _cummax(rb | bit, -1, reverse=True)
        bit = ((f & 1) | (b & 1)) & m
        f = _cummax(cf | bit, -2)
        b = _cummax(cb | bit, -2, reverse=True)
        bit = ((f & 1) | (b & 1)) & m
        if connectivity == 8:
            bit = _window3(_window3(bit, -2, 0, torch.maximum), -1, 0, torch.maximum) & m
        return (bit == 1) & mask

    return _run_to_fixpoint(sweep, seed.to(torch.bool) & mask, max_iters)


def _border(h: int, w: int, device) -> torch.Tensor:
    border = torch.zeros((h, w), dtype=torch.bool, device=device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    return border


def fill_holes(mask: torch.Tensor, max_iters: int = 128) -> torch.Tensor:
    """Fill background regions that the border flood (4-connected) cannot
    reach. An image whose every row, or every column, is a single run has
    no holes and keeps its mask (the JAX single-run certificate)."""
    mask = mask.to(torch.bool)
    h, w = mask.shape[-2:]
    m = mask.to(torch.int32)
    left = F.pad(m[..., :, :-1], (1, 0))
    up = F.pad(m[..., :-1, :], (0, 0, 1, 0))
    rows_ok = (m & (1 - left)).sum(dim=-1).amax(dim=-1) <= 1
    cols_ok = (m & (1 - up)).sum(dim=-2).amax(dim=-1) <= 1
    cert = (rows_ok | cols_ok).view(-1, 1, 1)
    if bool(cert.all()):
        return mask
    inv = ~mask
    reach = flood_from(inv, _border(h, w, mask.device) & inv, max_iters)
    return torch.where(cert, mask, mask | (inv & ~reach))
