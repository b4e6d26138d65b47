"""The pectoral-removal tail after equalization — CUDA kernel and its
plain PyTorch version.

Replaces `cadx_tpu/kernels/pectoral.py::pectoral_tail_pallas` (its
`pl.pallas_call` at :124). Source: `csrc/pectoral.cu`, with the tiled
device code and launch plans it shares with largest_obj and cleaner_front
in `csrc/tiled_components.cuh` and the watershed relaxation it shares
with the packed marker watershed in `csrc/tiled_watershed.cuh`. Steps,
per image:
1. largest 8-connected component of the high-threshold mask, holes filled;
2. marker bands: erode and dilate with one (k-1)*n+1 window, centred
   (odd k);
3. markers 255 (eroded core), 128 (outside the dilated core), 64 (outside
   the breast mask), then the packed geodesic watershed -> labels;
4. the ridge boundary (label disagreements plus the 1-px frame), and the
   opening(sm_k) of (boundary == 0) & (labels == 128).

Layout (redesigned for the whole card): one C call issues a fixed plan
of launches on one stream, each over tiles x images in one flat grid, so
B=1 fills the card as B=64 does. Steps 1, 2 and 4 run on 32 x 32 tiles
of 1,024 threads: the tiled union-find CCL with areas, `largest_key` and
`select_label`, then the background's 4-connected CCL with border marks
and `fill_unmarked` (largest_obj's "fill" ordering: 9 launches and a
memset); four separable `window_pass` launches for the bands (erosion
ANDs and dilation ORs over the window cut to the image, which is what
the one-block kernel's min with fill 1 on p and on 1 - p did; a warp
walks a tile, each lane sliding the window along its line with a count
of the set pixels in it, two reads an output) and one that writes the
packed markers; one that writes the labels, the ridge and the
ridge-free breast label, and four window passes for the opening.
The watershed runs JAX's packed sweeps (`ops/geodesic_scan.py::
sweep_packed`) at `max_scan` until one changes nothing or `ws_max_iters`
ran, as `pectoral_tail_pallas` does, so its labels are JAX's also where
the cap binds: one cooperative launch (`csrc/tiled_watershed.cuh::
relax_capped`, shared with the packed marker watershed) whose persistent
grid writes the prefix sums of the packed step costs ((|dq| * K + 1) << 2,
K the next power of two >= H + W) along rows and columns, then runs the
sweeps with a grid sync after each: at the default max_scan 8 a sweep is
one pass over 64 x 64 tiles, each copied with a halo of 7 pixels to
shared memory, where the four directional passes run (each a windowed
min of pk -/+ s over the pre-pass values), and the tile's own pixels go
to the other of two planes. The stop rule is read on the device, so
nothing reads back to the host, and the call returns once the plan is
queued: `PLAN_LAUNCHES` launches in all. The markers' packed values at
the cleaner's inputs settle in 6-8 sweeps (the unlabeled strip between
the bands is 15-22 pixels wide). Unreached pixels keep 1 << 30, label 0;
int32 holds every path value for sides <= 512.
Scratch (`scratch_bytes`): a uint64 key an image, four int32 (the
sweeps' changed flags and their count), four int32 planes (the CCL's
labels and roots; then pk twice and the two prefix sums), three byte
planes and two flags a tile (the sweeps skip a tile whose region did not
change in the last sweep): 19 bytes a pixel (the one-block kernel kept six int32 planes,
24).

Bound: the function reads its three byte planes and writes labels,
boundary and mask once (9 bytes a pixel), and does `ONCE_OPS` operations
a pixel that no order of work avoids at the default windows (the largest
label, the hole fill's certificate, the two 15-wide bands, the markers,
the packed costs, the labels, the ridge and the 25-wide opening); the
sweeps themselves depend on the data and are counted apart, beside it. This design's
own floor is `PLAN_BYTES` a pixel, its launches each reading and writing
their planes once: the two CCLs 14 each (a label written by the local
pass, read and written by the flatten, the mask twice), the key and the
selection 11, the fill 6, the bands' and the opening's window passes 2
each, the markers 7, the prefix sums 9 (the image read, two int32 planes
written), one sweep 16 (pk and the two prefix sums read, pk written), the
ridge 10.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.kernels.largest_obj import largest_obj_reference
from cadx_tpu_torch.ops.morphology import dilate, erode, opening
from cadx_tpu_torch.ops.watershed import marker_watershed_plain

SOURCE = "cadx_tpu_torch/csrc/pectoral.cu"
REPLACES = "cadx_tpu/kernels/pectoral.py:124"
TILE = 32             # the tile side of every step (csrc/tiled_components.cuh)
STEPS = 4             # object, bands and markers, watershed, ridge and opening
PLAN_LAUNCHES = 20    # kernel launches a call, the watershed's one included
PLAN_BYTES = 103      # bytes a pixel the plan's launches move at the least, one sweep
ONCE_OPS = 224        # operations a pixel the function does once, at the least


def scratch_bytes(b: int, h: int, w: int) -> int:
    """The plan's scratch (`csrc/pectoral.cu`): a uint64 key an image,
    four int32 (the watershed's changed flags and its sweeps), four int32
    planes, three byte planes and two bytes a 32 x 32 tile (the sweeps'
    tile flags)."""
    return 8 * b + 16 + 19 * b * h * w + 2 * b * -(-h // TILE) * -(-w // TILE)


def pectoral_tail_reference(img_equ: torch.Tensor, img_bin: torch.Tensor,
                            breast_mask: torch.Tensor, morph_k: int = 3,
                            n_morph: int = 7, sm_k: int = 25,
                            max_iters: int = 128, ws_max_iters: int = 256,
                            max_scan: int = 8):
    """Plain version: the composed ops of the JAX `remove_pectoral`, plain
    on any device (the public `marker_watershed` would launch the watershed
    kernel on a CUDA tensor). Returns (labels int32, boundary bool, opened
    breast-only mask bool)."""
    pect = largest_obj_reference(img_bin > 0, 8, fill=True,
                                 max_iters=max_iters).to(torch.uint8)
    pect_eroded = erode(pect, morph_k, n_morph)
    pect_dilated = dilate(pect, morph_k, n_morph)
    markers = torch.zeros(img_equ.shape, dtype=torch.int32,
                          device=img_equ.device)
    markers = torch.where(pect_eroded > 0, 255, markers)
    markers = torch.where(pect_dilated == 0, 128, markers)
    markers = torch.where(breast_mask == 0, 64, markers)
    labels, boundary = marker_watershed_plain(img_equ, markers,
                                              max_iters=ws_max_iters,
                                              max_scan=max_scan,
                                              marker_label_values=(255, 128, 64))
    mask128 = (~boundary & (labels == 128)).to(torch.uint8)
    return labels, boundary, opening(mask128, sm_k) > 0


def run_plan(img_equ: torch.Tensor, img_bin: torch.Tensor, breast_mask: torch.Tensor,
             morph_k: int = 3, n_morph: int = 7, sm_k: int = 25, ws_max_iters: int = 256,
             max_scan: int = 8, steps: int = STEPS, sweeps: torch.Tensor | None = None):
    """The kernel's plan on CUDA tensors, up to `steps` of its steps (the
    outputs are whole only with all four; fewer serve timings by step).
    `sweeps`, a one-element int32 tensor on the same device, receives the
    watershed's sweeps."""
    for t, name in ((img_equ, "img_equ"), (img_bin, "img_bin"),
                    (breast_mask, "breast_mask")):
        _build.check_input(t, torch.uint8, f"pectoral_tail {name}")
        if t.shape != img_equ.shape or t.device != img_equ.device:
            raise ValueError(f"pectoral_tail: {name} is {tuple(t.shape)} on {t.device}, "
                             f"expected {tuple(img_equ.shape)} on {img_equ.device}")
    b, h, w = img_equ.shape
    if max(h, w) > 512:
        raise ValueError(f"packed watershed needs sides <= 512, got {h}x{w}")
    if ws_max_iters < 0:
        raise ValueError(f"pectoral_tail: ws_max_iters must be >= 0, got {ws_max_iters}")
    if sweeps is not None:
        _build.check_input(sweeps, torch.int32, "pectoral_tail sweeps", ndim=1)
        if sweeps.numel() != 1 or sweeps.device != img_equ.device:
            raise ValueError(f"pectoral_tail: sweeps must be one int32 on {img_equ.device}")
    dev = img_equ.device
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    boundary = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    mask = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    if not b:
        return labels, boundary, mask
    scratch = torch.empty(scratch_bytes(b, h, w), dtype=torch.uint8, device=dev)
    rc = _build.load().cadx_pectoral_tail(
        img_equ.data_ptr(), img_bin.data_ptr(), breast_mask.data_ptr(),
        labels.data_ptr(), boundary.data_ptr(), mask.data_ptr(), scratch.data_ptr(),
        None if sweeps is None else sweeps.data_ptr(), b, h, w, morph_k, n_morph, sm_k,
        ws_max_iters, max_scan, steps, _build.stream_ptr(dev))
    _build.check(rc, "cadx_pectoral_tail")
    pectoral_tail.launches += 1
    return labels, boundary, mask


def pectoral_tail(img_equ: torch.Tensor, img_bin: torch.Tensor,
                  breast_mask: torch.Tensor, morph_k: int = 3,
                  n_morph: int = 7, sm_k: int = 25, ws_max_iters: int = 256,
                  max_scan: int = 8):
    """(B, H, W) uint8 equalized image, high-threshold mask and breast
    mask -> (labels int32, boundary bool, mask bool). The watershed runs
    at most `ws_max_iters` sweeps at `max_scan`, as JAX's
    `pectoral_tail_pallas`. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if morph_k % 2 == 0 and n_morph > 1:
        raise ValueError(
            f"the pectoral tail needs an odd morph_k when n_morph > 1 (got "
            f"k={morph_k}); use the composed remove_pectoral path")
    if img_equ.device.type == "cpu":
        return pectoral_tail_reference(img_equ, img_bin, breast_mask, morph_k,
                                       n_morph, sm_k, ws_max_iters=ws_max_iters,
                                       max_scan=max_scan)
    return run_plan(img_equ, img_bin, breast_mask, morph_k, n_morph, sm_k, ws_max_iters,
                    max_scan)


pectoral_tail.launches = 0
