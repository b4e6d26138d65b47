"""Geodesic marker watershed in both forms — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/watershed_kernel.py::marker_watershed_pallas`
(its `pl.pallas_call` at :83), which runs the line-scan relaxation of
`ops/geodesic_scan.py` in VMEM, then `label_boundary`. Source:
`csrc/watershed.cu`. The form is chosen as the plain version chooses it:
packed when up to 3 `marker_label_values` are given and both sides are
<= 512, the (distance, label) pair form otherwise.

Pair form. The fixpoint is float32 and depends on the order of the
arithmetic, so a relaxation over neighbours would not reach the plain
version's values; the kernel repeats its arithmetic instead: srow/scol
are built in the Hillis-Steele order of `doubling_cumsum` (one block per
line, two shared-memory buffers); each directional pass takes, per pixel,
the min of d -/+ s over the window 1 + sum(doubling_steps(min(len,
max_scan))) of the pre-pass planes, nearest first with strict < (the
doubling min's tie rule), then cand = w +/- s where cand < d. Passes LR,
RL, TB, BT each read the previous pass's output (ping-pong planes), and
the sweeps stop when one changes no distance or after `max_iters`.
Layout: each pass is one grid-wide launch with a thread per pixel, so a
single 1536x1280 request fills the card; neighbouring threads read
neighbouring addresses along rows and, for column passes, along the row
of each window step. Bound: the window's 2*win loads a pixel per pass
(from L1/L2), and one stream synchronisation a sweep to read the changed
flag. At serving sizes the float32 sweeps never settle (rounding of
d - s + s keeps lowering distances once s passes ~1e4), so a request
runs all `max_iters` sweeps, as the plain version and JAX do.

Packed form. An integer min-plus fixpoint is unique, so the block-level
Bellman-Ford shared with the pectoral tail (`csrc/components.cuh`)
reaches the plain version's labels; one block per image, bound by its
hop count, as in `kernels/pectoral.py`. It runs to the fixpoint and
ignores `max_iters` and `max_scan`, which change only how fast the plain
version gets there.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops import geodesic_scan as G
from cadx_tpu_torch.ops.watershed import marker_watershed_plain

SOURCE = "cadx_tpu_torch/csrc/watershed.cu"
REPLACES = "cadx_tpu/kernels/watershed_kernel.py:83"
_PAIR_PLANES = 5     # srow, scol, d0, d1 (float32) and l1 (int32)
_PACKED_PLANES = 2   # q, pk (int32)


def marker_watershed_reference(image: torch.Tensor, markers: torch.Tensor,
                               max_iters: int = 256, max_scan: int = 256,
                               marker_label_values: tuple = ()):
    """Plain version: the line-scan ops of `ops/geodesic_scan.py`."""
    return marker_watershed_plain(image, markers, max_iters, max_scan,
                                  marker_label_values)


def _scan_window(length: int, max_scan: int) -> int:
    return 1 + sum(G.doubling_steps(min(length, max_scan)))


def marker_watershed(image: torch.Tensor, markers: torch.Tensor,
                     max_iters: int = 256, max_scan: int = 256,
                     marker_label_values: tuple = ()):
    """(B, H, W) image + int markers -> (labels int32, boundary bool). A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if image.device.type == "cpu":
        return marker_watershed_reference(image, markers, max_iters, max_scan,
                                          marker_label_values)
    if image.device.type != "cuda" or markers.device != image.device:
        raise ValueError(f"marker_watershed: expected CUDA tensors on one "
                         f"device, got {image.device} and {markers.device}")
    img = image.to(torch.float32).contiguous()
    mk = markers.to(torch.int32).contiguous()
    _build.check_input(img, torch.float32, "marker_watershed image")
    _build.check_input(mk, torch.int32, "marker_watershed markers")
    if mk.shape != img.shape:
        raise ValueError(f"marker_watershed: markers {tuple(mk.shape)} and "
                         f"image {tuple(img.shape)} differ")
    b, h, w = img.shape
    dev = img.device
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    boundary = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    if not b:
        return labels, boundary
    lib = _build.load()
    values = tuple(int(v) for v in marker_label_values)
    if values and G.use_packed((h, w), len(values)):
        scratch = torch.empty((b, _PACKED_PLANES, h, w), dtype=torch.int32,
                              device=dev)
        v = values + (0,) * (3 - len(values))
        rc = lib.cadx_watershed_packed(
            img.data_ptr(), mk.data_ptr(), labels.data_ptr(),
            boundary.data_ptr(), scratch.data_ptr(), b, h, w, v[0], v[1],
            v[2], len(values), _build.stream_ptr(dev))
        _build.check(rc, "cadx_watershed_packed")
    else:
        scratch = torch.empty((_PAIR_PLANES, b, h, w), dtype=torch.float32,
                              device=dev)
        flag = torch.empty((1,), dtype=torch.int32, device=dev)
        rc = lib.cadx_watershed_pair(
            img.data_ptr(), mk.data_ptr(), labels.data_ptr(),
            boundary.data_ptr(), scratch.data_ptr(), flag.data_ptr(), b, h, w,
            max_iters, _scan_window(w, max_scan), _scan_window(h, max_scan),
            _build.stream_ptr(dev))
        _build.check(rc, "cadx_watershed_pair")
    marker_watershed.launches += 1
    return labels, boundary


marker_watershed.launches = 0
