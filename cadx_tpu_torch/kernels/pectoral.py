"""The pectoral-removal tail after equalization — CUDA kernel and its
plain PyTorch version.

Replaces `cadx_tpu/kernels/pectoral.py::pectoral_tail_pallas` (its
`pl.pallas_call` at :124). Source: `csrc/pectoral.cu`, with the shared
device code in `csrc/components.cuh`. Steps, per image:
1. largest 8-connected component of the high-threshold mask, holes filled;
2. marker bands: erode and dilate with one (k-1)*n+1 window, centred
   (odd k);
3. markers 255 (eroded core), 128 (outside the dilated core), 64 (outside
   the breast mask);
4. packed geodesic watershed -> labels, then the ridge boundary (label
   disagreements plus the 1-px frame);
5. opening(sm_k) of (boundary == 0) & (labels == 128).

Layout: one block of 1024 threads per image, planes in global memory (a
scratch of 6 int32 planes per image), loops to convergence inside the
block. The watershed is a Bellman-Ford relaxation over 4-neighbours on
the packed value (dist << 2) | label with the step cost
((|dq| * K + 1) << 2), K the next power of two >= H + W: exactly what the
JAX line scans add up, so both reach the same fixpoint; unreached pixels
keep 1 << 30, label 0. Bound: the number of relaxation passes (the hop
length of the longest shortest path through the unlabeled band) times a
pass over the image from L2.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.kernels.largest_obj import largest_obj_reference
from cadx_tpu_torch.ops.morphology import dilate, erode, opening
from cadx_tpu_torch.ops.watershed import marker_watershed_plain

SOURCE = "cadx_tpu_torch/csrc/pectoral.cu"
REPLACES = "cadx_tpu/kernels/pectoral.py:124"
_SCRATCH_PLANES = 6


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


def pectoral_tail(img_equ: torch.Tensor, img_bin: torch.Tensor,
                  breast_mask: torch.Tensor, morph_k: int = 3,
                  n_morph: int = 7, sm_k: int = 25):
    """(B, H, W) uint8 equalized image, high-threshold mask and breast
    mask -> (labels int32, boundary bool, mask bool). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if morph_k % 2 == 0 and n_morph > 1:
        raise ValueError(
            f"the pectoral tail needs an odd morph_k when n_morph > 1 (got "
            f"k={morph_k}); use the composed remove_pectoral path")
    if img_equ.device.type == "cpu":
        return pectoral_tail_reference(img_equ, img_bin, breast_mask,
                                       morph_k, n_morph, sm_k)
    for t, name in ((img_equ, "img_equ"), (img_bin, "img_bin"),
                    (breast_mask, "breast_mask")):
        _build.check_input(t, torch.uint8, f"pectoral_tail {name}")
        if t.shape != img_equ.shape:
            raise ValueError(f"pectoral_tail: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(img_equ.shape)}")
    b, h, w = img_equ.shape
    if max(h, w) > 512:
        raise ValueError(f"packed watershed needs sides <= 512, got {h}x{w}")
    dev = img_equ.device
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    boundary = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    mask = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    if b:
        scratch = torch.empty((b, _SCRATCH_PLANES, h, w), dtype=torch.int32,
                              device=dev)
        lib = _build.load()
        rc = lib.cadx_pectoral_tail(
            img_equ.data_ptr(), img_bin.data_ptr(), breast_mask.data_ptr(),
            labels.data_ptr(), boundary.data_ptr(), mask.data_ptr(),
            scratch.data_ptr(), b, h, w, morph_k, n_morph, sm_k,
            _build.stream_ptr(dev))
        _build.check(rc, "cadx_pectoral_tail")
        pectoral_tail.launches += 1
    return labels, boundary, mask


pectoral_tail.launches = 0
