"""Mammogram cleaning, batched over a leading B.

Port of `cadx_tpu/preprocess/cleaner.py` (the DMImagePreprocessor
equivalent): artifact suppression, breast segmentation, pectoral removal,
the boundary-painted gray image, `process` and `clean_for_unet`. The
kernels: `largest_obj` in `select_largest_obj` and `segment_breast`,
`equalize` through `ops.histogram.equalize_hist`, and `pectoral_tail` in
`remove_pectoral` for sides <= 512; beyond, `remove_pectoral` composes the
ops as JAX does, with the watershed kernel behind
`ops.watershed.marker_watershed`. `clean_boundary_gray` runs its front
(suppress + segment) through the fused `cleaner_front` kernel, which the
JAX package has but keeps off its TPU path (`kernels/cleaner_front.py`
says why the card differs). Each wrapper launches its CUDA kernel for a
CUDA tensor and runs the plain composition of the ported ops for a CPU
tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cadx_tpu_torch.kernels.cleaner_front import cleaner_front
from cadx_tpu_torch.kernels.largest_obj import largest_obj, largest_obj_reference
from cadx_tpu_torch.kernels.pectoral import pectoral_tail
from cadx_tpu_torch.ops.geodesic_scan import use_packed
from cadx_tpu_torch.ops.histogram import equalize_hist
from cadx_tpu_torch.ops.morphology import dilate, erode, median_blur, opening
from cadx_tpu_torch.ops.resize import resize_area
from cadx_tpu_torch.ops.threshold import (binary_threshold, max_pix_val,
                                          relative_threshold_value, to_uint8)
from cadx_tpu_torch.ops.watershed import marker_watershed
from cadx_tpu_torch.utils.profiling import span


def _where_mask(mask: torch.Tensor, value: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.where(mask, torch.full((), value, dtype=dtype, device=mask.device),
                       torch.zeros((), dtype=dtype, device=mask.device))


def _largest(mask: torch.Tensor, max_iters: int | None, **opts) -> torch.Tensor:
    """The 8-connected `largest_obj` wrapper; with max_iters, its plain
    version on any device with that sweep cap (`cleaner_front_reference`
    runs the cleaner's stages so)."""
    if max_iters is None:
        return largest_obj(mask, 8, **opts)
    return largest_obj_reference(mask, 8, **opts, max_iters=max_iters)


def select_largest_obj(img_bin: torch.Tensor, lab_val: int = 255,
                       fill_holes_: bool = False,
                       smooth_boundary: bool = False,
                       kernel_size: int = 15,
                       max_iters: int | None = None) -> torch.Tensor:
    """Largest 8-connected object per image, optional hole fill and
    opening; lab_val where set (uint16 masks for lab_val > 255)."""
    out_dtype = torch.uint8 if lab_val <= 255 else torch.uint16
    mask = _largest(img_bin != 0, max_iters, fill=fill_holes_,
                    smooth_k=kernel_size if smooth_boundary else 0)
    return _where_mask(mask, lab_val, out_dtype)


def _bounding_rect(mask: torch.Tensor):
    """Per-image (x, y, w, h) of the True region, cv2.boundingRect; zeros
    for an empty mask. Each is a (B,) int64 tensor."""
    h, w = mask.shape[-2:]
    rows = mask.any(dim=-1).to(torch.int32)
    cols = mask.any(dim=-2).to(torch.int32)
    y0 = rows.argmax(dim=-1)
    y1 = h - rows.flip(-1).argmax(dim=-1)
    x0 = cols.argmax(dim=-1)
    x1 = w - cols.flip(-1).argmax(dim=-1)
    any_ = rows.any(dim=-1)
    zero = torch.zeros_like(x0)
    return (torch.where(any_, x0, zero), torch.where(any_, y0, zero),
            torch.where(any_, x1 - x0, zero), torch.where(any_, y1 - y0, zero))


def suppress_artifacts(img: torch.Tensor, global_threshold: float = 0.05,
                       kernel_size: int = 15, max_iters: int | None = None):
    """Keep the largest bright object per image and zero the rest; uint8
    or uint16. Returns (img_suppressed, breast_mask), the mask at the
    dtype's max."""
    maxval = max_pix_val(img.dtype)
    low_th = relative_threshold_value(img, global_threshold)
    img_bin = binary_threshold(img, low_th, maxval)
    breast_mask = select_largest_obj(img_bin, maxval, fill_holes_=True,
                                     smooth_boundary=True,
                                     kernel_size=kernel_size, max_iters=max_iters)
    return img & breast_mask, breast_mask


def segment_breast(img: torch.Tensor, low_int_threshold: float = 0.05,
                   max_iters: int | None = None):
    """Largest contour filled: the largest component of the hole-filled
    threshold mask. Returns (img_breast_only, contour_fill bool)."""
    img_8u = to_uint8(img)
    low_th = relative_threshold_value(img_8u, low_int_threshold)
    img_bin = binary_threshold(img_8u, low_th, 255)
    contour_fill = _largest(img_bin != 0, max_iters, fill_first=True)
    return torch.where(contour_fill, img, torch.zeros_like(img)), contour_fill


def segment_breast_mask(img: torch.Tensor, low_int_threshold: float = 0.05):
    """`segment_breast` with the mask's bounding rect. Returns
    (img_breast_only, (x, y, w, h))."""
    img_breast_only, contour_fill = segment_breast(img, low_int_threshold)
    return img_breast_only, _bounding_rect(contour_fill)


class PectoralResult(NamedTuple):
    img_breast_only: torch.Tensor   # equalized image masked to breast tissue
    img_equ: torch.Tensor           # equalized grayscale
    boundary: torch.Tensor          # watershed ridge (cv2's -1 pixels)
    breast_only_mask: torch.Tensor  # uint8 mask after opening


def remove_pectoral(img: torch.Tensor, breast_mask: torch.Tensor,
                    high_int_threshold: float = 0.8,
                    morph_kn_size: int = 3, n_morph_op: int = 7,
                    sm_kn_size: int = 25) -> PectoralResult:
    """Split the pectoral muscle from breast tissue with a watershed over
    markers 255 (eroded pectoral core), 128 (outside the dilated core) and
    64 (outside the breast mask)."""
    with span("cleaner.pectoral"):
        maxval = max_pix_val(img.dtype)
        img_equ = equalize_hist(img)
        high_th = relative_threshold_value(img, high_int_threshold)
        img_bin = binary_threshold(img_equ, high_th, maxval)

        if (use_packed(img.shape[-2:], 3)
                and (morph_kn_size % 2 == 1 or n_morph_op <= 1)):
            _, boundary, mask_b = pectoral_tail(
                img_equ, img_bin, breast_mask.to(torch.uint8), morph_kn_size,
                n_morph_op, sm_kn_size)
            breast_only_mask = _where_mask(mask_b, 255, torch.uint8)
            return PectoralResult(img_equ & breast_only_mask, img_equ, boundary,
                                  breast_only_mask)

        # the fused tail runs the packed watershed (sides <= 512), and its
        # centred window does not anchor an even element with repeats as the
        # composed erode/dilate do; every other case composes the ops, with
        # the pair-form watershed beyond 512
        pect_mask_init = select_largest_obj(img_bin, maxval, fill_holes_=True)
        pect_eroded = erode(pect_mask_init, morph_kn_size, n_morph_op)
        pect_dilated = dilate(pect_mask_init, morph_kn_size, n_morph_op)
        markers = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
        markers = torch.where(pect_eroded > 0, 255, markers)
        markers = torch.where(pect_dilated == 0, 128, markers)
        markers = torch.where(breast_mask == 0, 64, markers)
        with span("cleaner.watershed"):
            labels, boundary = marker_watershed(img_equ, markers, max_scan=8,
                                                marker_label_values=(255, 128, 64))
        breast_only = torch.where(boundary, 0, labels)
        breast_only_mask = _where_mask(breast_only == 128, 255, torch.uint8)
        breast_only_mask = opening(breast_only_mask, sm_kn_size)
        return PectoralResult(img_equ & breast_only_mask, img_equ, boundary,
                              breast_only_mask)


def process(img: torch.Tensor, median_filtering: bool = True,
            blur_kn_size: int = 3, artif_suppression: bool = True,
            low_int_threshold: float = 0.05, kernel_size: int = 15,
            pect_removal: bool = False, high_int_threshold: float = 0.8,
            **pect_kwargs):
    """The reference `DMImagePreprocessor.process` on a (B, H, W) batch:
    optional median blur, artifact suppression and, with pect_removal,
    the pectoral-removal result as the primary image. Returns (image,
    PectoralResult or None)."""
    img_proc = img
    if median_filtering:
        img_proc = median_blur(img_proc, blur_kn_size)
    if artif_suppression:
        img_proc, mask_ = suppress_artifacts(img_proc, global_threshold=low_int_threshold,
                                             kernel_size=kernel_size)
    else:
        # the reference's else-branch takes the mask from suppress_artifacts
        # at its defaults; the caller's thresholds do not reach it
        _, mask_ = suppress_artifacts(img_proc)
    if pect_removal:
        res = remove_pectoral(img_proc, mask_, high_int_threshold=high_int_threshold,
                              **pect_kwargs)
        return res.img_breast_only, res
    return img_proc, None


def boundary_image_gray(res: PectoralResult) -> torch.Tensor:
    """The ridge painted red on the equalized image, then BGR -> gray:
    red weighs 0.299."""
    g = res.img_equ.to(torch.float32)
    red = torch.full((), 0.299 * 255.0, dtype=torch.float32, device=g.device)
    return torch.where(res.boundary, red, g)


def clean_boundary_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 rescale -> suppress_artifacts(0.05, 15) ->
    segment_breast(0.05) -> remove_pectoral(0.8, 3, 7, 25) ->
    boundary-painted gray in [0, 255] float32, for a (B, H, W) batch. The
    suppress + segment front is one `cleaner_front` call."""
    with span("cleaner.front"):
        img_breast_only, breast_mask, _ = cleaner_front(to_uint8(img), 15, 0.05)
    res = remove_pectoral(img_breast_only, _where_mask(breast_mask, 255, torch.uint8),
                          0.8, 3, 7, 25)
    return boundary_image_gray(res)


def clean_for_unet(img: torch.Tensor) -> torch.Tensor:
    """The app's preprocessing for the U-Net encoder: the cleaning chain,
    a 512x512 INTER_AREA resize, [0, 1] gray. (B, H, W) -> (B, 512, 512).
    The divisor is a tensor: on the card a Python scalar divisor becomes a
    product with its float32 reciprocal, a tensor a true division, as on
    the CPU, so both devices give the same bits."""
    gray = clean_boundary_gray(img)
    with span("cleaner.resize"):
        gray = resize_area(gray, (512, 512))
    return gray / torch.full((), 255.0, device=gray.device)
