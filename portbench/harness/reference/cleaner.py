"""The plain mammogram cleaner, batched over a leading B.

A frozen copy of the port's plain cleaning chain (its
`preprocess/cleaner.py` with the plain versions of the kernels it
dispatches to: `largest_obj_reference`, `cleaner_front_reference`,
`equalize_reference` and `pectoral_tail_reference`), plain torch on any
device. The benchmark computes with it what the port's cleaner must give
on the same inputs:

- `clean_boundary_gray`: rescale to uint8, suppress artifacts, segment the
  breast, remove the pectoral muscle by a marker watershed, paint the
  ridge red and convert to gray;
- `clean_for_unet`: the same, then a 512x512 INTER_AREA resize to [0, 1].

Up to 512 a side the pectoral watershed is the packed int32 form at
max_scan 8 (the port's pectoral_tail); beyond, the float32 (distance,
label) pair form, which `pectoral_watershed_inputs` exposes so that the
benchmark can count the sweeps these inputs need.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geodesic_scan as G
from .components import (fill_holes_plain, largest_component_plain)
from .morphology import dilate, erode, opening
from .resize import resize_area
from .threshold import (binary_threshold, max_pix_val, relative_threshold_value,
                        to_uint8)

WS_MAX_ITERS = 256   # the watershed's sweep cap, JAX's
WS_MAX_SCAN = 8      # the cleaner's scan window


def _where_mask(mask: torch.Tensor, value: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.where(mask, torch.full((), value, dtype=dtype, device=mask.device),
                       torch.zeros((), dtype=dtype, device=mask.device))


def largest_obj(masks: torch.Tensor, connectivity: int = 8, fill: bool = False,
                smooth_k: int = 0, fill_first: bool = False,
                max_iters: int = 128) -> torch.Tensor:
    """The largest component, optionally with holes filled (before or
    after) and an opening of smooth_k."""
    m = masks.to(torch.bool)
    if fill_first:
        m = fill_holes_plain(m, max_iters)
    out = largest_component_plain(m, connectivity, max_iters)
    if fill and not fill_first:
        out = fill_holes_plain(out, max_iters)
    if smooth_k:
        out = opening(out.to(torch.uint8), smooth_k) > 0
    return out


def select_largest_obj(img_bin: torch.Tensor, lab_val: int = 255,
                       fill_holes_: bool = False, smooth_boundary: bool = False,
                       kernel_size: int = 15) -> torch.Tensor:
    out_dtype = torch.uint8 if lab_val <= 255 else torch.uint16
    mask = largest_obj(img_bin != 0, 8, fill=fill_holes_,
                       smooth_k=kernel_size if smooth_boundary else 0)
    return _where_mask(mask, lab_val, out_dtype)


def suppress_artifacts(img: torch.Tensor, global_threshold: float = 0.05,
                       kernel_size: int = 15):
    maxval = max_pix_val(img.dtype)
    low_th = relative_threshold_value(img, global_threshold)
    img_bin = binary_threshold(img, low_th, maxval)
    breast_mask = select_largest_obj(img_bin, maxval, fill_holes_=True,
                                     smooth_boundary=True, kernel_size=kernel_size)
    return img & breast_mask, breast_mask


def segment_breast(img: torch.Tensor, low_int_threshold: float = 0.05):
    img_8u = to_uint8(img)
    low_th = relative_threshold_value(img_8u, low_int_threshold)
    img_bin = binary_threshold(img_8u, low_th, 255)
    contour_fill = largest_obj(img_bin != 0, 8, fill_first=True)
    return torch.where(contour_fill, img, torch.zeros_like(img)), contour_fill


def cleaner_front(raw_u8: torch.Tensor, smooth_k: int = 15, low_frac: float = 0.05):
    """(img_breast_only uint8, breast_mask bool, contour_fill bool)."""
    suppressed, mask1 = suppress_artifacts(raw_u8, low_frac, smooth_k)
    breast_only, contour = segment_breast(suppressed, low_frac)
    return breast_only, mask1 != 0, contour


def histogram256(img_u8: torch.Tensor) -> torch.Tensor:
    b = img_u8.shape[0]
    flat = img_u8.reshape(b, -1).to(torch.int64)
    hist = torch.zeros((b, 256), dtype=torch.int32, device=img_u8.device)
    return hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))


def equalize(img_u8: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist per image: lut = round((cdf - cdf_min) * 255 /
    max(N - cdf_min, 1)) in float32, half to even; one level passes."""
    b = img_u8.shape[0]
    hist = histogram256(img_u8)
    cdf = torch.cumsum(hist, dim=1, dtype=torch.int32)
    total = cdf[:, -1:]
    first_idx = (hist > 0).to(torch.int32).argmax(dim=1, keepdim=True)
    cdf_min = torch.gather(cdf, 1, first_idx)
    denom = torch.clamp_min(total - cdf_min, 1)
    lut = torch.round((cdf - cdf_min).to(torch.float32) * 255.0
                      / denom.to(torch.float32))
    lut = lut.clamp(0, 255).to(torch.uint8)
    flat = img_u8.reshape(b, -1).to(torch.int64)
    out = torch.gather(lut, 1, flat).view_as(img_u8)
    single_level = ((hist > 0).sum(dim=1) <= 1).view(b, 1, 1)
    return torch.where(single_level, img_u8, out)


def marker_watershed(image: torch.Tensor, markers: torch.Tensor, max_iters: int,
                     max_scan: int, marker_label_values: tuple = ()):
    """(labels int32, boundary bool): packed form for up to 3 marker values
    and sides <= 512, else the pair form."""
    img = image.to(torch.float32)
    if marker_label_values and G.use_packed(image.shape[-2:], len(marker_label_values)):
        labels = G.relax_to_fixpoint_packed(img, markers, max_iters, max_scan,
                                            label_values=marker_label_values)
    else:
        labels = G.relax_to_fixpoint(img, markers, max_iters, max_scan)
    return labels, G.label_boundary(labels) == 1


class PectoralResult(NamedTuple):
    img_breast_only: torch.Tensor
    img_equ: torch.Tensor
    boundary: torch.Tensor
    breast_only_mask: torch.Tensor


def _markers(img_bin: torch.Tensor, breast_mask: torch.Tensor, morph_k: int,
             n_morph: int, fill: bool) -> torch.Tensor:
    """255 in the eroded pectoral core, 128 outside its dilation, 64
    outside the breast."""
    pect = largest_obj(img_bin > 0, 8, fill=fill).to(torch.uint8)
    pect_eroded = erode(pect, morph_k, n_morph)
    pect_dilated = dilate(pect, morph_k, n_morph)
    markers = torch.zeros(img_bin.shape, dtype=torch.int32, device=img_bin.device)
    markers = torch.where(pect_eroded > 0, 255, markers)
    markers = torch.where(pect_dilated == 0, 128, markers)
    return torch.where(breast_mask == 0, 64, markers)


def _pectoral_inputs(img: torch.Tensor, high_int_threshold: float):
    maxval = max_pix_val(img.dtype)
    img_equ = equalize(img)
    high_th = relative_threshold_value(img, high_int_threshold)
    return img_equ, binary_threshold(img_equ, high_th, maxval)


def remove_pectoral(img: torch.Tensor, breast_mask: torch.Tensor,
                    high_int_threshold: float = 0.8, morph_kn_size: int = 3,
                    n_morph_op: int = 7, sm_kn_size: int = 25) -> PectoralResult:
    img_equ, img_bin = _pectoral_inputs(img, high_int_threshold)
    markers = _markers(img_bin, breast_mask, morph_kn_size, n_morph_op, True)
    labels, boundary = marker_watershed(img_equ, markers, WS_MAX_ITERS, WS_MAX_SCAN,
                                        (255, 128, 64))
    if G.use_packed(img.shape[-2:], 3):
        # the port's pectoral tail: the opening of the ridge-free breast label
        mask = opening((~boundary & (labels == 128)).to(torch.uint8), sm_kn_size) > 0
        breast_only_mask = _where_mask(mask, 255, torch.uint8)
    else:
        breast_only = torch.where(boundary, 0, labels)
        breast_only_mask = opening(_where_mask(breast_only == 128, 255, torch.uint8),
                                   sm_kn_size)
    return PectoralResult(img_equ & breast_only_mask, img_equ, boundary,
                          breast_only_mask)


def _front(img: torch.Tensor):
    img_breast_only, breast_mask, _ = cleaner_front(to_uint8(img), 15, 0.05)
    return img_breast_only, _where_mask(breast_mask, 255, torch.uint8)


def clean_boundary_gray(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> boundary-painted gray in [0, 255], float32."""
    res = remove_pectoral(*_front(img), 0.8, 3, 7, 25)
    g = res.img_equ.to(torch.float32)
    red = torch.full((), 0.299 * 255.0, dtype=torch.float32, device=g.device)
    return torch.where(res.boundary, red, g)


def clean_for_unet(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 512, 512) cleaned gray in [0, 1]; the divisor a
    tensor, as the port divides."""
    gray = resize_area(clean_boundary_gray(img), (512, 512))
    return gray / torch.full((), 255.0, device=gray.device)


def pectoral_watershed_inputs(img: torch.Tensor):
    """(equalized image, markers) of the cleaner's pectoral watershed for
    a (B, H, W) batch, as `clean_boundary_gray` forms them."""
    img_breast_only, breast_mask = _front(img)
    img_equ, img_bin = _pectoral_inputs(img_breast_only, 0.8)
    return img_equ, _markers(img_bin, breast_mask, 3, 7, True)


def pair_sweeps_needed(img: torch.Tensor) -> list[int]:
    """The pair-form sweeps each image's pectoral watershed needs to reach
    its fixpoint (the first sweep that changes no distance counted), at
    most `WS_MAX_ITERS`: the work a pair-form kernel must do on it."""
    img_equ, markers = pectoral_watershed_inputs(img)
    return [G.sweeps_to_fixpoint(img_equ[i:i + 1].to(torch.float32), markers[i:i + 1],
                                 WS_MAX_ITERS, WS_MAX_SCAN)
            for i in range(img.shape[0])]
