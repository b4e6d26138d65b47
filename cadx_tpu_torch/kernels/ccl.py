"""Connected-component labelling — CUDA kernel and its plain PyTorch
version.

Replaces `cadx_tpu/kernels/ccl.py::label_components_pallas` (its
`pl.pallas_call` at :166). Source: `csrc/ccl.cu`, with the tiled
union-find of `csrc/tiled_components.cuh` that cleaner_front, largest_obj
and pectoral_tail run. Each foreground pixel gets the minimum raster index
of its 4- or 8-connected component; background gets
`ops.components.background_label(H, W)`, the value the plain version
gives at that shape. Any H and W: the TPU kernel's power-of-two tiling and
int32 packing limit do not apply to union-find.

Layout (redesigned for the whole card), in two forms that `form_for`
chooses by shape. The tiled form, for any shape: the grid covers 32 x 32
tiles x images in one flat dimension, and one C call queues three
launches on one stream with no host sync: `ccl_local` labels each tile in
shared memory (warp-ballot row runs, atomicMin-linked roots), `ccl_merge`
joins the tiles' edges through roots in global memory, and
`flatten_labels` points each foreground pixel at its root and writes the
background value where the mask is 0; the scratch plane takes
`ccl_local`'s root marks, which this CCL does not read. The cluster form,
for planes of at most 64 x 64 (the serving path's CAM masks, B=3 62x62
and B=1 6x6): one launch, a cluster of four blocks an image, each block a
band of rows, one pixel a thread, its parents in shared memory: run
starts from 64-bit row masks as parents, the joins `ccl_local` makes
inside the band, then (after a cluster barrier) the joins across bands
through the cluster's distributed shared memory, and each band root's
image root found once. At 62x62 the tiled form spends three launches on
12 blocks and follows its merge's chains of roots through L2; one block
an image, tried first, ran its four pixels a thread one after another.
Every link goes from a larger root to a smaller index of the same
component, so each root ends as its component's smallest raster index
whatever order the atomics take: the labels are the same on every run.

Bound: bytes (the mask in, the labels out: 5 bytes a pixel); at the CAM
shapes the three launches' fixed cost is all there is.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.components import background_label, label_components_plain

SOURCE = "cadx_tpu_torch/csrc/ccl.cu"
REPLACES = "cadx_tpu/kernels/ccl.py:166"


def label_components_reference(mask: torch.Tensor, connectivity: int = 8,
                               max_iters: int = 128) -> torch.Tensor:
    """Plain version: the JAX sweep algorithm (sweep cap `max_iters`)."""
    return label_components_plain(mask, connectivity, max_iters)


CLUSTER_SIDE = 64   # the cluster form's largest side (csrc/ccl.cu)


def form_for(h: int, w: int) -> str:
    """The form `label_components` launches at (h, w): "cluster" where
    both sides are at most CLUSTER_SIDE, else "tiled" (the C entry point's
    rule, which the wrapper needs to know whether to allocate the tiled
    form's scratch; "tiled" also forbids the cluster form there)."""
    return "cluster" if h <= CLUSTER_SIDE and w <= CLUSTER_SIDE else "tiled"


def label_components(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int32 labels. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if mask.device.type == "cpu":
        return label_components_reference(mask, connectivity)
    _build.check_input(mask, torch.bool, "label_components")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    b, h, w = mask.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    if labels.numel():
        cluster = form_for(h, w) == "cluster"
        scratch = None if cluster else torch.empty_like(labels)
        rc = _build.load().cadx_ccl(
            mask.data_ptr(), labels.data_ptr(), None if cluster else scratch.data_ptr(), b,
            h, w, connectivity, background_label(h, w), int(cluster),
            _build.stream_ptr(mask.device))
        _build.check(rc, "cadx_ccl")
        label_components.launches += 1
    return labels


label_components.launches = 0
