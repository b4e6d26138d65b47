"""Connected-component labelling — CUDA kernel and its plain PyTorch
version.

Replaces `cadx_tpu/kernels/ccl.py::label_components_pallas` (its
`pl.pallas_call` at :166). Source: `csrc/ccl.cu`, with the union-find of
`csrc/components.cuh`. Each foreground pixel gets the minimum raster index
of its 4- or 8-connected component; background gets
`ops.components.background_label(H, W)`, the value the plain version
gives at that shape. Any H and W: the TPU kernel's power-of-two tiling and
int32 packing limit do not apply to union-find.

Layout: one block of 1024 threads per image, the label plane and a 0/1
foreground plane in global memory (L2-resident up to a few MB a plane),
looping to convergence inside the block. Union-find always links to the
smaller root, so labels only fall and end at the component minimum; path
compression after each round keeps chains short. Bound: the latency of
the dependent L2 loads of each round, times the rounds (a few for blob
masks). One block per image uses one SM: a single 1536x1280 mask leaves
the other 131 idle, while the CAM masks of the serving path are tiny.
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
    if b:
        scratch = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
        rc = _build.load().cadx_ccl(
            mask.data_ptr(), labels.data_ptr(), scratch.data_ptr(), b, h, w,
            connectivity, background_label(h, w), _build.stream_ptr(mask.device))
        _build.check(rc, "cadx_ccl")
        label_components.launches += 1
    return labels


label_components.launches = 0
