"""Binary flood fill from a seed within a mask — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/flood.py::flood_from_pallas` (its
`pl.pallas_call` at :116), the border flood of `fill_holes` and the
seeded component's flood. Source: `csrc/flood.cu`.

The kernel computes the plain sweep exactly, in its order: reach spreads
over each row run of the mask, then over each column run, then, 8-
connected, to the 3x3 neighbourhood within the mask (JAX's
`flood_relax`); it stops when a sweep changes nothing or after `max_iters`
sweeps, so it is bit-exact against the plain version also after a capped
run.

Layout: one block per image (256 threads up to 256², else 1024), sweeping
inside the block with one barrier a phase and a block-wide OR for the
"changed" flag. The planes are bit-packed, 32 pixels a word: mask and
reach by rows, mask and a temporary by columns. A run fill is a
Kogge-Stone fill inside a word (5 shift-and-mask steps) with the carry
handed from word to word, forward then backward, one thread a row (or a
column, after a 32x32 bit transpose of 32 warp ballots a block). Up to
200 KB of planes (about 512² pixels) live in shared memory, larger ones
in a global scratch the L2 holds. Bound: bytes, the mask and seed read
once and the reach written once (3 bytes a pixel) at the card's memory
rate, floored at one operation a pixel; e.g. 256² B=64 cannot take less
than 3.8 us. A sweep costs about H + W dependent word steps, so a
serpentine that needs hundreds of sweeps is latency-bound, far from it.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.components import flood_from_plain

SOURCE = "cadx_tpu_torch/csrc/flood.cu"
REPLACES = "cadx_tpu/kernels/flood.py:116"
# planes up to this many bytes live in shared memory (csrc/flood.cu)
_SMEM_LIMIT = 200 * 1024


def _plane_words(h: int, w: int) -> int:
    """uint32 words of one image's planes: three row-packed (mask, reach,
    temporary), two column-packed (mask, temporary), odd strides."""
    nw, nh = (w + 31) // 32, (h + 31) // 32
    return 3 * h * (nw | 1) + 2 * w * (nh | 1)


def flood_from_reference(mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 128,
                         connectivity: int = 4) -> torch.Tensor:
    """Plain version: `ops.components.flood_from_plain` (packed cummax
    scans, JAX's sweep cap), plain on any device."""
    return flood_from_plain(mask, seed, max_iters, connectivity)


def flood_from(mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 128,
               connectivity: int = 4) -> torch.Tensor:
    """(B, H, W) bool mask and seed -> (B, H, W) bool, the pixels of the
    mask connected to the seed (after at most `max_iters` sweeps). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if mask.device.type == "cpu":
        return flood_from_reference(mask, seed, max_iters, connectivity)
    _build.check_input(mask, torch.bool, "flood_from")
    _build.check_input(seed, torch.bool, "flood_from")
    if seed.shape != mask.shape or seed.device != mask.device:
        raise ValueError(f"flood_from: seed {tuple(seed.shape)} on {seed.device} does not "
                         f"match mask {tuple(mask.shape)} on {mask.device}")
    b, h, w = mask.shape
    out = torch.empty_like(mask)
    if out.numel():
        words = _plane_words(h, w)
        scratch = None
        if 4 * words > _SMEM_LIMIT:
            scratch = torch.empty(b * words, dtype=torch.int32, device=mask.device)
        rc = _build.load().cadx_flood_from(
            mask.data_ptr(), seed.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, h, w, int(max_iters),
            connectivity, _build.stream_ptr(mask.device))
        _build.check(rc, "cadx_flood_from")
        flood_from.launches += 1
    return out


flood_from.launches = 0
