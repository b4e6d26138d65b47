"""Binary flood fill from a seed within a mask — CUDA kernel and its plain
PyTorch version.

Replaces `cadx_tpu/kernels/flood.py::flood_from_pallas` (its
`pl.pallas_call` at :116), the border flood of `fill_holes`. Source:
`csrc/flood.cu`. No path of the port runs it: the cleaner's hole fills
run inside the tiled kernels (`csrc/tiled_components.cuh::fill_holes`),
and `ops.components.flood_from` / `fill_holes` launch it only where a
caller hands them CUDA tensors.

The kernel computes the plain sweep exactly, in its order: reach spreads
over each row run of the mask, then over each column run, then, 8-
connected, to the 3x3 neighbourhood within the mask (JAX's
`flood_relax`); it stops when a sweep changes nothing or after `max_iters`
sweeps, so it is bit-exact against the plain version also after a capped
run. A union-find would give the fixpoint but not that state.

Layout (redesigned for the whole card): one cooperative launch of as many
blocks as the card holds at once (no more than its largest step has work
for) runs every sweep, with a grid barrier between steps and no host
synchronisation. The planes are bit-packed, 32 pixels a word, in a global
scratch L2 holds: mask and reach by rows, mask and the row step's output
by columns, the column step's output by rows; row words are stored
word-major and column words band-major, so that every step moves whole
128-byte lines. The row step takes a band of 32 rows of one image a block,
a row a warp: a row's run fill is a segmented scan over its words, 32 at a
time (a Kogge-Stone fill inside each word, and one over the warp's ballots
of words that end reached and words that are all mask), forward then
backward; where a row holds at most 16 words a warp fills several rows in
one pass, each in its own segment of lanes. Then 32x32 bit transposes turn
the band into column words. The column step is the same over bands of 32
columns, transposed back. The 8-connected 3x3 step is word-parallel (rows
above and below ORed, shifted a bit each way) and is folded into the next
sweep's row step, which reads the column step's plane and writes the
reach. Every block reads the same "changed" flag after the same barrier,
so all stop at the same sweep. Blocks of 256 threads where the longest
line holds at most 16 words, else 1,024. The kernel writes the sweeps it
ran into `sweeps` (a one-element int32 CUDA tensor) when one is given.

Bound: bytes, the mask and seed read once and the reach written once (3
bytes a pixel) at the card's memory rate, floored at one operation a
pixel; e.g. 256² B=64 cannot take less than 3.8 us. A sweep costs two
grid barriers and two band passes whatever the image's size, so a
serpentine that needs hundreds of sweeps is latency-bound, far from it.

Limits: the band's lines are staged in shared memory, 2 * 32 *
odd(max(ceil(W / 32), ceil(H / 32), 32)) words a block (`shared_bytes`),
so sides up to 29,024 pixels on an H100 (227 KB a block); the C entry
point refuses beyond.
"""

from __future__ import annotations

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops.components import flood_from_plain

SOURCE = "cadx_tpu_torch/csrc/flood.cu"
REPLACES = "cadx_tpu/kernels/flood.py:116"
_FLAGS = 3   # int32 words before the planes: the rotating changed flags


def scratch_words(b: int, h: int, w: int) -> int:
    """int32 words of the kernel's scratch: the flags, then three
    row-packed planes (mask, reach, the column step's output) and two
    column-packed ones (mask, the row step's output), 32 pixels a word."""
    nw, nh = -(-w // 32), -(-h // 32)
    return _FLAGS + b * (3 * h * nw + 2 * w * nh)


def shared_bytes(h: int, w: int) -> int:
    """Dynamic shared memory a block takes: a band's 32 mask lines and 32
    reach lines (at least 32 words long, for the pack's 32 x 32 blocks), of
    odd stride so that a transpose's 32 lines fall in 32 banks."""
    return 2 * 32 * (max(-(-w // 32), -(-h // 32), 32) | 1) * 4


def flood_from_reference(mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 128,
                         connectivity: int = 4) -> torch.Tensor:
    """Plain version: `ops.components.flood_from_plain` (packed cummax
    scans, JAX's sweep cap), plain on any device."""
    return flood_from_plain(mask, seed, max_iters, connectivity)


def flood_from(mask: torch.Tensor, seed: torch.Tensor, max_iters: int = 128,
               connectivity: int = 4, sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W) bool mask and seed -> (B, H, W) bool, the pixels of the
    mask connected to the seed (after at most `max_iters` sweeps). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. `sweeps`, a one-element int32 tensor on the mask's CUDA device,
    receives the sweeps the kernel ran."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if mask.device.type == "cpu":
        return flood_from_reference(mask, seed, max_iters, connectivity)
    _build.check_input(mask, torch.bool, "flood_from")
    _build.check_input(seed, torch.bool, "flood_from")
    if seed.shape != mask.shape or seed.device != mask.device:
        raise ValueError(f"flood_from: seed {tuple(seed.shape)} on {seed.device} does not "
                         f"match mask {tuple(mask.shape)} on {mask.device}")
    if sweeps is not None and (sweeps.device != mask.device or sweeps.dtype != torch.int32
                               or sweeps.numel() != 1):
        raise ValueError("flood_from: sweeps must be one int32 on the mask's device")
    b, h, w = mask.shape
    out = torch.empty_like(mask)
    if out.numel():
        scratch = torch.empty(scratch_words(b, h, w), dtype=torch.int32, device=mask.device)
        rc = _build.load().cadx_flood_from(
            mask.data_ptr(), seed.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            None if sweeps is None else sweeps.data_ptr(), b, h, w, int(max_iters),
            connectivity, _build.stream_ptr(mask.device))
        _build.check(rc, "cadx_flood_from")
        flood_from.launches += 1
    return out


flood_from.launches = 0
