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
the min of d -/+ s over the window win = 1 + sum(doubling_steps(min(len,
max_scan))) of the pre-pass planes, nearest first with strict < (the
doubling min's tie rule), then cand = w +/- s where cand < d. Passes LR,
RL, TB, BT each read the previous pass's output, and the sweeps stop when
one changes no distance or after `max_iters`.

Layout (redesigned for the whole card): a sweep is one launch over
2-D tiles x images, 64 x 64 (512 threads, two blocks an SM) or, where
those would fill no more than one wave of the card, 64 x 128 (1024
threads; `tile_for`). A block copies its tile and a halo of win - 1
pixels on every side (7 at the cleaner's max_scan 8), cut to the image,
into shared memory with cp.async (16 bytes a pixel, 99 KB at 64 x 64):
srow and scol (at the tile's columns), which no sweep changes, as soon as
it starts, and the (d, l) pairs once the previous sweep has finished; the
sweeps are programmatic dependent launches, so the next sweep's blocks
copy their costs on the SMs the last blocks of a sweep leave idle. It
runs the four passes there, each leaving valid a region smaller by its
halo on the side it reads from, and writes d and l back for its own
pixels only, ping-ponging two global plane pairs. A pass is walked
by threads, one line a lane, 16 outputs a walk after 7 pixels that fill
the doubling steps 1, 2, 4 of `scan_min_carry` (three nearest-first
steps a pixel, from registers); a walk writes its outputs in place at
once but for the last 7, which the next walk along the line reads first
and which wait for a barrier. Indices are 32-bit and 2-D. Windows too
wide for a halo tile (a halo above `MAX_HALO` = 7, i.e. max_scan above
8, or a region beyond the block's 227 KB) take one launch a pass over a
2-D grid, reading global memory.

Stopping rule: no sweep waits on the host. Each sweep launch reads the
previous sweep's flag on the device and returns at once if it changed no
distance (a sweep that changes nothing leaves d and l as they are, so
every later one would too, and both plane pairs then hold the result);
the host copies every `CHECK_EVERY`-th flag to pinned memory, waits for
it only after queuing the next `CHECK_EVERY` sweeps, and stops launching
once one reads 0: ceil(max_iters / CHECK_EVERY) - 1 host
synchronisations for a call that runs them all, one more when it stops
early. `max_iters` caps the sweeps exactly. A relaxed pixel, halo or
not, reads only pixels the previous pass left valid, so a distance that
falls anywhere in a block falls in the sweep: the block's flag is exact.

Bound: operations. The function reads its inputs and writes its outputs
once, 13 bytes a pixel (0.03 ms at 3328 x 2560 over 3.35 TB/s), and does
the plain version's 56 operations a pixel a sweep at max_scan 8 (four
passes of d -/+ s, three doubling steps of a compare and two selects,
w +/- s, a compare and two selects). At the serving and CLI sizes the
float32 sweeps never settle (rounding of d - s + s keeps lowering
distances once s passes ~1e4), so a call runs all `max_iters` sweeps, as
the plain version and JAX do: 1.8 ms for 256 at 3328 x 2560 over 67
TFLOP/s. This design reads and writes its planes once a sweep, 24 bytes a
pixel (d, l, srow and scol read, d and l written: 61 us a sweep, 15.6 ms
for 256 at 3328 x 2560); that is its own floor, not the function's, since
a launch that ran several sweeps on a wider halo would move fewer bytes.
The tiles re-read their halos (1.5x the pixels at 64 x 64, partly from
L2), and the walks' loads and doubling steps hit shared memory and
registers.

Packed form (redesigned for the whole card). An integer min-plus
fixpoint is unique, so any relaxation order reaches the plain version's
labels; the kernel runs to the fixpoint and ignores `max_iters` and
`max_scan`, which change only how fast the plain version gets there (and
where JAX's 256-sweep cap binds, the plain version and JAX stop short of
it; ROADMAP Queue 3, "Noted"). `cadx_watershed_packed` issues three
launches over 32 x 32 tiles x images and never waits on the host: a
prologue writes q = rint(image) (int32: the plain version takes any
integer-valued float32), the packed markers (dist << 2) | label and the
first round's dirty flags (a tile holding an unreached pixel), with the
second round's and the rounds' changed flags zeroed (no memset); the
pectoral tail's relaxation
(`csrc/tiled_watershed.cuh::relax_to_fixpoint`, on int32 costs here, on
uint8 there) relaxes every dirty tile to its local fixpoint in shared
memory under a 1-pixel halo, a warp a tile (its row and column passes
alternating until one after the first changes nothing), in rounds with
grid syncs between them, all in one cooperative launch of as many blocks
as the card holds at once, until a round marks no tile; an epilogue writes the
labels (values[label - 1], 0 unreached) and the ridge, folding the pair
form's `boundary_kernel` into the same pass. `packed_form(...,
rounds=t)` writes the rounds run into a one-element int32 CUDA tensor.

Bound: bytes. The function reads the image and the markers and writes
labels and boundary once, 13 bytes a pixel (0.0010 ms at B=1 512² over
3.35 TB/s). This design's own floor is `packed_floor_bytes`: the
prologue 16 bytes a pixel (image and markers in, q and pk out), a round
12 (q read, pk read and written), the epilogue 9 (pk in, labels and
boundary out). The one-block kernel it replaced (`csrc/legacy/
watershed_packed_one_block.cu`, built only by `_build.load_legacy`) ran
one block of 1,024 threads an image over the whole plane in global
memory, a block barrier a Bellman-Ford sweep.
"""

from __future__ import annotations

import ctypes

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops import geodesic_scan as G
from cadx_tpu_torch.ops.watershed import marker_watershed_plain

SOURCE = "cadx_tpu_torch/csrc/watershed.cu"
REPLACES = "cadx_tpu/kernels/watershed_kernel.py:83"
_PAIR_PLANES = 5     # srow, scol, d0, d1 (float32) and l1 (int32)
PACKED_TILE = 32     # the packed form's tile side (kTile, csrc/tiled_components.cuh)
TILES = ((64, 64), (64, 128))   # the tiled sweep's tiles (rows, columns)
MAX_HALO = 7              # the widest halo a tiled sweep takes (max_scan <= 8)
CHECK_EVERY = 16          # sweeps between two host reads of the changed flags


def marker_watershed_reference(image: torch.Tensor, markers: torch.Tensor,
                               max_iters: int = 256, max_scan: int = 256,
                               marker_label_values: tuple = ()):
    """Plain version: the line-scan ops of `ops/geodesic_scan.py`."""
    return marker_watershed_plain(image, markers, max_iters, max_scan,
                                  marker_label_values)


def _scan_window(length: int, max_scan: int) -> int:
    return 1 + sum(G.doubling_steps(min(length, max_scan)))


def halo(length: int, max_scan: int) -> int:
    """The pixels a pass along a line of `length` reads on one side: the
    scan window less one."""
    return _scan_window(length, max_scan) - 1


def tile_for(b: int, h: int, w: int, sms: int = 132) -> tuple[int, int]:
    """The tiled sweep's tile for a (b, h, w) batch on a card of `sms` SMs:
    64 x 64 (two blocks an SM), or 64 x 128 (one) where the 64 x 64 tiles
    would fill no more than one wave of the card, so that no SM runs two
    tiles while another runs one."""
    small = TILES[0]
    if b * -(-h // small[0]) * -(-w // small[1]) <= 2 * sms:
        return TILES[1]
    return small


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
        packed_form(img, mk, values, labels, boundary)
    else:
        scratch = torch.empty((_PAIR_PLANES, b, h, w), dtype=torch.float32,
                              device=dev)
        flags = torch.empty((max(max_iters, 1),), dtype=torch.int32, device=dev)
        host_flags = torch.empty((max(-(-max_iters // CHECK_EVERY), 1),),
                                 dtype=torch.int32, pin_memory=True)
        syncs = ctypes.c_int(0)
        rc = lib.cadx_watershed_pair(
            img.data_ptr(), mk.data_ptr(), labels.data_ptr(),
            boundary.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
            host_flags.data_ptr(), ctypes.addressof(syncs), b, h, w, max_iters,
            _scan_window(w, max_scan), _scan_window(h, max_scan),
            *tile_for(b, h, w, torch.cuda.get_device_properties(dev).multi_processor_count),
            CHECK_EVERY, _build.stream_ptr(dev))
        _build.check(rc, "cadx_watershed_pair")
        marker_watershed.host_syncs = syncs.value
    marker_watershed.launches += 1
    return labels, boundary


marker_watershed.launches = 0
marker_watershed.host_syncs = 0   # host synchronisations of the last pair-form call


def packed_tiles(b: int, h: int, w: int) -> int:
    """The packed form's tiles x images."""
    return b * -(-h // PACKED_TILE) * -(-w // PACKED_TILE)


def packed_scratch_bytes(b: int, h: int, w: int) -> int:
    """`cadx_watershed_packed`'s scratch: two int32 planes (q, pk), four
    int32 (the rounds' changed flags and a rounds slot) and two dirty
    flags a tile."""
    return 8 * b * h * w + 16 + 2 * packed_tiles(b, h, w)


def packed_floor_bytes(b: int, h: int, w: int, rounds: int) -> int:
    """The bytes the packed form's launches move at the least: the
    prologue 16 a pixel, a round 12, the epilogue 9."""
    return (16 + 12 * rounds + 9) * b * h * w


def packed_form(img: torch.Tensor, mk: torch.Tensor, values: tuple,
                labels: torch.Tensor, boundary: torch.Tensor,
                rounds: torch.Tensor | None = None) -> None:
    """The packed form's launches (`cadx_watershed_packed`) into labels and
    boundary, for `marker_watershed`'s checked inputs; counted here apart
    from the pair form (`packed_form.launches`) as well as in
    `marker_watershed.launches`. `rounds`, a one-element int32 tensor on
    the same device, receives the relaxation's rounds."""
    b, h, w = img.shape
    if rounds is not None:
        _build.check_input(rounds, torch.int32, "packed_form rounds", ndim=1)
        if rounds.device != img.device:
            raise ValueError(f"packed_form: rounds on {rounds.device}, "
                             f"images on {img.device}")
    scratch = torch.empty((packed_scratch_bytes(b, h, w),), dtype=torch.uint8,
                          device=img.device)
    v = values + (0,) * (3 - len(values))
    rc = _build.load().cadx_watershed_packed(
        img.data_ptr(), mk.data_ptr(), labels.data_ptr(), boundary.data_ptr(),
        scratch.data_ptr(), None if rounds is None else rounds.data_ptr(), b, h,
        w, v[0], v[1], v[2], len(values), _build.stream_ptr(img.device))
    _build.check(rc, "cadx_watershed_packed")
    packed_form.launches += 1


packed_form.launches = 0
