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
early. The wrapper adds them to the `host_syncs` counter and the sweeps
launched to `pair_sweeps` (`utils/profiling.py`). `max_iters` caps the sweeps exactly. A relaxed pixel, halo or
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

Packed form (redesigned for the whole card; held to JAX's sweeps). The
kernel runs JAX's own sweeps (`ops/geodesic_scan.py::sweep_packed`) at
`max_scan` until one changes nothing or `max_iters` ran, so after every
sweep its planes hold what the plain version's and JAX's hold, and where
the cap binds (a serpentine corridor) it stops where they stop.
`cadx_watershed_packed` issues three launches and never waits on the
host: a prologue writes the packed markers (dist << 2) | label over 32 x
32 tiles x images; the sweeps run in one cooperative launch
(`csrc/tiled_watershed.cuh::relax_capped`, shared with the pectoral tail,
which runs it on its uint8 equalized image): a persistent grid writes the
prefix sums of the packed step costs along rows and columns (q =
rint(image) read there; the plain version takes any integer-valued
float32), then runs the sweeps with a grid sync after each and the stop
rule on the device. Where both scan windows are at most 8 (max_scan <= 8,
as the cleaner calls it), a sweep is one pass over 64 x 64 tiles (32 x 32
where there would be fewer of those than SMs, `sweep_tile`): a
block copies its tile of pk and the prefix sums with a halo of win - 1
pixels to shared memory, runs the four passes there (each a windowed min of pk
-/+ s over the pre-pass values, the positions outside the image standing
for the unreached value as JAX's shift fill does) and writes its own
pixels to the other of two planes; a tile whose region no pixel fell in
during the last sweep is skipped (its output is its input, which the
other plane already holds). Wider windows (the default max_scan
256) take the line form: each pass a warp a line, the line in shared
memory, JAX's doubling mins there, a grid sync between the passes. The
arithmetic is int32, so every order of the mins is exact and only the
pass structure must be JAX's. An epilogue writes the labels
(values[label - 1], 0 unreached) and the ridge. `packed_form(...,
sweeps=t)` writes the sweeps run into a one-element int32 CUDA tensor.

Bound: bytes. The function reads the image and the markers and writes
labels and boundary once, 13 bytes a pixel (0.0010 ms at B=1 512² over
3.35 TB/s). This design's own floor is `packed_floor_bytes`: the
prologue 8 bytes a pixel (markers in, pk out), the prefix sums 12 (the
image in, srow and scol out), a tiled sweep 16 (pk, srow and scol in, pk
out), the epilogue 9 (pk in, labels and boundary out). It replaced a
form that relaxed tiles to their local fixpoints in rounds until the
global fixpoint, which ran past JAX's cap (PERF.md section 6 row 7).
"""

from __future__ import annotations

import ctypes

import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.ops import geodesic_scan as G
from cadx_tpu_torch.ops.watershed import marker_watershed_plain
from cadx_tpu_torch.utils.profiling import count, host_sync

SOURCE = "cadx_tpu_torch/csrc/watershed.cu"
REPLACES = "cadx_tpu/kernels/watershed_kernel.py:83"
_PAIR_PLANES = 5     # srow, scol, d0, d1 (float32) and l1 (int32)
PACKED_TILE = 32     # the packed form's marker and label tiles (kTile, csrc/tiled_components.cuh)
SWEEP_TILES = (64, 32)   # a tiled sweep's tile sides (csrc/tiled_watershed.cuh)
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
        packed_form(img, mk, values, labels, boundary, max_iters, max_scan)
    else:
        scratch = torch.empty((_PAIR_PLANES, b, h, w), dtype=torch.float32,
                              device=dev)
        flags = torch.empty((max(max_iters, 1),), dtype=torch.int32, device=dev)
        host_flags = torch.empty((max(-(-max_iters // CHECK_EVERY), 1),),
                                 dtype=torch.int32, pin_memory=True)
        syncs, sweeps = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.cadx_watershed_pair(
            img.data_ptr(), mk.data_ptr(), labels.data_ptr(),
            boundary.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
            host_flags.data_ptr(), ctypes.addressof(syncs), ctypes.addressof(sweeps), b, h,
            w, max_iters, _scan_window(w, max_scan), _scan_window(h, max_scan),
            *tile_for(b, h, w, torch.cuda.get_device_properties(dev).multi_processor_count),
            CHECK_EVERY, _build.stream_ptr(dev))
        _build.check(rc, "cadx_watershed_pair")
        host_sync(dev, syncs.value)
        count("pair_sweeps", sweeps.value)
    marker_watershed.launches += 1
    return labels, boundary


marker_watershed.launches = 0


def packed_tiles(b: int, h: int, w: int) -> int:
    """The packed form's marker and label tiles x images."""
    return b * -(-h // PACKED_TILE) * -(-w // PACKED_TILE)


def sweep_tile(b: int, h: int, w: int, sms: int = 132) -> int:
    """A tiled sweep's tile side for a (b, h, w) batch on a card of `sms`
    SMs, the C launcher's rule: 64 where there are at least as many 64 x 64
    tiles as SMs, else 32."""
    big = SWEEP_TILES[0]
    return big if b * -(-h // big) * -(-w // big) >= sms else SWEEP_TILES[1]


def sweep_tiles(b: int, h: int, w: int, sms: int = 132) -> int:
    """A tiled sweep's tiles x images."""
    t = sweep_tile(b, h, w, sms)
    return b * -(-h // t) * -(-w // t)


def sweep_tiled(h: int, w: int, max_scan: int) -> bool:
    """Whether the sweeps run over halo tiles (both windows at most 8) or
    in the line form."""
    return max(_scan_window(w, max_scan), _scan_window(h, max_scan)) <= MAX_HALO + 1


def packed_scratch_bytes(b: int, h: int, w: int) -> int:
    """`cadx_watershed_packed`'s scratch: four int32 planes (pk twice, the
    prefix sums along rows and columns), four int32 (the sweeps' changed
    flags and a sweeps slot) and two bytes a 32 x 32 tile (the sweeps'
    tile flags)."""
    return 16 * b * h * w + 16 + 2 * packed_tiles(b, h, w)


def packed_floor_bytes(b: int, h: int, w: int, sweeps: int) -> int:
    """The bytes the packed form's launches move at the least with tiled
    sweeps: the prologue 8 a pixel, the prefix sums 12, a sweep 16, the
    epilogue 9."""
    return (8 + 12 + 16 * sweeps + 9) * b * h * w


def packed_form(img: torch.Tensor, mk: torch.Tensor, values: tuple,
                labels: torch.Tensor, boundary: torch.Tensor, max_iters: int = 256,
                max_scan: int = 256, sweeps: torch.Tensor | None = None) -> None:
    """The packed form's launches (`cadx_watershed_packed`) into labels and
    boundary, for `marker_watershed`'s checked inputs: JAX's sweeps at
    `max_scan`, at most `max_iters`. Counted here apart from the pair form
    (`packed_form.launches`) as well as in `marker_watershed.launches`.
    `sweeps`, a one-element int32 tensor on the same device, receives the
    sweeps run."""
    b, h, w = img.shape
    if sweeps is not None:
        _build.check_input(sweeps, torch.int32, "packed_form sweeps", ndim=1)
        if sweeps.device != img.device:
            raise ValueError(f"packed_form: sweeps on {sweeps.device}, "
                             f"images on {img.device}")
    if max_iters < 0:
        raise ValueError(f"packed_form: max_iters must be >= 0, got {max_iters}")
    scratch = torch.empty((packed_scratch_bytes(b, h, w),), dtype=torch.uint8,
                          device=img.device)
    v = values + (0,) * (3 - len(values))
    rc = _build.load().cadx_watershed_packed(
        img.data_ptr(), mk.data_ptr(), labels.data_ptr(), boundary.data_ptr(),
        scratch.data_ptr(), None if sweeps is None else sweeps.data_ptr(), b, h,
        w, v[0], v[1], v[2], len(values), max_iters, max_scan,
        _build.stream_ptr(img.device))
    _build.check(rc, "cadx_watershed_packed")
    packed_form.launches += 1


packed_form.launches = 0
