"""Spatial (height-axis) sharding: the encoder's conv1 and the cleaner's
windowed stages on image rows split over a mesh axis.

Port of `cadx_tpu/parallel/spatial.py`. XLA partitions JAX's windows and
inserts the halo exchanges; here each position gets its neighbours' edge
rows itself (`exchange_halo`: the edges of every position gathered over
the axis, each position taking the rows it reads), and the image-wide
maxima the cleaner needs are all-reduced. H shards over the "data" axis,
as in JAX: a caller chooses per call whether the axis holds many images
or the rows of a few huge ones. The helpers take the axis they run
over, so a batch on "data" with H on "model" composes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cadx_tpu_torch.ops.morphology import median_blur3
from cadx_tpu_torch.ops.threshold import (binary_threshold, image_max,
                                          relative_threshold_value, to_uint8)
from cadx_tpu_torch.parallel.data_parallel import gather_rows
from cadx_tpu_torch.parallel.mesh import DATA_AXIS, Axis, Mesh, Sharding
from cadx_tpu_torch.precision import full_fp32


def spatial_sharding(mesh: Mesh, dim: int = 1) -> Sharding:
    """(B, H, W, C) arrays with H (`dim`) split over the data axis."""
    return Sharding(mesh, dim)


def exchange_halo(axis: Axis, parts: list[torch.Tensor], above: int, below: int,
                  dim: int, zeros: bool) -> list[torch.Tensor]:
    """Each local part (its position's rows along `dim`) with `above` rows
    of the previous position's part before it and `below` rows of the
    next one's after it. At the image's own top and bottom the rows are
    zeros (`zeros`) or left out, for a window that replicates the border
    itself. Every part holds at least max(above, below) rows."""
    rows = parts[0].shape[dim]
    if rows < max(above, below):
        raise ValueError(f"a shard of {rows} rows cannot lend a halo of "
                         f"{max(above, below)}")
    edges = [torch.cat([p.narrow(dim, 0, below), p.narrow(dim, rows - above, above)], dim)
             for p in parts]
    edges = axis.all_gather(edges, axis.devices[0])
    out = []
    for pos, part in zip(axis.positions, parts):
        pieces = [part]
        if pos > 0:
            pieces.insert(0, edges[pos - 1].narrow(dim, below, above).to(part.device))
        elif zeros:
            pieces.insert(0, torch.zeros_like(part.narrow(dim, 0, above)))
        if pos < axis.size - 1:
            pieces.append(edges[pos + 1].narrow(dim, 0, below).to(part.device))
        elif zeros:
            pieces.append(torch.zeros_like(part.narrow(dim, 0, below)))
        out.append(torch.cat(pieces, dim))
    return out


def encoder_first_features_sharded(stem, parts: list[torch.Tensor],
                                   axis: Axis) -> list[torch.Tensor]:
    """`models.unet.encoder_first_features` (conv1, 7x7, stride 2, pad 3)
    on (B, R, W, C) row shards of one image batch along `axis`: output row
    j reads input rows 2j-3 .. 2j+3, so a shard of R rows (R even) takes 3
    rows from the shard above and 2 from the one below, zeros at the
    image's edges. Returns each part's (B, R/2, W/2, 64) output rows."""
    if parts[0].shape[1] % 2:
        raise ValueError(f"a conv1 shard needs an even row count, got {parts[0].shape[1]}")
    out = []
    with full_fp32():
        for x, dev in zip(exchange_halo(axis, parts, 3, 2, 1, zeros=True), axis.devices):
            y = F.conv2d(x.permute(0, 3, 1, 2), stem.conv1.to(dev), stride=2, padding=(0, 3))
            out.append(y.permute(0, 2, 3, 1))
    return out


def make_spatial_encoder(mesh: Mesh):
    """Encoder conv1 features with the input's H axis sharded over the
    mesh's data axis: `run(stem, img)` takes (B, H, W, C) and returns the
    whole (B, H/2, W/2, 64) on the mesh's home device."""
    axis = mesh.axis(DATA_AXIS)
    ss = spatial_sharding(mesh)

    def run(stem, img: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            parts = encoder_first_features_sharded(stem, ss.place(img), axis)
        return gather_rows(axis, parts, mesh.home, dim=1)

    return run


def make_spatial_cleaner(mesh: Mesh):
    """The cleaner's elementwise and windowed stages on a 2-D image whose
    rows are sharded over the mesh's data axis: `run(img)` computes
    to_uint8 -> median_blur3 -> relative_threshold_value(0.05) ->
    binary_threshold, with the image's max and the smoothed image's max
    all-reduced and the median's one-row halo exchanged (the image's top
    and bottom rows replicate, as cv2's border does). The components
    stages need whole images and stay out, as in JAX."""
    axis = mesh.axis(DATA_AXIS)
    ss = spatial_sharding(mesh, dim=1)

    def run(img: torch.Tensor) -> torch.Tensor:
        parts = ss.place(torch.as_tensor(img)[None])
        rows = parts[0].shape[1]
        mx = axis.all_max([image_max(p) for p in parts])
        raw8 = [to_uint8(p, m) for p, m in zip(parts, mx)]
        smoothed = [median_blur3(x).narrow(1, int(pos > 0), rows)
                    for pos, x in zip(axis.positions,
                                      exchange_halo(axis, raw8, 1, 1, 1, zeros=False))]
        mx = axis.all_max([image_max(s) for s in smoothed])
        out = [binary_threshold(s, relative_threshold_value(s, 0.05, m), 255)[0]
               for s, m in zip(smoothed, mx)]
        return gather_rows(axis, out, mesh.home)

    return run
