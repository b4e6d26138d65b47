"""Device meshes, their axes' collectives and row placement.

Port of `cadx_tpu/parallel/mesh.py`. JAX has one controller: a process
sees every device and XLA inserts the collectives. The port gives a user
both forms that this stands for:

- the local mesh: one process drives an (n_data, n_model) grid of torch
  devices, by default every visible card (`make_mesh()`); the tests give
  it `[torch.device("cpu")] * 8`;
- the distributed mesh: one process a card, every rank running the same
  program on the same host inputs (SPMD). `initialize_distributed()`
  joins the process group (NCCL for the card, gloo for the CPU), and
  `make_mesh()` then spans the world's ranks, each on `cuda:LOCAL_RANK`
  (or the `device` the caller names).

Axes: "data" splits batch rows (or image rows, `parallel.spatial`);
"model" is reserved and replicated, as in JAX. `Mesh.axis(name)` gives
one axis as this process sees it. Its collectives take the list of this
process's parts, one per position it drives: every position on a local
mesh, its own one on a distributed mesh. A distributed axis calls
`all_gather` and `all_reduce`, which NCCL and gloo both take on CUDA
tensors (gloo stages them through host memory itself).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this process sees it. `devices` holds the device
    of each position this process drives, positions `index`,
    `index + 1`, ...; `group` is the axis's process group on a
    distributed mesh (None on a local mesh and on an axis of size 1)."""

    size: int
    devices: tuple[torch.device, ...]
    group: object = None
    index: int = 0

    @property
    def positions(self) -> range:
        return range(self.index, self.index + len(self.devices))

    def all_gather(self, parts: list[torch.Tensor], device) -> list[torch.Tensor]:
        """Every position's part, in position order, on `device` (a
        distributed axis returns them on the part's own device). Parts of
        one shape and dtype."""
        if self.group is None:
            return [p.to(device) for p in parts]
        (part,) = parts
        part = part.contiguous()
        if part.numel() == 0:
            return [part] * self.size
        out = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(out, part, group=self.group)
        return out

    def all_sum(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """The sum over all positions, one a local part, on its device. A
        local axis adds the parts in position order on every device, so
        each position gets the same bits; a distributed axis all-reduces,
        and every rank receives the same reduced bits."""
        return self._reduce(parts, torch.add, dist.ReduceOp.SUM)

    def all_max(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        return self._reduce(parts, torch.maximum, dist.ReduceOp.MAX)

    def _reduce(self, parts, op, dist_op) -> list[torch.Tensor]:
        if self.group is None:
            out = []
            for dev in self.devices:
                acc = parts[0].to(dev, copy=True)
                for p in parts[1:]:
                    acc = op(acc, p.to(dev))
                out.append(acc)
            return out
        (part,) = parts
        acc = part.clone()
        dist.all_reduce(acc, op=dist_op, group=self.group)
        return [acc]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An (n_data, n_model) mesh. `grid` holds torch devices on a local
    mesh and ranks on a distributed one; `device`, `coords` and `groups`
    (axis name -> this rank's process group of that axis) are set on a
    distributed mesh only."""

    grid: np.ndarray
    device: torch.device | None = None
    coords: tuple[int, int] | None = None
    groups: dict | None = None

    @property
    def distributed(self) -> bool:
        return self.device is not None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.grid.shape[0], MODEL_AXIS: self.grid.shape[1]}

    @property
    def home(self) -> torch.device:
        """Where whole-batch results land: the first device of a local
        mesh, this rank's device on a distributed one."""
        return self.device if self.distributed else self.grid[0, 0]

    def axis(self, name: str, at: int = 0) -> Axis:
        """Axis `name` through this process. On a local mesh `at` picks
        the line of the other axis (the model column of the data axis, the
        data row of the model axis); a distributed rank sees its own."""
        dim = (DATA_AXIS, MODEL_AXIS).index(name)
        size = self.grid.shape[dim]
        if not self.distributed:
            line = self.grid[:, at] if dim == 0 else self.grid[at, :]
            return Axis(size, tuple(line))
        if name not in self.groups:
            return Axis(1, (self.device,))
        return Axis(size, (self.device,), self.groups[name], self.coords[dim])


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def make_mesh(n_data: int | None = None, n_model: int = 1, *, devices=None,
              device=None) -> Mesh:
    """A (data, model) mesh; by default every device on the data axis.

    With a process group initialized (and no `devices`), the mesh spans
    the world's ranks, which it must fill; this rank runs on `device`
    (default `cuda:LOCAL_RANK`). Otherwise a local mesh over `devices`,
    by default every visible card; without one this raises."""
    if devices is None and dist.is_available() and dist.is_initialized():
        return _distributed_mesh(n_data, n_model, device)
    if device is not None:
        raise ValueError("device names a rank's device on a distributed mesh; "
                         "give a local mesh its devices")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is available; pass devices= (e.g. "
                               "[torch.device('cpu')] * 8) for a CPU mesh")
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    _check_fits(n_data, n_model, len(devices), "devices")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[: n_data * n_model]):
        grid[i // n_model, i % n_model] = d
    return Mesh(grid)


def _check_fits(n_data: int, n_model: int, have: int, what: str) -> None:
    if n_data < 1 or n_model < 1 or n_data * n_model > have:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} {what}, "
                         f"have {have}")


def _distributed_mesh(n_data, n_model, device) -> Mesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    _check_fits(n_data, n_model, world, "ranks")
    if n_data * n_model != world:
        raise ValueError(f"a distributed mesh spans the world: {n_data}x{n_model} "
                         f"for {world} ranks")
    grid = np.arange(world).reshape(n_data, n_model)
    coords = (rank // n_model, rank % n_model)
    groups = {}
    # every rank creates every group, in one order (torch.distributed's
    # rule); an axis of one rank needs none, unless it is the whole world
    # (a world of one still runs its collectives, identities there)
    for name, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        if lines.shape[1] == 1 and world > 1:
            continue
        for line in lines:
            g = (dist.group.WORLD if len(line) == world
                 else dist.new_group([int(r) for r in line]))
            if rank in line:
                groups[name] = g
    dev = torch.device(device) if device is not None else torch.device("cuda", _local_rank())
    return Mesh(grid, dev, coords, groups)


def initialize_distributed(**kwargs) -> None:
    """Join the process group named by the environment (torchrun's
    WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT) or by `kwargs`
    (`init_process_group`'s: init_method, world_size, rank, ...). The
    backend is `backend`, else NCCL where a card is visible and gloo
    otherwise. A no-op when a group exists, or when neither names a
    world of more than one process (an explicit world_size=1 joins). A
    rendezvous that fails raises: a silent world of one would hide that
    no data parallelism happens."""
    if dist.is_initialized():
        return
    if "world_size" not in kwargs and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    backend = kwargs.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend=backend, **kwargs)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Placement of an array on a mesh: dimension `dim` split over "data"
    (`data_sharding`: dim 0), or whole on every device (`replicated`:
    dim None)."""

    mesh: Mesh
    dim: int | None

    def place(self, array) -> list[torch.Tensor]:
        """This process's parts, one a local data position (model column
        0), each on its device. A split needs a size divisible by n_data."""
        x = torch.as_tensor(array)
        axis = self.mesh.axis(DATA_AXIS)
        if self.dim is None:
            return [x.to(d) for d in axis.devices]
        return [x.narrow(self.dim, s.start, s.stop - s.start).to(d)
                for s, d in zip(row_slices(x.shape[self.dim], axis), axis.devices)]


def row_slices(rows: int, axis: Axis) -> list[slice]:
    """The rows of each local position when `rows` split evenly over the
    axis; a remainder raises ValueError, as a sharded jit does."""
    if rows % axis.size:
        raise ValueError(f"{rows} rows do not split evenly over an axis of "
                         f"{axis.size} positions")
    r = rows // axis.size
    return [slice(p * r, (p + 1) * r) for p in axis.positions]


def data_sharding(mesh: Mesh) -> Sharding:
    """Batch-axis placement: dim 0 split over "data"."""
    return Sharding(mesh, 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, *arrays):
    """Place host arrays' rows over the mesh's data axis: for each array,
    this process's parts (a list); one array gives its list alone."""
    ds = data_sharding(mesh)
    out = tuple(ds.place(a) for a in arrays)
    return out if len(out) > 1 else out[0]
