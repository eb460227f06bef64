"""The port's device mesh (JAX reference: parallel/mesh.py).

The JAX package builds one jax.sharding.Mesh and lets XLA insert the
collectives. The port runs one process a card, a rank of torch.distributed,
and places its collectives itself. A `Mesh` is a (data, model) grid of
either

  * the ranks of the process group (training): rank i sits at
    (i // model, i % model), where the JAX mesh puts device i. The mesh holds
    the calling rank's data-axis group (the ranks with its model index, over
    which gradients and BatchNorm statistics are summed) and its model-axis
    group (the ranks with its data index, which split the heads and the FFN
    of one batch shard);
  * or local devices (serving, `Lip2SpeechPipeline.set_mesh`), with no
    process group: torch devices, one replica each. A device may repeat
    (two replicas on one card).

`make_mesh` over ranks is collective: every rank of the process group calls
it with the same arguments, since each process group of the grid is created
by all of them.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dimension,
    as jax.sharding.PartitionSpec."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray          # (data, model) object array of ranks (int) or torch.device
    data_group: Any = None       # the calling rank's groups; None without a process group
    model_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def distributed(self) -> bool:
        """A mesh of ranks, whose axes are process groups."""
        return self.data_group is not None

    def coords(self) -> tuple[int, int]:
        """(data index, model index) of the calling rank."""
        import torch.distributed as dist

        where = np.argwhere(self.devices == dist.get_rank())
        if not self.distributed or len(where) != 1:
            raise ValueError("the calling process is not a rank of this mesh")
        return int(where[0][0]), int(where[0][1])

    @property
    def data_index(self) -> int:
        return self.coords()[0]

    @property
    def model_index(self) -> int:
        return self.coords()[1]


def require_ranks(mesh: Mesh | None) -> None:
    """Refuse a mesh of local devices where the caller needs one of ranks
    (the train steps; serving takes the other kind)."""
    if mesh is not None and not mesh.distributed:
        raise ValueError("training takes a mesh of ranks (a process group), not of local "
                         "devices")


def local_devices() -> list[torch.device]:
    """The local cards; raises without one (the CPU is asked for by name)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass devices=['cpu', ...] for a "
                           "mesh of CPU replicas")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _default_devices() -> list:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return local_devices()


_GROUPS: dict = {}


def _group(ranks: tuple[int, ...]):
    """The process group of `ranks` (the default group when they are all of
    it). Every rank makes the same calls in the same order, as new_group
    requires; groups are kept per default group and reused."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if len(ranks) == dist.get_world_size():
        return world
    key = (id(world), ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


def make_mesh(data: int = -1, model: int = 1, devices: Sequence | None = None) -> Mesh:
    """A (data, model) mesh over `devices`: ranks (ints) of the process group,
    or torch devices (or their names). Without devices: every rank of the
    process group when there is one, else every local card. data=-1 means
    all remaining devices after the model axis."""
    devices = list(devices if devices is not None else _default_devices())
    n = len(devices)
    if model < 1:
        raise ValueError("model axis must be >= 1")
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if all(isinstance(d, (int, np.integer)) for d in devices):
        grid = np.empty((data, model), object)
        grid[:] = np.asarray([int(d) for d in devices[: data * model]]).reshape(data, model)
        return _rank_mesh(grid)
    grid = np.empty((data, model), object)
    flat = [torch.device(d) for d in devices[: data * model]]
    for i, d in enumerate(flat):
        grid[i // model, i % model] = d
    return Mesh(grid)


def _rank_mesh(grid: np.ndarray) -> Mesh:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh of ranks needs an initialised process group "
                           "(parallel.multihost.initialize)")
    me = dist.get_rank()
    data_group = model_group = None
    for j in range(grid.shape[1]):                       # data-axis groups, one a model index
        g = _group(tuple(int(r) for r in grid[:, j]))
        if me in grid[:, j]:
            data_group = g
    for i in range(grid.shape[0]):                       # model-axis groups, one a data index
        g = _group(tuple(int(r) for r in grid[i, :]))
        if me in grid[i, :]:
            model_group = g
    return Mesh(grid, data_group, model_group)


def fitting_mesh(batch_size: int, model: int = 1, devices: Sequence | None = None) -> Mesh:
    """Mesh whose data axis is the largest divisor of batch_size that fits the
    available devices (so batch sharding is always valid)."""
    devices = list(devices if devices is not None else _default_devices())
    data = fitting_data(batch_size, len(devices) // model)
    return make_mesh(data=data, model=model, devices=devices[: data * model])


def fitting_data(batch_size: int, n: int) -> int:
    """The largest divisor of batch_size that is at most n."""
    for d in range(min(batch_size, n), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


class NamedSharding(NamedTuple):
    """Where a tensor lives on a mesh: `spec` names the mesh axis each
    dimension is split over (jax.sharding.NamedSharding)."""
    mesh: Mesh
    spec: P


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dimension over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, tree, axis: int = 0, index: int | None = None):
    """The rows of data index `index` (default: the calling rank's) of every
    leaf of `tree` (a dict of numpy arrays, tensors or lists) along `axis`:
    the contiguous block [index * b / n, (index + 1) * b / n), where
    batch_sharding puts it. Raises when the batch does not divide the data
    axis."""
    n = mesh.shape[DATA_AXIS]
    if index is None:
        index = mesh.data_index if mesh.distributed else 0

    def rows(x):
        b = len(x) if isinstance(x, list) else x.shape[axis]
        if b % n:
            raise ValueError(f"batch of {b} rows does not divide the data axis of {n}")
        lo, hi = index * (b // n), (index + 1) * (b // n)
        if isinstance(x, list):
            return x[lo:hi]
        return x[(slice(None),) * axis + (slice(lo, hi),)]

    return _map(rows, tree)


_ACTIVE_MESH: list[Mesh] = []


@contextmanager
def use_mesh(mesh: Mesh):
    """Make `mesh` the active one inside the block: the training-mode
    BatchNorm layers take their statistics over its data axis."""
    _ACTIVE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def pad_batch_to_multiple(tree, multiple: int):
    """Pad every leaf's leading dim up to a multiple (for even data sharding).

    Returns (padded_tree, real_batch). Padded rows replicate row 0 so padded
    work is numerically benign; callers mask out results beyond real_batch.
    Leaves are numpy arrays or tensors."""
    leaves = []
    _map(leaves.append, tree)
    if not leaves:
        return tree, 0
    batch = leaves[0].shape[0]
    target = ((batch + multiple - 1) // multiple) * multiple
    if target == batch:
        return tree, batch

    def pad(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[:1].expand(target - batch, *x.shape[1:])])
        return np.concatenate([x, np.repeat(x[:1], target - batch, axis=0)], axis=0)

    return _map(pad, tree), batch
