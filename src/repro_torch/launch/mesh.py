"""Meshes over ``torch.distributed`` ranks.

Port of ``repro.launch.mesh``.  The reference lays one global program
over a ``jax.sharding.Mesh`` of devices and lets GSPMD insert the
collectives; the port runs one process per rank (explicit SPMD), and a
``Mesh`` here is the ranks of the default process group laid out on a
``torch.distributed.device_mesh.DeviceMesh``, row-major:

  Single pod:  (16, 16)    axes ("data", "model")        — 256 ranks
  Multi-pod:   (2, 16, 16) axes ("pod", "data", "model") — 512 ranks
  Debug:       (data, model) over however many ranks the run has

"pod" is a second data-parallel axis: the gradient batch is split over
pod x data, and the few collectives of an update run over the
data-parallel group — the ranks that share this rank's "model"
coordinate.  Ranks along "model" hold the same batch rows and never join
each other's data-group sums.

The process group's backend follows the device: NCCL for ``"cuda"``,
gloo for ``"cpu"`` (``backend=`` names another, e.g. gloo over CUDA
tensors, two ranks on one card).  There is no fallback: a mesh of N
ranks in a world of another size raises, and a ``"cuda"`` mesh without
a card raises (``device.resolve_device``).

    mesh = make_debug_mesh(4, 2, device="cpu")   # under torchrun, 8 ranks
    mesh.data_extent, mesh.data_index, mesh.data_group
    mesh.group(("data", "model"))                # a 2d leaf's ranks
"""
from __future__ import annotations

import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.device import DEFAULT_DEVICE, resolve_device

DATA_AXES = ("pod", "data")
TIMEOUT = timedelta(minutes=10)


def default_backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_distributed(device=DEFAULT_DEVICE, backend=None) -> None:
    """Start the default process group unless one is running.

    Under torchrun (``WORLD_SIZE`` in the environment) it starts from the
    launcher's ``env://`` rendezvous; a run without a launcher is world
    size 1 and starts from an in-process store (no port, no file).  On a
    card the process's device is ``LOCAL_RANK`` (or rank modulo the
    card count) before the group starts, as NCCL needs."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)


class Mesh:
    """A ``DeviceMesh`` over every rank of the default process group,
    with what the port's explicit SPMD reads off it.

    ``axis_names`` and ``shape`` ({axis: extent}) are what the sharding
    rules read (``launch.sharding``), as of a ``jax.sharding.Mesh``.
    ``data_group`` is the process group of the ranks that share this
    rank's "model" coordinate, ``data_extent`` its size (pod x data) and
    ``data_index`` this rank's place in it (row-major over pod, data):
    the batch split and every gradient and curvature sum use these."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        grid = device_mesh.mesh
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.rank = dist.get_rank()
        self._groups: dict = {}
        self.data_group = self._new_groups(
            [i for i, a in enumerate(self.axis_names) if a in DATA_AXES])
        self.data_ranks = dist.get_process_group_ranks(self.data_group)
        self.data_extent = len(self.data_ranks)
        self.data_index = self.data_ranks.index(self.rank)

    def extent(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple of
        names, as a spec entry)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes):
        """The process group over which a leaf split along ``axes`` (a
        name, a spec entry, or every axis a spec splits over) is spread:
        the ranks that share this rank's coordinates on the other axes.
        A leaf split over "data" and "model" is spread over the world of
        a (data, model) mesh; a reduction over such a leaf sums over the
        group.  A group of several axes orders its ranks row-major over
        them, as ``launch.sharding.NamedSharding.place`` cuts."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = frozenset(axes)
        if not key <= set(self.axis_names):
            raise ValueError(f"axes {axes} are not all on the mesh "
                             f"{self.axis_names}")
        if key == set(self.axis_names):
            return dist.group.WORLD
        if key == set(a for a in DATA_AXES if a in self.axis_names):
            return self.data_group
        if len(key) == 1:
            return self.device_mesh.get_group(axes[0])
        if key not in self._groups:
            self._groups[key] = self._new_groups(
                [i for i, a in enumerate(self.axis_names) if a in key])
        return self._groups[key]

    def _new_groups(self, dims: list):
        """This rank's group among the groups over the grid's ``dims``:
        one row a group, rows over the other coordinates, columns over
        ``dims`` row-major.  Every rank creates every group, in one
        order."""
        grid = self.device_mesh.mesh
        other = [i for i in range(grid.dim()) if i not in dims]
        rows = grid.permute(*other, *dims).reshape(
            -1, math.prod(grid.shape[i] for i in dims))
        mine = None
        for row in rows.tolist():
            group = dist.new_group(row, timeout=TIMEOUT)
            if self.rank in row:
                mine = group
        return mine

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}, data "
                f"{self.data_index}/{self.data_extent}, {self.device})")


def _mesh(shape, axes, device, backend) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the run "
            f"has {world}: launch it under torchrun --nproc-per-node {n} "
            f"(or one process a rank with WORLD_SIZE={n})")
    init_distributed(dev, backend)
    return Mesh(init_device_mesh(dev.type, tuple(shape),
                                 mesh_dim_names=tuple(axes)), dev)


def make_production_mesh(*, multi_pod: bool = False, device=DEFAULT_DEVICE,
                         backend=None) -> Mesh:
    """The production layout: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``; the run must have 256
    or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device, backend)


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device=DEFAULT_DEVICE, backend=None) -> Mesh:
    """A (data, model) mesh over a run of data x model ranks."""
    return _mesh((data, model), ("data", "model"), device, backend)
