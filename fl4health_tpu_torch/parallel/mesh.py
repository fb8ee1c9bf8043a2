"""Device meshes on ``torch.distributed`` (counterpart of
``fl4health_tpu/parallel/mesh.py``).

JAX's mesh is one controller's view of many devices; the port's is one
process per device, every process holding the same :class:`Mesh`. With an
initialised process group a mesh reads the world as a
``torch.distributed.device_mesh.DeviceMesh`` over ranks ``0 .. n - 1``
laid out row-major, as ``mesh_utils.create_device_mesh`` lays out JAX's
devices, so rank ``r`` holds the block of the ``[C, ...]`` client axis
that JAX's ``P("clients")`` gives device ``r``. Without a process group a
mesh is a world of one: every axis has size 1 and its collectives are
identities. Meshes are built once per (shape, axis names) and reused, since
building one is a collective over the world.

Axis conventions, as in JAX: ``"clients"`` federated data parallelism,
``"data"`` within-client batch parallelism, ``"model"`` tensor
parallelism, ``"seq"`` the sequence axis of ring attention.

``PartitionSpec`` and ``NamedSharding`` mirror JAX's: a spec names, per
dimension, the mesh axis that dimension is split over (None: whole); a rank
holds, of each dimension named, its coordinate's block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.types import PyTree
from fl4health_tpu_torch.parallel.compat import Axis, gather_from_blocks


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: a tuple of per-dimension axis names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """JAX's ``NamedSharding``: a spec on a mesh."""

    mesh: "Mesh"
    spec: PartitionSpec


class Mesh:
    """A named mesh of ``math.prod(shape)`` ranks, this process one of them."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 device_mesh: Any = None, device_kind: str = "cpu"):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_mesh = device_mesh
        self.device_kind = device_kind
        self.devices = np.arange(math.prod(shape)).reshape(shape)
        coord = (device_mesh.get_coordinate() if device_mesh is not None
                 else [0] * len(shape))
        self._axes = {}
        for i, name in enumerate(self.axis_names):
            if device_mesh is None:
                self._axes[name] = Axis(name)
                continue
            group = device_mesh.get_group(name)
            self._axes[name] = Axis(name, self.shape[name], int(coord[i]),
                                    tuple(dist.get_process_group_ranks(group)), group)

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise ValueError(f"mesh has no axis {name!r} (axes {self.axis_names})")
        return self._axes[name]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def barrier(self) -> None:
        """All ranks of the world reach this point (nothing without a group)."""
        if self.device_mesh is not None:
            dist.barrier()

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (a small picklable value) on every rank of the
        world; ``obj`` itself without a group."""
        if self.device_mesh is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    @property
    def is_leader(self) -> bool:
        """Rank 0 of the world: the one that publishes effects leaving the
        program (frames, reports, exports)."""
        return not dist.is_initialized() or dist.get_rank() == 0

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


_MESHES: dict[tuple, Mesh] = {}


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """The mesh of ``shape`` over ranks ``0 .. prod(shape) - 1``, row-major.
    Every rank of the world calls it alike."""
    shape = tuple(int(s) for s in shape)
    key = (shape, tuple(axis_names), dist.is_initialized() and id(dist.group.WORLD))
    if key in _MESHES:
        return _MESHES[key]
    needed, visible = math.prod(shape), world_size()
    if needed > visible:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {needed} "
                         f"devices but only {visible} are visible")
    if not dist.is_initialized():
        mesh = Mesh(shape, axis_names)
    else:
        from torch.distributed.device_mesh import DeviceMesh

        backend = dist.get_backend()
        device_type = "cuda" if backend == "nccl" else "cpu"
        if needed < visible:
            # one process per device: a rank outside the mesh would have no
            # block of any axis (raised on every rank alike)
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} covers {needed} "
                             f"of the world's {visible} ranks: launch {needed} ranks")
        dm = DeviceMesh(device_type, torch.arange(needed).reshape(shape),
                        mesh_dim_names=tuple(axis_names))
        kind = (torch.cuda.get_device_name(torch.cuda.current_device())
                if device_type == "cuda" else "cpu")
        mesh = Mesh(shape, axis_names, dm, kind)
    _MESHES[key] = mesh
    return mesh


def client_mesh(n_clients_axis: int | None = None) -> Mesh:
    """1-D mesh over all (or ``n``) ranks, axis name ``"clients"``."""
    return make_mesh((n_clients_axis or world_size(),), ("clients",))


def hybrid_mesh(n_clients_axis: int, n_model_axis: int = 1) -> Mesh:
    """2-D ``(clients, model)`` mesh: client data parallelism outside,
    tensor parallelism within each client slice."""
    return make_mesh((n_clients_axis, n_model_axis), ("clients", "model"))


def client_data_mesh(n_clients_axis: int, n_data_axis: int = 1) -> Mesh:
    """2-D ``(clients, data)`` mesh: client data parallelism outside,
    within-client batch parallelism inside."""
    return make_mesh((n_clients_axis, n_data_axis), ("clients", "data"))


def _blocked(x, spec: PartitionSpec | None, mesh: Mesh):
    """This rank's block of ``x`` by ``spec`` (None: all of it)."""
    for dim, name in enumerate(spec or ()):
        if name is None:
            continue
        axis = mesh.axis(name)
        n = x.shape[dim]
        if n % axis.size:
            raise ValueError(f"dimension {dim} of size {n} does not divide over "
                             f"mesh axis {name!r} ({axis.size} ranks)")
        b = n // axis.size
        x = x[(slice(None),) * dim + (slice(axis.index * b, (axis.index + 1) * b),)]
    return x


def _gathered(x: torch.Tensor, spec: PartitionSpec | None, mesh: Mesh) -> torch.Tensor:
    """The global ``x`` from every rank's block by ``spec``."""
    for dim, name in enumerate(spec or ()):
        if name is not None:
            x = gather_from_blocks(x, mesh.axis(name), dim)
    return x


def shard_over_clients(tree: PyTree, mesh: Mesh) -> PyTree:
    """This rank's block of a client-stacked tree's leading axis (the
    ``"clients"`` split)."""
    return ptu.tree_map(lambda x: _blocked(x, P("clients"), mesh), tree)


def replicate(tree: PyTree, mesh: Mesh) -> PyTree:
    """Server-side state: every rank keeps all of it."""
    del mesh
    return tree


def client_axis_size(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in ("clients",) if a in mesh.shape]))


def mesh_descriptor(mesh: Mesh | None) -> dict | None:
    """JSON-able description of a mesh: axis names and sizes and the device
    kinds backing it (JAX's keys; the kind is the card's name, or ``cpu``)."""
    if mesh is None:
        return None
    return {
        "axes": {name: int(size) for name, size in mesh.shape.items()},
        "n_devices": int(mesh.size),
        "device_kinds": [mesh.device_kind],
    }
