"""The meshes of the port: the model mesh of the layout rules and the
dry run, and the group mesh of the meshed engine.

The model mesh (:class:`ModelMesh`) names its axes ("pod", "data",
"model") and their sizes, as the reference's ``jax`` meshes do.
:func:`make_production_mesh` gives the reference's single-pod 16 × 16
and two-pod 2 × 16 × 16 meshes, :func:`make_host_mesh` the host mesh of
the training launcher. Where the default process group has exactly as
many ranks as the mesh, the mesh holds a ``torch.distributed``
``DeviceMesh`` over them (rank r at the r-th place in row-major order),
and tensors can be placed on it (``launch.sharding.place``); otherwise it
is abstract, the counterpart of the dry run's placeholder devices: the
layout rules and the per-device bytes still hold, nothing is placed.

The group mesh: ordering groups spread over ``torch.distributed`` ranks.

The engine's G ordering groups are independent within a tick; only the
round-robin merge crosses them. So they shard along one axis of ranks,
one process per rank: rank r holds the padded group rows
``[r·rows, (r+1)·rows)`` and launches its own kernels over them
(``engine.meshed``).

A rank is a process in an initialised default process group: NCCL with
rank r on ``cuda:r`` on a host with one card per rank, gloo on the CPU or
with several ranks on one card. With no process group at all, the world
is one rank and every collective here is the identity, as the
reference's one-device mesh is.

Functions only: importing this module creates no process group and
touches no CUDA device, and no function here starts a process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ModelMesh:
    """A mesh of named axes: ``axis_names`` and their ``sizes``, and the
    ``DeviceMesh`` over the process group's ranks (None: an abstract
    mesh)."""
    axis_names: tuple
    sizes: tuple
    device_mesh: Any = None

    @property
    def shape(self) -> dict:
        """Axis name → size, as a ``jax`` mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices (ranks) in the mesh."""
        n = 1
        for s in self.sizes:
            n *= s
        return n


def _world() -> int:
    """Ranks of the default process group (0: none)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def _model_mesh(sizes: tuple, names: tuple) -> ModelMesh:
    """A mesh over the default process group where it has exactly
    ``prod(sizes)`` ranks (NCCL's on ``cuda``, any other backend's on the
    host), else abstract. Never starts a process group."""
    mesh = ModelMesh(tuple(names), tuple(int(s) for s in sizes))
    if _world() != mesh.size:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(mesh.size).reshape(mesh.sizes)
    return ModelMesh(mesh.axis_names, mesh.sizes,
                     DeviceMesh(kind, grid, mesh_dim_names=mesh.axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> ModelMesh:
    """The reference's production mesh: 16 × 16 on ("data", "model"), or
    2 × 16 × 16 on ("pod", "data", "model") with ``multi_pod``; abstract
    unless the process group has 256 (512) ranks."""
    if multi_pod:
        return _model_mesh((2, 16, 16), ("pod", "data", "model"))
    return _model_mesh((16, 16), ("data", "model"))


def make_host_mesh() -> ModelMesh:
    """(n // 2, 2) on ("data", "model") over a process group of n >= 2
    ranks; (1, 1) with no device mesh in a world of one (no process
    group, or one rank), as :class:`GroupMesh` has it."""
    n = _world()
    if n >= 2:
        return _model_mesh((n // 2, 2), ("data", "model"))
    return ModelMesh(("data", "model"), (1, 1))


def mesh_axes(mesh: ModelMesh) -> dict:
    """Axis name → size."""
    return dict(mesh.shape)


def fsdp_axes(mesh: ModelMesh) -> tuple:
    """Axes used for fully-sharded parameter (and batch) placement."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


@dataclass(frozen=True)
class GroupMesh:
    """A 1-D mesh of ``size`` ranks over a group axis.

    ``rank`` is this process's index in the mesh (``-1``: a process of
    the world that the clamped mesh left out; collectives raise there).
    Each rank holds ``rows`` rows, pad rows included; ``pad`` inert rows
    make ``size`` divide the row axis. ``backend`` is the process group's
    (``"nccl"``, ``"gloo"``), or ``None`` with no process group;
    ``group`` is the process group the collectives run in."""
    size: int
    rank: int
    rows: int
    pad: int
    backend: str | None
    group: Any
    axis_name: str = "group"

    @property
    def first(self) -> int:
        """Index of this rank's first row on the padded row axis."""
        return self.rank * self.rows


def make_group_mesh(n_groups: int, *, n_devices: int | None = None,
                    axis_name: str = "group") -> GroupMesh:
    """1-D mesh for device-sharded group execution.

    The size clamps to the world size and to ``n_groups`` (a rank holding
    zero group rows would only idle in every collective); when it does
    not divide ``n_groups``, the group axis is padded with inert rows
    (:func:`group_padding`) so every rank carries the same number. When
    the clamped size is smaller than the world, the mesh is a subgroup
    of ranks ``0 .. size-1``, made by ``dist.new_group``: every rank of
    the world must call this function, the ranks left out too."""
    if n_groups < 1:
        raise ValueError(f"make_group_mesh needs n_groups >= 1, got "
                         f"{n_groups}")
    if not (dist.is_available() and dist.is_initialized()):
        return GroupMesh(size=1, rank=0, rows=int(n_groups), pad=0,
                         backend=None,
                         group=None, axis_name=axis_name)
    world = dist.get_world_size()
    n = world if n_devices is None else min(int(n_devices), world)
    n = max(1, min(n, int(n_groups)))
    if n < world:
        group = dist.new_group(ranks=list(range(n)))
        rank = dist.get_rank() if dist.get_rank() < n else -1
    else:
        group = dist.group.WORLD
        rank = dist.get_rank()
    pad = (-int(n_groups)) % n
    return GroupMesh(size=n, rank=rank, rows=(int(n_groups) + pad) // n,
                     pad=pad,
                     backend=dist.get_backend(dist.group.WORLD),
                     group=group, axis_name=axis_name)


def group_padding(n_groups: int, mesh: GroupMesh) -> int:
    """Inert rows to append so the group axis divides the mesh size.

    Pad rows are fresh (nothing admitted, zero traffic): they assign
    nothing, recycle nothing, and the meshed engine drops them before
    the merge, so padding never changes the merged output by a bit."""
    return (-int(n_groups)) % mesh.size


def _member(mesh: GroupMesh) -> None:
    if mesh.rank < 0:
        raise RuntimeError(
            f"rank {dist.get_rank()} is outside this {mesh.size}-rank "
            "group mesh: only ranks 0 .. size-1 run its collectives")


def all_gather_rows(x: torch.Tensor, mesh: GroupMesh) -> torch.Tensor:
    """Concatenate every rank's ``x`` (the same shape on each) along the
    leading axis, in rank order: ``[size·n, ...]`` on every rank.

    The rule is the backend's. NCCL gathers the device tensors in place,
    with no host sync. Gloo gathers host tensors: ``x`` is copied to the
    host, gathered there and copied back to its device, which syncs the
    host with the device once per call. With no process group (a world
    of one) ``x`` is returned as it is; with one, the collective runs at
    any size, one rank included."""
    _member(mesh)
    if mesh.backend is None:
        return x
    staged = x.cpu() if mesh.backend == "gloo" else x
    src = staged.contiguous()
    out = src.new_empty((mesh.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather(list(out.chunk(mesh.size)), src, group=mesh.group)
    return out.to(x.device) if mesh.backend == "gloo" else out

