"""The group mesh: ordering groups spread over ``torch.distributed`` ranks.

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
touches no CUDA device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


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

