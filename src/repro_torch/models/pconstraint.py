"""Activation layout constraints. Counterpart of
``repro.models.pconstraint``.

The reference pins the batch dim of the residual stream and of q/k/v to
the FSDP axes, and the expert dim of the MoE's dispatch buffers to
"model", so that XLA keeps data parallelism where the kv-head count does
not divide the "model" axis. Here the same rules give a spec per call
(:func:`batch_spec`, :func:`expert_spec`, :func:`weight_spec`); with a
mesh that has ranks, a DTensor input is redistributed to that spec's
placements (``launch.sharding.Sharding.placements``). A plain tensor is
returned as it is: nothing in the port lays activations out by itself.

Without a mesh (:func:`set_mesh` not called, or called with None) every
function returns its input object itself and adds no device op, so the
captured decode graphs and the card's launch counts do not move. The
reference's launcher sets the mesh while it traces a cell's step; the
port's dry run runs no step (``launch.dryrun``).
"""
from __future__ import annotations

from typing import Optional

import torch

_MESH = None            # a launch.mesh.ModelMesh, or None
_BATCH_AXES: tuple = ()


def set_mesh(mesh) -> None:
    global _MESH, _BATCH_AXES
    _MESH = mesh
    if mesh is None:
        _BATCH_AXES = ()
    else:
        _BATCH_AXES = tuple(a for a in ("pod", "data")
                            if a in mesh.axis_names)


def _axes_size(axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= _MESH.shape[a]
    return n


def batch_spec(shape: tuple, batch_dim: int = 0,
               model_dim: int | None = None) -> Optional[tuple]:
    """The spec :func:`constrain_batch` pins a tensor of ``shape`` to:
    ``batch_dim`` over the FSDP axes (and ``model_dim`` over "model")
    where divisible; None where it pins nothing (no mesh, a 0-d tensor,
    or no dim divisible)."""
    if _MESH is None or len(shape) == 0:
        return None
    parts: list = [None] * len(shape)
    n = _axes_size(_BATCH_AXES)
    if shape[batch_dim] % n == 0 and shape[batch_dim] >= n:
        parts[batch_dim] = _BATCH_AXES if len(_BATCH_AXES) > 1 \
            else _BATCH_AXES[0]
    if model_dim is not None and \
            shape[model_dim] % _MESH.shape["model"] == 0:
        parts[model_dim] = "model"
    if all(p is None for p in parts):
        return None
    return tuple(parts)


def expert_spec(shape: tuple, expert_dim: int = 0) -> Optional[tuple]:
    """The spec :func:`constrain_expert` pins an MoE dispatch buffer of
    ``shape`` to: the expert dim over "model" (EP), or None."""
    if _MESH is None or shape[expert_dim] % _MESH.shape["model"] != 0:
        return None
    parts: list = [None] * len(shape)
    parts[expert_dim] = "model"
    return tuple(parts)


# The reference measured forcing the weights' use-site gather (ZeRO-3
# style) on its dry run and disabled it: XLA then rematerialised the
# gathered weights in the backward. Kept behind the same flag, off.
FORCE_WEIGHT_GATHER = False


def weight_spec(shape: tuple, model_dims: tuple = ()) -> Optional[tuple]:
    """The spec :func:`weight_compute_layout` pins a weight to: "model" on
    ``model_dims`` where divisible, replicated elsewhere; None without a
    mesh or with ``FORCE_WEIGHT_GATHER`` off."""
    if _MESH is None or not FORCE_WEIGHT_GATHER:
        return None
    parts: list = [None] * len(shape)
    for d in model_dims:
        if shape[d] % _MESH.shape["model"] == 0:
            parts[d] = "model"
    return tuple(parts)


def _apply(x: torch.Tensor, spec: Optional[tuple]):
    if spec is None or _MESH.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from ..launch.sharding import Sharding
    return x.redistribute(_MESH.device_mesh,
                          Sharding(_MESH, spec).placements())


def constrain_batch(x: torch.Tensor, batch_dim: int = 0,
                    model_dim: int | None = None):
    """Pin ``batch_dim`` to the FSDP axes (and optionally ``model_dim`` to
    "model") where divisible; the input itself outside a mesh."""
    if _MESH is None:
        return x
    return _apply(x, batch_spec(tuple(x.shape), batch_dim, model_dim))


def constrain_expert(x: torch.Tensor, expert_dim: int = 0):
    """Pin the expert dim of MoE dispatch buffers to "model" (EP)."""
    if _MESH is None:
        return x
    return _apply(x, expert_spec(tuple(x.shape), expert_dim))


def weight_compute_layout(w: torch.Tensor, model_dims: tuple = ()):
    """Constrain a weight to its compute layout ("model" on
    ``model_dims``, replicated elsewhere) when ``FORCE_WEIGHT_GATHER``
    is on."""
    if _MESH is None or not FORCE_WEIGHT_GATHER:
        return w
    return _apply(w, weight_spec(tuple(w.shape), model_dims))
