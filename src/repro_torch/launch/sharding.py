"""Logical-axis → mesh-axis layout rules. Counterpart of
``repro.launch.sharding``.

Parallelism dimensions on the (pod, data, model) mesh, as in the
reference:
  * FSDP / ZeRO-3 — parameter "embed"-family axes sharded over
    ("pod", "data");
  * TP — "heads"/"mlp"/"vocab" axes over "model";
  * EP — "expert" axis over "model";
  * DP — batch dim of activations over ("pod", "data");
  * SP — long-context decode shards the KV-cache sequence dim over "data"
    when the batch dim is too small to use it (long_500k, batch = 1).

Every rule is checked for divisibility against the dim's size; on
failure it falls back to the longest divisible prefix of the rule, then
to replication.

A spec is a tuple with one entry per dim: None (replicated), a mesh axis
name, or a tuple of names (the dim split over those axes, the first
major), equal to ``tuple()`` of the reference's ``PartitionSpec``.
:class:`Sharding` is the counterpart of ``NamedSharding``: the mesh and
the spec, with the shard's shape and bytes and the DTensor placements
(``Shard(d)`` on each mesh axis that splits dim d, ``Replicate()`` on
the others). :func:`place` is the counterpart of ``jax.device_put`` with
a ``NamedSharding``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..models.common import is_axes
from .mesh import ModelMesh

# logical axis → preferred mesh axes (in priority order of fallbacks)
RULES: dict[str, tuple] = {
    "embed": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "mlp": (("model",),),
    "moe_mlp": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "expert": (("model",),),
    "q_lora": (("pod", "data"), ("data",)),
    "kv_lora": (),
    "layers": (),
    "batch": (("pod", "data"), ("data",)),
    "seq": (("data",),),
}


def _axis_size(mesh: ModelMesh, names: tuple) -> int:
    s = 1
    for n in names:
        s *= mesh.shape[n]
    return s


def _pick(mesh: ModelMesh, logical: str, dim: int, used: set):
    for cand in RULES.get(logical, ()):  # try each rule variant
        cand = tuple(a for a in cand if a in mesh.axis_names)
        # longest divisible prefix not colliding with already-used axes
        for end in range(len(cand), 0, -1):
            pre = cand[:end]
            if any(a in used for a in pre):
                continue
            if dim % _axis_size(mesh, pre) == 0:
                return pre
    return None


def spec_for(mesh: ModelMesh, shape: tuple, axes: tuple) -> tuple:
    """The spec of one leaf given its logical axes."""
    if len(shape) != len(axes):
        raise ValueError(f"logical axes {axes} for a leaf of shape {shape}")
    used: set = set()
    parts = []
    for dim, logical in zip(shape, axes):
        got = None if logical is None else _pick(mesh, logical, dim, used)
        if got is None:
            parts.append(None)
        else:
            used.update(got)
            parts.append(got if len(got) > 1 else got[0])
    return tuple(parts)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class Sharding:
    """A layout: ``spec`` (one entry per dim) on ``mesh``."""
    mesh: ModelMesh
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape each device holds: dim d over the product of the
        sizes of the mesh axes that split it."""
        if len(shape) != len(self.spec):
            raise ValueError(f"spec {self.spec} for shape {tuple(shape)}")
        out = []
        for dim, entry in zip(shape, self.spec):
            n = _axis_size(self.mesh, _names(entry))
            if dim % n:
                raise ValueError(f"dim {dim} does not divide over {entry}")
            out.append(dim // n)
        return tuple(out)

    def shard_bytes(self, tensor: torch.Tensor) -> int:
        """Bytes of one device's shard of ``tensor`` (meta tensors too)."""
        n = 1
        for d in self.shard_shape(tuple(tensor.shape)):
            n *= d
        return n * tensor.element_size()

    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(d)`` where the
        axis splits dim d, else ``Replicate()``. A dim split over several
        axes is split over them in mesh order (the first major), which is
        the order of a spec entry such as ("pod", "data")."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate()] * len(self.mesh.axis_names)
        for d, entry in enumerate(self.spec):
            names = _names(entry)
            idx = [self.mesh.axis_names.index(a) for a in names]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {self.mesh.axis_names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


def tree_map(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a tree and its axes tree, in the tree's
    layout: mappings (dicts, ``ParamTree``, ``LM``, ``nn.ModuleDict``) as
    dicts, per-layer lists (lists, ``nn.ModuleList``) as lists, a tensor
    paired with its axes tuple."""
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        if len(tree) != len(axes_tree):
            raise ValueError(f"{len(tree)} layers for {len(axes_tree)} axes")
        return [tree_map(fn, t, a) for t, a in zip(tree, axes_tree)]
    if hasattr(tree, "keys"):
        if set(tree.keys()) != set(axes_tree.keys()):
            raise ValueError(f"keys {sorted(tree.keys())} against axes "
                             f"{sorted(axes_tree.keys())}")
        return {k: tree_map(fn, tree[k], axes_tree[k]) for k in tree.keys()}
    if not is_axes(axes_tree):
        raise ValueError(f"no logical axes for a leaf: {axes_tree!r}")
    return fn(tree, axes_tree)


def tree_shardings(mesh: ModelMesh, params, axes_tree):
    """A :class:`Sharding` per leaf of a (tree, logical axes tree) pair,
    in the tree's layout (:func:`tree_map`)."""
    return tree_map(lambda leaf, axes: Sharding(
        mesh, spec_for(mesh, tuple(leaf.shape), axes)), params, axes_tree)


def leaves(tree) -> list:
    """The leaves of a layout tree (dicts, lists, modules) in its
    order."""
    if isinstance(tree, (list, tuple, nn.ModuleList)) and not is_axes(tree):
        return [x for t in tree for x in leaves(t)]
    if hasattr(tree, "keys"):
        return [x for k in tree.keys() for x in leaves(tree[k])]
    return [tree]


def sharded_bytes(tree, shardings) -> int:
    """Σ over the leaves of ``tree`` of one device's shard bytes under the
    matching :class:`Sharding` of ``shardings`` (the same layout)."""
    ts, ss = leaves(tree), leaves(shardings)
    if len(ts) != len(ss):
        raise ValueError(f"{len(ts)} leaves for {len(ss)} shardings")
    return sum(s.shard_bytes(t) for t, s in zip(ts, ss))


def batch_pspec(mesh: ModelMesh, shape: tuple, batch_dim: int = 0,
                seq_dim: int | None = None) -> tuple:
    """Shard the batch dim over ("pod", "data"); if the batch dim is not
    divisible (e.g. long_500k batch = 1), shard the sequence dim over
    "data" instead (SP)."""
    parts: list = [None] * len(shape)
    fsdp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    got = None
    for end in range(len(fsdp), 0, -1):
        if shape[batch_dim] % _axis_size(mesh, fsdp[:end]) == 0:
            got = fsdp[:end]
            break
    if got is not None:
        parts[batch_dim] = got if len(got) > 1 else got[0]
    elif seq_dim is not None and shape[seq_dim] % mesh.shape["data"] == 0:
        parts[seq_dim] = "data"
    return tuple(parts)


def _cache_spec(mesh: ModelMesh, shape: tuple) -> tuple:
    ndim = len(shape)
    # stacked-layer leading dim: cache specs are built per segment;
    # stacked leaves have ndim >= 4 (layers first)
    off = 1 if ndim >= 4 else 0
    bdim = off
    sdim = off + 1 if ndim - off >= 3 else None
    parts: list = [None] * ndim
    fsdp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    got = None
    for end in range(len(fsdp), 0, -1):
        if shape[bdim] % _axis_size(mesh, fsdp[:end]) == 0:
            got = fsdp[:end]
            break
    if got is not None and shape[bdim] > 1:
        parts[bdim] = got if len(got) > 1 else got[0]
    elif sdim is not None and shape[sdim] % mesh.shape["data"] == 0 \
            and shape[sdim] > 1:
        parts[sdim] = "data"      # SP on the kv sequence
    # last dim: flattened kv/heads features → model axis
    if shape[-1] % mesh.shape["model"] == 0 and ndim - off >= 3:
        parts[-1] = "model"
    return tuple(parts)


def cache_shardings(mesh: ModelMesh, cache_spec_tree):
    """Shardings for a decode cache spec tree (``models.decode.cache_spec``:
    nested dicts of (shape, dtype) leaves). A leaf is [layers,] B, S|W,
    flattened kv: the kv dim shards over "model", the batch over ("pod",
    "data"), with SP on the sequence dim where the batch is 1."""
    if isinstance(cache_spec_tree, tuple):
        return Sharding(mesh, _cache_spec(mesh, tuple(cache_spec_tree[0])))
    return {k: cache_shardings(mesh, v) for k, v in cache_spec_tree.items()}


def place(tensor: torch.Tensor, sharding: Sharding):
    """``tensor`` laid out by ``sharding``: a DTensor over the mesh's
    ranks (``distribute_tensor``: each rank keeps its block of the
    tensor it passes, which must be the same on every rank), or the
    tensor itself where the mesh is abstract (a world of one)."""
    mesh = sharding.mesh.device_mesh
    if mesh is None:
        return tensor
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor.detach(), mesh, sharding.placements())
