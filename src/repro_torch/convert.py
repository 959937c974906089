"""Carry engine state, packed tiles and model weights between numpy and
the port.

A state crosses as nested numpy arrays under the reference's field names:
the reference's ``EngineState`` or any of its family states (QuorumState,
RecycleState, GatedRecycleState, DissemState, MergeState), as NamedTuples
with array leaves or as nested dicts. Bitset fields (``ack_bits``,
``vote_bits``, ``hold_bits``) cross as a ``uint32`` ↔ ``int32`` view with
the same bits; every other field keeps its dtype (int32 or bool). An
adaptive ``TrafficQueue`` crosses the same way (:func:`queue_from_numpy`,
:func:`queue_to_numpy`), its tile rings as bitsets. A meshed
``EngineState`` (``EngineConfig.mesh``) crosses as the logical state:
gathered from every rank on the way out, each rank's rows taken on the
way in (``engine.meshed.gather_state`` / ``shard_state``).

Model weights cross in the layout of the reference's ``init_lm``: nested
dicts whose segment leaves are stacked along a leading layer axis
(:func:`lm_params_from_jax`, :func:`lm_params_to_numpy`). A train state
(``{"params", "opt", "step"}`` of ``train.trainer.make_state``) crosses
the same way (:func:`train_state_from_jax`, :func:`train_state_to_numpy`):
the optimizer state keeps the reference's stacked layout in the port too.
bf16 arrays cross by their 2-byte pattern: a JAX bf16 array
(``ml_dtypes.bfloat16``) or numpy void ``|V2`` (what ``np.savez`` stores)
on the way in, ``|V2`` on the way out with ``native=True``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.tilesim import QuorumState
from .dissem.engine import DissemState
from .engine.adaptive import TrafficQueue, init_queue
from .engine import meshed
from .engine.api import EngineConfig, EngineState, create_state
from .engine.merge import MergeState
from .engine.sharded import GatedRecycleState, RecycleState
from .models.common import ModelConfig
from .models.transformer import LM, init_lm

BITSET_FIELDS = frozenset({"ack_bits", "vote_bits", "hold_bits"})
QUEUE_RINGS = ("acks", "votes", "holds")
# most specific first: each class is recognized by its field names
_STATE_TYPES = (EngineState, GatedRecycleState, RecycleState, QuorumState,
                DissemState, MergeState)


def bits_from_numpy(a, device) -> torch.Tensor:
    """uint32 (or int32) bitset array → int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"bitsets must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def bits_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bitset tensor → uint32 array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def _get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _has(tree, name) -> bool:
    return name in tree if isinstance(tree, dict) else hasattr(tree, name)


def _is_node(x) -> bool:
    return isinstance(x, (tuple, dict))


def _leaf_from_numpy(name: str, a, device) -> torch.Tensor:
    if name in BITSET_FIELDS:
        return bits_from_numpy(a, device)
    a = np.asarray(a)
    if a.dtype not in (np.bool_, np.int32):
        raise TypeError(f"field {name!r} must be bool or int32, got "
                        f"{a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def _from_tree(tree, device):
    for cls in _STATE_TYPES:
        if _is_node(tree) and all(_has(tree, f) for f in cls._fields):
            break
    else:
        raise ValueError(f"not a recognized engine state: {type(tree)}")
    fields = []
    for f in cls._fields:
        v = _get(tree, f)
        fields.append(None if v is None else _from_tree(v, device)
                      if _is_node(v) else _leaf_from_numpy(f, v, device))
    return cls(*fields)


def _find(tmpl, cls):
    """First node of type ``cls`` in the template tree (depth first)."""
    if isinstance(tmpl, cls):
        return tmpl
    if isinstance(tmpl, tuple):
        for v in tmpl:
            found = _find(v, cls)
            if found is not None:
                return found
    return None


def _check_like(got, want, path: str) -> None:
    if isinstance(want, tuple):
        if type(got) is not type(want):
            raise ValueError(f"{path}: expected {type(want).__name__}, got "
                             f"{type(got).__name__}")
        for f in want._fields:
            _check_like(getattr(got, f), getattr(want, f), f"{path}.{f}")
    elif want is None or got is None:
        if want is not got:
            raise ValueError(f"{path}: expected {want!r}, got {got!r}")
    elif got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"{path}: expected {want.dtype}{tuple(want.shape)}"
                         f", got {got.dtype}{tuple(got.shape)}")


def engine_state_from_numpy(cfg: EngineConfig, tree, device):
    """Build the port's state from a reference state given as numpy
    arrays under the reference's field names: an ``EngineState`` gives an
    :class:`EngineState`, a family state gives the port's family state.
    Raises ``ValueError`` if its shapes or dtypes do not fit ``cfg``.
    Under ``cfg.mesh`` the tree is the logical state, and an
    ``EngineState`` comes back as this rank's meshed state."""
    state = _from_tree(tree, device)
    logical = cfg if cfg.mesh is None else meshed.unmeshed(cfg)
    tmpl = _find(create_state(logical, "meta"), type(state))
    if tmpl is None:
        raise ValueError(f"{type(state).__name__} is not part of a "
                         f"{cfg.family!r} engine state")
    _check_like(state, tmpl, type(state).__name__)
    if cfg.mesh is not None and isinstance(state, EngineState):
        return meshed.shard_state(cfg, state)
    return state


def engine_state_to_numpy(state, cfg: EngineConfig | None = None):
    """The port's state (an ``EngineState`` or any family state) → nested
    dicts of numpy arrays under the reference's field names, bitsets as
    ``uint32``. A meshed ``EngineState`` needs its ``cfg``: it is
    gathered to the logical state first (a collective: every rank of
    the mesh calls it)."""
    if cfg is not None and cfg.mesh is not None and \
            isinstance(state, EngineState):
        state = meshed.gather_state(cfg, state)
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if v is None or isinstance(v, tuple):
            out[f] = None if v is None else engine_state_to_numpy(v)
        elif f in BITSET_FIELDS:
            out[f] = bits_to_numpy(v)
        else:
            out[f] = v.detach().cpu().numpy()
    return out


def queue_from_numpy(cfg: EngineConfig, tree, device) -> TrafficQueue:
    """Build the port's ``TrafficQueue`` from a reference queue given as
    numpy arrays (a NamedTuple or a dict under the reference's field
    names; rings ``uint32``). Raises ``ValueError`` if its shapes or
    dtypes do not fit ``cfg`` (with ``adaptive`` set) at the ring's own
    capacity. Under ``cfg.mesh`` the tree is the logical queue, and the
    queue of this rank's rows comes back."""
    fields = {}
    for f in TrafficQueue._fields:
        v = _get(tree, f)
        fields[f] = None if v is None else bits_from_numpy(v, device) \
            if f in QUEUE_RINGS else _leaf_from_numpy(f, v, device)
    queue = TrafficQueue(**fields)
    logical = cfg if cfg.mesh is None else meshed.unmeshed(cfg)
    _check_like(queue, init_queue(logical, capacity=queue.acks.shape[1],
                                  device="meta"), "TrafficQueue")
    if cfg.mesh is not None:
        queue = TrafficQueue(*(meshed.local_rows(cfg, v) for v in queue))
    return queue


def queue_to_numpy(queue: TrafficQueue,
                   cfg: EngineConfig | None = None) -> dict:
    """The port's ``TrafficQueue`` → a dict of numpy arrays under the
    reference's field names, rings as ``uint32``. A meshed queue needs
    its ``cfg`` and is gathered to the logical queue first."""
    if cfg is not None and cfg.mesh is not None:
        queue = TrafficQueue(*(None if v is None
                               else meshed.gather_rows(cfg, v)
                               for v in queue))
    return {f: None if v is None else bits_to_numpy(v) if f in QUEUE_RINGS
            else v.detach().cpu().numpy()
            for f, v in queue._asdict().items()}


# -- model weights ------------------------------------------------------------

def tensor_from_numpy(a, dtype: torch.dtype, device, shape=None,
                      name: str = "array") -> torch.Tensor:
    """A numpy (or JAX) array → a tensor of ``dtype`` on ``device``. A
    bf16 array (``ml_dtypes.bfloat16`` or void ``|V2``) is taken by its
    bits; any other goes through f32 (exact for the types here) or, for
    an integer ``dtype``, as it is. Raises if ``shape`` is given and
    differs."""
    a = np.asarray(a)
    if shape is not None and a.shape != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got {a.shape}")
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise TypeError(f"{name}: a {a.dtype} array is not bf16")
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
            .view(torch.bfloat16)
    elif dtype.is_floating_point:
        t = torch.from_numpy(np.array(a, dtype=np.float32))
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def tensor_to_numpy(t: torch.Tensor, native: bool = False) -> np.ndarray:
    """A tensor → numpy: floats as f32, or with ``native`` in their own
    dtype, bf16 as void ``|V2`` (its bits)."""
    t = t.detach().cpu()
    if not native and t.dtype.is_floating_point:
        return t.float().numpy()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def lm_params_from_jax(tree, cfg: ModelConfig, device) -> LM:
    """The reference's ``init_lm`` parameter tree (of any config of its
    registry), as nested dicts of numpy arrays (bf16 arrays too), → the
    port's :class:`LM` on ``device``. Each stacked ``[n, ...]`` leaf of a
    scanned segment, of the encoder's ``blocks`` and of ``cross`` is
    sliced into the per-layer trees (a pair segment's ``{"dense",
    "moe"}`` leaves, expert weights ``[n, E, D, F]``, into one tree per
    pair); an unscanned segment (hymba's global layers), ``meta_tokens``,
    the MTP head's ``mtp`` tree and the encoder's ``ln`` have no layer
    axis and cross as they are; every leaf goes
    through f32 to ``cfg.dtype``, which is exact for bf16. Raises
    ``ValueError`` if a key or shape does not fit ``cfg``."""
    return LM(cfg, _params_like(tree, init_lm(cfg, device="meta").tree(),
                                "", device))


def _params_like(tree, tmpl, path: str, device):
    """``tree`` (numpy, stacked where ``tmpl`` has a list of per-layer
    trees) in the layout of ``tmpl`` (the port's tree on the meta
    device), on ``device``."""
    if isinstance(tmpl, list):
        for leaf in _leaves(tree):
            if np.shape(leaf)[:1] != (len(tmpl),):
                raise ValueError(f"{path}: {len(tmpl)} layers, got a leaf "
                                 f"of shape {np.shape(leaf)}")
        return [_params_like(_layer(tree, i), layer, f"{path}[{i}]", device)
                for i, layer in enumerate(tmpl)]
    if isinstance(tmpl, dict):
        if not isinstance(tree, dict) or tree.keys() != tmpl.keys():
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: keys {got} != "
                             f"{sorted(tmpl)}")
        return {k: _params_like(tree[k], v, f"{path}.{k}" if path else k,
                                device) for k, v in tmpl.items()}
    return tensor_from_numpy(tree, tmpl.dtype, device, tuple(tmpl.shape),
                             path)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _layer(stacked: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in stacked.items()}


def lm_params_to_numpy(lm: LM, native: bool = False) -> dict:
    """The port's :class:`LM` → the reference's parameter layout as numpy
    arrays, the leaves of each list of per-layer trees (a scanned
    segment, the encoder's blocks, ``cross``) stacked along a leading
    layer axis: f32, or with ``native`` each leaf in its own dtype (bf16
    as ``|V2``)."""
    def arrays(tree):
        if isinstance(tree, list):
            return stack([arrays(layer) for layer in tree])
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        return tensor_to_numpy(tree, native)

    def stack(trees: list) -> dict:
        return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k],
                                                              dict)
                else np.stack([t[k] for t in trees]) for k in trees[0]}
    return arrays(lm.tree())


# -- train state --------------------------------------------------------------

def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def train_state_from_jax(tree, cfg: ModelConfig, device) -> dict:
    """The reference's train state (``make_state``'s first result: params,
    opt and step, as nested numpy arrays) → the port's, on ``device``. The
    optimizer state stays in the reference's stacked layout, in f32."""
    return {"params": lm_params_from_jax(tree["params"], cfg, device),
            "opt": _tree_map(lambda a: tensor_from_numpy(
                a, torch.float32, device), tree["opt"]),
            "step": tensor_from_numpy(tree["step"], torch.int32, device)}


def train_state_to_numpy(state: dict) -> dict:
    """The port's train state → the reference's layout as numpy arrays in
    their native dtypes (bf16 as ``|V2``; the step as an int32 scalar)."""
    return {"params": lm_params_to_numpy(state["params"], native=True),
            "opt": _tree_map(lambda t: tensor_to_numpy(t, True),
                             state["opt"]),
            "step": tensor_to_numpy(state["step"], True)}
