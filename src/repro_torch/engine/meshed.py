"""Device-sharded group execution: the G group rows spread over ranks.

The engine's G ordering groups are embarrassingly parallel within a
tick: quorum math, the stability gate, recycling and the adaptive
masked rounds are all row-wise over the leading group axis. The only
cross-group computation is the round-robin merge: the uniform SKIP-pad
width of a lock-step tick is ``min(max_g n_assigned[g], max_entries)``
(a cross-group max), and the log interleaves all groups. This module
exploits that split, as the reference's ``shard_map`` over a
``("group",)`` mesh does, with one process per rank
(``torch.distributed``; ``launch.mesh.make_group_mesh``):

* **state is sharded**: on each rank a meshed :class:`~.api.EngineState`
  holds that rank's ``rows`` group rows of the family state, the slot→id
  map and the per-group traffic, pad rows included; each rank launches
  its own kernels over its own rows (one quorum pair and, gated, one
  stability launch per tick) with no cross-rank traffic;
* **the merge is replicated**: each rank extracts its rows' fixed-width
  entry rows (``merge.round_entries``), one gather per tick or pass
  collects the ``[G, width]`` block and the per-group assignment counts
  (packed into one int32 buffer), and every rank applies the same wide
  ``append_entries`` to its full replica of the MergeState. The uniform
  width and ``dropped`` come from the *gathered* counts, so every
  replica stays identical.

All engine math is integer and boolean, so the meshed path equals the
unmeshed one bit for bit at any world size.

Padding: when the mesh size does not divide G, the row axis is padded
with fresh rows that receive zero traffic: they never assign, never
recycle, and are sliced off every gathered block before the merge.
Fresh ids come from each row's *logical* group range
(:func:`local_id_base`), so a rank's rows recycle exactly as the same
rows of the unmeshed engine do.

Inputs are logical: every rank passes the same ``[G, W, words]`` (or
``[T, G, W, words]``) traffic, and the entry points take the rank's
rows (:func:`local_rows`). The ``*_rows`` variants take the rank's rows
directly (the closed pipeline builds only those). Outputs — ``merged``,
``count``, ``committed``, ``dropped``, rounds and the gathered
``assigned`` / ``consumed`` / ``n_retired`` — are the same on every
rank. :func:`gather_state` gives the logical, unpadded state on every
rank and :func:`shard_state` is its inverse.

Entry points are reached through the facade (``EngineConfig(mesh=
MeshConfig(...))``): :func:`run` and :func:`tick` behind ``api.run`` and
``api.tick``; ``api.recycle``, ``committed_prefix`` and ``reconfigure``
use the helpers here. The reference's meshed ``adaptive_pass`` and
``subtick_pass`` are ``engine.adaptive``'s own passes, which run on a
rank's rows, take R from the gathered lag and append through
:func:`append_rounds`. Importing this module creates no process group
and touches no device.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from ..dissem.engine import init_dissem
from ..launch import mesh as launch_mesh
from . import merge as merge_mod
from . import sharded as sharded_mod

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _cached_mesh(groups, n_devices, axis_name, world):
    # ``world`` (the default process group, None without one) keys the
    # cache, so a new process group never meets a stale mesh
    return launch_mesh.make_group_mesh(groups, n_devices=n_devices,
                                       axis_name=axis_name)


def mesh_for(cfg) -> launch_mesh.GroupMesh:
    """The group mesh of a meshed config, made at first use (a
    subgroup is made then, by every rank of the world)."""
    world = dist.group.WORLD if dist.is_available() and \
        dist.is_initialized() else None
    return _cached_mesh(cfg.groups, cfg.mesh.n_devices, cfg.mesh.axis_name,
                        world)


def unmeshed(cfg):
    """The same config without its mesh (the logical engine)."""
    return dataclasses.replace(cfg, mesh=None)


def member_mesh(cfg) -> launch_mesh.GroupMesh:
    """:func:`mesh_for`, raising on a rank the mesh left out."""
    mesh = mesh_for(cfg)
    if mesh.rank < 0:
        raise RuntimeError(
            f"rank {dist.get_rank()} is outside the {mesh.size}-rank "
            f"group mesh of this {cfg.groups}-group engine")
    return mesh


# -- rows ---------------------------------------------------------------------

def fresh_rows(cfg, n: int, first: int, device):
    """``n`` fresh rows of the family state for padded rows ``first,
    first+1, ...``: ``(core, dissem, slot_ids)``, slot ids from each
    row's own range (pad rows' ids lie past every real range and are
    never emitted)."""
    W, D, S = cfg.window, cfg.n_diss, cfg.n_seq
    fam = cfg.family
    if fam in ("plain", "gated"):
        dissem = None if fam == "plain" else init_dissem(
            n, W, cfg.gating.n_diss_partition,
            pre_stable=cfg.gating.pre_stable, device=device)
        return (sharded_mod.init_sharded(n, W, D, S, device), dissem,
                sharded_mod.default_slot_ids(n, W, device) + first * W)
    stride = cfg.recycling.id_stride
    if fam == "recycled":
        core = sharded_mod.init_recycled(n, W, D, S, id_stride=stride,
                                         device=device)
        return (core._replace(slot_ids=core.slot_ids + first * stride),
                None, None)
    core = sharded_mod.init_gated_recycled(
        n, W, D, S, n_diss_partition=cfg.gating.n_diss_partition,
        id_stride=stride, pre_stable=cfg.gating.pre_stable, device=device)
    rs = core.rs._replace(slot_ids=core.rs.slot_ids + first * stride)
    return core._replace(rs=rs), None, None


def local_rows(cfg, x, dim: int = 0):
    """This rank's rows of a logical ``[..., G, ...]`` tensor (group axis
    ``dim``), zero rows for its pad rows; ``None`` stays ``None``."""
    if x is None:
        return None
    mesh = member_mesh(cfg)
    G = cfg.groups
    lo, hi = min(mesh.first, G), min(mesh.first + mesh.rows, G)
    part = x.narrow(dim, lo, hi - lo)
    n_pad = mesh.rows - (hi - lo)
    if n_pad == 0:
        return part
    shape = list(x.shape)
    shape[dim] = n_pad
    return torch.cat([part, x.new_zeros(shape)], dim=dim)


def local_id_base(cfg, device):
    """Fresh-id range bases of this rank's rows, int32[rows]: logical
    ``g · id_stride`` with ``g = first + i`` (``None`` without
    recycling). Pad rows get out-of-range bases, which is fine: they
    never recycle (zero traffic, free == W ≥ watermark)."""
    if cfg.recycling is None:
        return None
    mesh = member_mesh(cfg)
    return (mesh.first + torch.arange(mesh.rows, dtype=_I32, device=device)
            ) * cfg.recycling.id_stride


def gather_rows(cfg, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` ([rows, ...], any int or bool dtype) in
    logical order, pad rows dropped: ``[G, ...]`` on every rank."""
    mesh = member_mesh(cfg)
    if x.dtype == torch.bool:
        return launch_mesh.all_gather_rows(x.to(torch.uint8), mesh
                                           )[:cfg.groups].bool()
    return launch_mesh.all_gather_rows(x, mesh)[:cfg.groups]


def _map(f, tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_map(f, v) for v in tree))
    return f(tree)


def gather_state(cfg, state):
    """The logical engine state, unpadded, on every rank: every row leaf
    gathered, the merge replica as it is."""
    def g(x):
        return gather_rows(cfg, x)
    return state._replace(core=_map(g, state.core),
                          dissem=_map(g, state.dissem),
                          slot_ids=_map(g, state.slot_ids))


def shard_state(cfg, state):
    """This rank's meshed state from a logical one (the inverse of
    :func:`gather_state`): its rows copied, fresh pad rows appended.
    Modifies no input."""
    mesh = member_mesh(cfg)
    G = cfg.groups
    lo, hi = min(mesh.first, G), min(mesh.first + mesh.rows, G)
    n_pad = mesh.rows - (hi - lo)
    dev = state.merge.logs.device

    def take(x):
        return x[lo:hi].clone()
    core, dissem, sids = (_map(take, t) for t in (state.core, state.dissem,
                                                 state.slot_ids))
    if n_pad:
        pads = fresh_rows(cfg, n_pad, mesh.first + hi - lo, dev)

        def cat(a, b):
            if a is None:
                return None
            if isinstance(a, tuple):
                return type(a)(*(cat(x, y) for x, y in zip(a, b)))
            return torch.cat([a, b])
        core, dissem, sids = (cat(a, b) for a, b in zip((core, dissem, sids),
                                                        pads))
    return state._replace(core=core, dissem=dissem, slot_ids=sids,
                          merge=_map(torch.clone, state.merge))


# -- the merge crossing -------------------------------------------------------

def _tick_and_append(cfg, state, a, v, h, inplace: bool,
                     with_assigned: bool):
    """One lock-step tick on this rank's rows and the replicated append.

    Local: the family tick (absorb → assign → vote → recycle) and the
    fixed-width entry extraction. Across ranks: one gather of the entry
    rows and assignment counts (and ``assigned``, when asked) in one
    int32 buffer. The uniform SKIP-pad width is recomputed from the
    gathered counts, the ``min(max_g n_assigned, max_entries)`` of the
    unmeshed ``entries_from_assigned``. Returns ``(state, dropped,
    assigned int32[G, W] or None)``."""
    from .adaptive import _family_tick   # adaptive imports this module
    G, K = cfg.groups, cfg.max_entries
    dev = state.merge.logs.device
    core, dissem, assigned, sids = _family_tick(
        cfg, state.core, state.dissem, state.slot_ids, a, v, h,
        id_base=local_id_base(cfg, dev), inplace=inplace)
    ent_l, n_l, _ = merge_mod.round_entries(assigned, sids, K)
    parts = [ent_l, n_l[:, None]] + ([assigned] if with_assigned else [])
    got = gather_rows(cfg, torch.cat(parts, dim=1))
    n_as = got[:, K]
    counts = n_as.max().clamp(max=K).expand(G).contiguous()
    dropped = (n_as - K).clamp(min=0).sum(dtype=_I32)
    ms = merge_mod.append_entries(state.merge, got[:, :K], counts)
    state = state._replace(core=core, dissem=dissem, merge=ms)
    return state, dropped, got[:, K + 1:] if with_assigned else None


def committed_prefix(cfg, state):
    """(merged, merged_count, committed_count), the same on every rank.

    The per-slot decided→instance scatter is row-local; the gathered
    [G, L] flags (and ``retired``) feed the same ``committed_prefix_len``
    the unmeshed gates use."""
    L = state.merge.logs.shape[1]
    merged, count = merge_mod.merged_prefix(state.merge)
    if cfg.recycling is not None:
        rs = state.core.rs if cfg.family == "gated_recycled" \
            else state.core
        live_l = sharded_mod._decided_by_instance(rs.q.instance,
                                                  rs.q.decided, L)
        got = gather_rows(cfg, torch.cat([live_l.to(_I32),
                                          rs.retired[:, None]], dim=1))
        committed = merge_mod.committed_prefix_len(
            state.merge, got[:, :L].bool(), retired_base=got[:, L])
        return merged, count, committed
    dec_l = sharded_mod._decided_by_instance(state.core.instance,
                                             state.core.decided, L)
    return merged, count, merge_mod.committed_prefix_len(
        state.merge, gather_rows(cfg, dec_l))


# -- facade entry points ------------------------------------------------------

def run(cfg, state, acks_seq, votes_seq, holds_seq=None, *,
        inplace: bool = False):
    """Meshed twin of ``api.run`` over logical ``[T, G, W, words]``
    traffic: T ticks on this rank's rows, one gather per tick, then the
    commit gate. ``dropped`` comes from the gathered counts, so the
    run's one no-drop check sees the same value on every rank. Returns
    ``(state, merged, count, committed)``."""
    a_seq, v_seq, h_seq = (local_rows(cfg, x, 1)
                           for x in (acks_seq, votes_seq, holds_seq))
    dropped = torch.zeros((), dtype=_I32, device=state.merge.logs.device)
    for t in range(a_seq.shape[0]):
        state, d_t, _ = _tick_and_append(
            cfg, state, a_seq[t], v_seq[t],
            None if h_seq is None else h_seq[t], inplace, False)
        dropped = dropped + d_t
    sharded_mod._assert_no_dropped(dropped)
    return (state,) + committed_prefix(cfg, state)


def tick(cfg, state, acks, votes, holds=None, *, inplace: bool = False):
    """Meshed twin of ``api.tick`` over logical ``[G, W, words]`` tiles.
    The out dict is the reference's reduced one: ``assigned`` (gathered,
    int32[G, W]) and ``dropped``."""
    return tick_rows(cfg, state, local_rows(cfg, acks),
                     local_rows(cfg, votes), local_rows(cfg, holds),
                     inplace=inplace)


def tick_rows(cfg, state, acks, votes, holds=None, *,
              inplace: bool = False):
    """:func:`tick` over this rank's rows of the tiles (``[rows, W,
    words]``, zero rows for pad rows)."""
    state, dropped, assigned = _tick_and_append(cfg, state, acks, votes,
                                                holds, inplace, True)
    return state, {"assigned": assigned, "dropped": dropped}


def append_rounds(cfg, state, buf, R, n_rounds: int, drop_l, extra=None):
    """The merge crossing of an adaptive or subtick pass: gather the first
    ``R·rw`` columns of every rank's round buffer (with each row's drops
    and ``extra`` int32[rows], in one buffer) and append them to the
    replica. Returns ``(state, dropped, extra gathered to [G] or
    None)``."""
    G, rw = cfg.groups, cfg.max_entries
    width = n_rounds * rw
    parts = [buf[:, :width], drop_l[:, None]] + \
        ([] if extra is None else [extra[:, None]])
    got = gather_rows(cfg, torch.cat(parts, dim=1))
    if n_rounds:
        counts = (R * rw).to(_I32).expand(G)
        state = state._replace(merge=merge_mod.append_entries(
            state.merge, got[:, :width].contiguous(), counts))
    dropped = got[:, width].sum(dtype=_I32)
    return state, dropped, None if extra is None else got[:, width + 1]
