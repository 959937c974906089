"""G independent quorum/ordering windows along a leading group axis.

Each group runs the single-window machinery of ``core.tilesim``; the
group axis is written out, so one tick of all G groups is one ack and one
vote launch of the grouped quorum kernel (plus one stability launch in
the gated families). The per-group orders are merged into the learner's
total order by ``engine.merge`` (deterministic round-robin with explicit
skips).

Four families, as in the reference:

* **plain** — a single-use window (``sharded_tick``,
  ``run_sharded_ticks(_merged)``);
* **recycled** — ``RecycleState``: whenever a group's free-slot count
  drops below a watermark and its frontier head is decided, its decided
  instance prefix retires, live slots shift down and the tail refills
  with fresh monotone ids, so the engine sustains throughput across
  unbounded window generations;
* **gated** — a ``DissemState`` beside the quorum window masks each
  slot's phase-2b votes until its batch is stable;
* **gated recycled** — both, one shared ``CompactionPlan`` moving the
  quorum and dissemination windows in lockstep.

Run loops are Python loops over the tick (PyTorch runs eagerly). The
``inplace`` flag of the tick and run functions writes the kernels'
bitset outputs into the state's own buffers (the counterpart of the
reference's buffer donation); without it no input tensor is modified.
No tick reads a value back to the host: recycling applies its masked
compaction to every group unconditionally (a disabled group's pass is a
bit-exact no-op), and the run loops check the accumulated ``dropped``
count once, at the end.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import tilesim
from ..core.tilesim import QuorumState
from ..device import resolve_device
from ..dissem.engine import DissemState, absorb_holds_packed, init_dissem
from . import merge as merge_mod

_I32 = torch.int32


def init_sharded(groups: int, window: int, n_diss: int, n_seq: int,
                 device=None) -> QuorumState:
    """QuorumState with a leading group axis: int32[G, W, WORDS]."""
    return tilesim.init_state(groups, window, n_diss, n_seq, device)


def default_slot_ids(groups: int, window: int, device=None) -> torch.Tensor:
    """Global id of slot (g, w): g·W + w (int32[G, W])."""
    dev = resolve_device(device)
    return (torch.arange(groups, dtype=_I32, device=dev)[:, None] * window
            + torch.arange(window, dtype=_I32, device=dev)[None, :])


def sharded_tick(state: QuorumState, packed_acks: torch.Tensor,
                 packed_votes: torch.Tensor, *, diss_majority: int,
                 seq_majority: int, order_budget: int | None = None,
                 inplace: bool = False) -> tuple[QuorumState, dict]:
    """One tick of all G groups over packed tiles (acks int32[G, W,
    WORDS_D], votes int32[G, W, WORDS_S]). Returns (state, out) with
    out["assigned"] int32[G, W] and out["newly_decided"] bool[G, W]."""
    return tilesim.engine_tick_packed(
        state, packed_acks, packed_votes, diss_majority=diss_majority,
        seq_majority=seq_majority, order_budget=order_budget,
        inplace=inplace)


def sharded_tick_dense(state: QuorumState, acks: torch.Tensor,
                       votes: torch.Tensor, *, diss_majority: int,
                       seq_majority: int, order_budget: int | None = None)\
        -> tuple[QuorumState, dict]:
    """Bool-tile form of :func:`sharded_tick` (acks bool[G, W, D], votes
    bool[G, W, S], packed with ``tilesim.pack_tile``): the interface of
    the reference's ``jaxsim.engine_tick`` with a group axis (two quorum
    kernel launches on a CUDA tensor)."""
    return sharded_tick(state, tilesim.pack_tile(acks),
                        tilesim.pack_tile(votes),
                        diss_majority=diss_majority,
                        seq_majority=seq_majority,
                        order_budget=order_budget)


def run_sharded_ticks(state: QuorumState, packed_acks_seq: torch.Tensor,
                      packed_votes_seq: torch.Tensor, *, diss_majority: int,
                      seq_majority: int, order_budget: int | None = None)\
        -> tuple[QuorumState, dict]:
    """T ticks of [T, G, W, WORDS] packed traffic; outputs stacked along
    a leading T."""
    outs = []
    for a, v in zip(packed_acks_seq, packed_votes_seq):
        state, out = sharded_tick(state, a, v, diss_majority=diss_majority,
                                  seq_majority=seq_majority,
                                  order_budget=order_budget)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _resolve_max_entries(max_entries: int | None,
                         order_budget: int) -> int:
    """Default and validate the per-tick merge buffer width (raises: the
    failure mode is silent merged-log corruption)."""
    if max_entries is None:
        return order_budget
    if max_entries < order_budget:
        raise ValueError(
            f"max_entries={max_entries} < order_budget={order_budget}: a "
            "tick could assign more ids than the merge buffer holds — "
            "truncated entries desynchronize the commit gate's instance "
            "ranks and can let it consume uncommitted ids")
    return max_entries


def _assert_no_dropped(dropped: torch.Tensor) -> None:
    """Raise if ordered ids were truncated out of the merge entries (the
    run loops' accumulated ``dropped``; zero whenever ``max_entries ≥
    order_budget``, which ``_resolve_max_entries`` enforces)."""
    n = int(dropped)
    if n != 0:
        raise AssertionError(
            f"{n} ordered ids were truncated out of the merge entries "
            "(over-assignment past max_entries) — the merged order is "
            "missing ids and the commit gate's instance ranks are "
            "desynchronized")


def _decided_by_instance(instance: torch.Tensor, decided: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """Per-slot decided flags in instance order: bool[G, C], entry (g, k)
    True iff instance k of group g is decided in the live window."""
    G = instance.shape[0]
    out = torch.zeros((G, capacity + 1), dtype=torch.bool,
                      device=instance.device)
    idx = torch.where((instance >= 0) & (instance < capacity), instance,
                      capacity)
    out.scatter_(1, idx.long(), decided)
    return out[:, :capacity]


def _live_committed(q: QuorumState, merge_state: merge_mod.MergeState):
    """(merged, count, committed) with the live-window commit gate."""
    merged, count = merge_mod.merged_prefix(merge_state)
    dec = _decided_by_instance(q.instance, q.decided,
                               merge_state.logs.shape[1])
    return merged, count, merge_mod.committed_prefix_len(merge_state, dec)


def _append(merge_state, assigned, slot_ids, max_entries):
    entries, counts, dropped = merge_mod.entries_from_assigned(
        assigned, slot_ids, max_entries)
    return merge_mod.append_entries(merge_state, entries, counts), dropped


def run_sharded_ticks_merged(state: QuorumState, merge_state,
                             packed_acks_seq: torch.Tensor,
                             packed_votes_seq: torch.Tensor,
                             slot_ids: torch.Tensor, *, diss_majority: int,
                             seq_majority: int, order_budget: int,
                             max_entries: int | None = None,
                             inplace: bool = False):
    """Hot loop: tick all groups and feed the deterministic merge, then
    apply the commit gate. Returns (state, merge_state, merged int32[G·L]
    padded, merged_count, committed_count): ``merged[:merged_count]`` is
    the total order; only ``merged[:committed_count]`` may be consumed."""
    max_entries = _resolve_max_entries(max_entries, order_budget)
    dropped = torch.zeros((), dtype=_I32, device=slot_ids.device)
    for a, v in zip(packed_acks_seq, packed_votes_seq):
        state, out = sharded_tick(state, a, v, diss_majority=diss_majority,
                                  seq_majority=seq_majority,
                                  order_budget=order_budget, inplace=inplace)
        merge_state, d_t = _append(merge_state, out["assigned"], slot_ids,
                                   max_entries)
        dropped = dropped + d_t
    _assert_no_dropped(dropped)
    return (state, merge_state) + _live_committed(state, merge_state)


# -- window recycling ---------------------------------------------------------

class RecycleState(NamedTuple):
    """Sharded engine state plus the recycling bookkeeping: ``slot_ids``
    maps slot (g, w) to the global id it holds; ``retired`` is each
    group's monotone base offset, below which every instance is
    decided."""
    q: QuorumState
    slot_ids: torch.Tensor  # int32[G, W]
    retired: torch.Tensor   # int32[G]


def init_recycled(groups: int, window: int, n_diss: int, n_seq: int, *,
                  id_stride: int | None = None, device=None) -> RecycleState:
    """Fresh recycled engine; group g owns ids
    ``[g·id_stride, (g+1)·id_stride)``, which must exceed the ids a
    group ever admits. ``None`` is only legal for one group (→ window)."""
    if id_stride is None:
        if groups > 1:
            raise ValueError(
                "init_recycled(groups>1) needs an explicit id_stride: "
                "recycling issues fresh ids past g*id_stride + window, so "
                "a defaulted stride of `window` would collide with the "
                "next group's id range at the first recycle")
        id_stride = window
    q = init_sharded(groups, window, n_diss, n_seq, device)
    dev = q.stable.device
    ids = (torch.arange(groups, dtype=_I32, device=dev)[:, None] * id_stride
           + torch.arange(window, dtype=_I32, device=dev)[None, :])
    return RecycleState(q=q, slot_ids=ids,
                        retired=torch.zeros((groups,), dtype=_I32,
                                            device=dev))


def _recycle_plan_inputs(rs: RecycleState, watermark: int, id_stride: int,
                         id_base: torch.Tensor | None = None):
    """(enable bool[G], id_base int32[G]): a group recycles when fewer
    than ``watermark`` of its slots are undecided and the slot holding
    its frontier instance is decided. ``id_base`` defaults to row index
    × ``id_stride``."""
    q = rs.q
    free = (~q.decided).sum(dim=1, dtype=_I32)
    head_retirable = ((q.instance == rs.retired[:, None])
                      & q.decided).any(dim=1)
    if id_base is None:
        G = rs.slot_ids.shape[0]
        id_base = torch.arange(G, dtype=_I32, device=q.decided.device) \
            * id_stride
    return (free < watermark) & head_retirable, id_base


def recycle_groups(rs: RecycleState, *, watermark: int, id_stride: int,
                   id_base: torch.Tensor | None = None)\
        -> tuple[RecycleState, torch.Tensor]:
    """Per-group watermark-gated compaction and refill. The masked pass
    runs for every group (a disabled group is an exact no-op), so no host
    sync decides whether to run it. Returns (state', n_retired int32[G]).

    ``id_base`` int32[rows] overrides each row's fresh-id range base
    (default: row index × ``id_stride``). The meshed engine passes its
    rows' logical group offsets: a rank's local row 0 is not logical
    group 0, and fresh ids must come from the logical group's range."""
    enable, id_base = _recycle_plan_inputs(rs, watermark, id_stride,
                                           id_base)
    q, ids, retired, n_ret = tilesim.compact_and_refill_packed(
        rs.q, rs.slot_ids, rs.retired, id_base, enable)
    return RecycleState(q=q, slot_ids=ids, retired=retired), n_ret


def recycled_committed_prefix(rs: RecycleState,
                              merge_state: merge_mod.MergeState):
    """(merged, merged_count, committed_count) for a recycled engine:
    retired instances count as decided through the base offset."""
    live = _decided_by_instance(rs.q.instance, rs.q.decided,
                                merge_state.logs.shape[1])
    merged, count = merge_mod.merged_prefix(merge_state)
    committed = merge_mod.committed_prefix_len(merge_state, live,
                                               retired_base=rs.retired)
    return merged, count, committed


def _recycled_body(rs: RecycleState, merge_state, packed_acks, packed_votes,
                   *, diss_majority, seq_majority, order_budget, max_entries,
                   watermark, id_stride, inplace):
    """Tick → append to merge → recycle (entries reach the log before
    their slots can retire)."""
    q, out = sharded_tick(rs.q, packed_acks, packed_votes,
                          diss_majority=diss_majority,
                          seq_majority=seq_majority,
                          order_budget=order_budget, inplace=inplace)
    merge_state, dropped = _append(merge_state, out["assigned"],
                                   rs.slot_ids, max_entries)
    rs, n_ret = recycle_groups(
        RecycleState(q=q, slot_ids=rs.slot_ids, retired=rs.retired),
        watermark=watermark, id_stride=id_stride)
    return rs, merge_state, dict(out, n_retired=n_ret, dropped=dropped)


def recycled_tick_merged(rs: RecycleState, merge_state,
                         packed_acks: torch.Tensor,
                         packed_votes: torch.Tensor, *, diss_majority: int,
                         seq_majority: int, order_budget: int,
                         max_entries: int | None = None, watermark: int,
                         id_stride: int, inplace: bool = False):
    """One step of the sustained engine, for host-driven loops that read
    ``rs.slot_ids`` back between ticks. Returns (rs, merge_state, out)."""
    return _recycled_body(
        rs, merge_state, packed_acks, packed_votes,
        diss_majority=diss_majority, seq_majority=seq_majority,
        order_budget=order_budget,
        max_entries=_resolve_max_entries(max_entries, order_budget),
        watermark=watermark, id_stride=id_stride, inplace=inplace)


def run_recycled_ticks_merged(rs: RecycleState, merge_state,
                              packed_acks_seq: torch.Tensor,
                              packed_votes_seq: torch.Tensor, *,
                              diss_majority: int, seq_majority: int,
                              order_budget: int,
                              max_entries: int | None = None,
                              watermark: int, id_stride: int,
                              inplace: bool = False):
    """Sustained hot loop: T recycled steps, then the recycle-aware commit
    gate. Returns (rs, merge_state, merged, merged_count,
    committed_count). Tiles address slots by position, and recycling
    remaps slots mid-run: only position-uniform traffic is id-sound here
    (id-addressed traffic drives :func:`recycled_tick_merged`)."""
    kw = dict(diss_majority=diss_majority, seq_majority=seq_majority,
              order_budget=order_budget,
              max_entries=_resolve_max_entries(max_entries, order_budget),
              watermark=watermark, id_stride=id_stride, inplace=inplace)
    dropped = torch.zeros((), dtype=_I32, device=rs.slot_ids.device)
    for a, v in zip(packed_acks_seq, packed_votes_seq):
        rs, merge_state, out = _recycled_body(rs, merge_state, a, v, **kw)
        dropped = dropped + out["dropped"]
    _assert_no_dropped(dropped)
    return (rs, merge_state) + recycled_committed_prefix(rs, merge_state)


# -- dissemination-stability gating -------------------------------------------

def _gated_votes(d: DissemState, packed_votes: torch.Tensor) -> torch.Tensor:
    """Zero the vote tile of every not-yet-stable slot (votes are masked,
    not buffered: DES sequencers re-multicast 2b for pending instances)."""
    return torch.where(d.stable[..., None], packed_votes, 0)


def gated_tick(state: QuorumState, d: DissemState,
               packed_acks: torch.Tensor, packed_holds: torch.Tensor,
               packed_votes: torch.Tensor, *, diss_majority: int,
               seq_majority: int, stab_majority: int,
               order_budget: int | None = None, inplace: bool = False)\
        -> tuple[QuorumState, DissemState, dict]:
    """One tick of dissemination + ordering across all G groups. Holds
    absorb before votes are masked, so a vote arriving in the tick of the
    stabilizing delivery counts. Returns (state, d, out) with the ungated
    outputs plus out["newly_stable"] bool[G, W]."""
    d, dout = absorb_holds_packed(d, packed_holds, stab_majority,
                                  inplace=inplace)
    state, out = sharded_tick(state, packed_acks,
                              _gated_votes(d, packed_votes),
                              diss_majority=diss_majority,
                              seq_majority=seq_majority,
                              order_budget=order_budget, inplace=inplace)
    return state, d, dict(out, newly_stable=dout["newly_stable"])


def run_gated_ticks_merged(state: QuorumState, d: DissemState, merge_state,
                           packed_acks_seq: torch.Tensor,
                           packed_holds_seq: torch.Tensor,
                           packed_votes_seq: torch.Tensor,
                           slot_ids: torch.Tensor, *, diss_majority: int,
                           seq_majority: int, stab_majority: int,
                           order_budget: int,
                           max_entries: int | None = None,
                           inplace: bool = False):
    """:func:`run_sharded_ticks_merged` with the stability gate in the
    loop. Returns (state, d, merge_state, merged, merged_count,
    committed_count)."""
    max_entries = _resolve_max_entries(max_entries, order_budget)
    dropped = torch.zeros((), dtype=_I32, device=slot_ids.device)
    for a, h, v in zip(packed_acks_seq, packed_holds_seq, packed_votes_seq):
        state, d, out = gated_tick(
            state, d, a, h, v, diss_majority=diss_majority,
            seq_majority=seq_majority, stab_majority=stab_majority,
            order_budget=order_budget, inplace=inplace)
        merge_state, d_t = _append(merge_state, out["assigned"], slot_ids,
                                   max_entries)
        dropped = dropped + d_t
    _assert_no_dropped(dropped)
    return (state, d, merge_state) + _live_committed(state, merge_state)


class GatedRecycleState(NamedTuple):
    """Sustained gated engine: the recycled ordering state plus its
    lockstep dissemination window (slot (g, w) of ``d`` tracks the id in
    ``rs.slot_ids[g, w]``)."""
    rs: RecycleState
    d: DissemState


def init_gated_recycled(groups: int, window: int, n_diss: int, n_seq: int,
                        *, n_diss_partition: int | None = None,
                        id_stride: int | None = None,
                        pre_stable: bool = False,
                        device=None) -> GatedRecycleState:
    """Fresh sustained gated engine; ``n_diss_partition`` sizes the hold
    bitsets (defaults to ``n_diss``)."""
    if n_diss_partition is None:
        n_diss_partition = n_diss
    rs = init_recycled(groups, window, n_diss, n_seq, id_stride=id_stride,
                       device=device)
    return GatedRecycleState(
        rs=rs, d=init_dissem(groups, window, n_diss_partition,
                             pre_stable=pre_stable,
                             device=rs.slot_ids.device))


def gated_recycle_groups(gs: GatedRecycleState, *, watermark: int,
                         id_stride: int, fresh_stable: bool = False,
                         id_base: torch.Tensor | None = None)\
        -> tuple[GatedRecycleState, torch.Tensor]:
    """:func:`recycle_groups` for the gated engine: one shared per-group
    plan moves the quorum and dissemination windows; freed slots are born
    with empty holds and ``stable=fresh_stable``. ``id_base`` as in
    :func:`recycle_groups`."""
    enable, id_base = _recycle_plan_inputs(gs.rs, watermark, id_stride,
                                           id_base)
    plan = tilesim.compaction_plan(gs.rs.q, gs.rs.retired, enable)
    q, ids, retired, n_ret = tilesim.compact_and_refill_packed(
        gs.rs.q, gs.rs.slot_ids, gs.rs.retired, id_base, plan=plan)
    d = DissemState(
        hold_bits=tilesim.apply_compaction(plan, gs.d.hold_bits, 0),
        stable=tilesim.apply_compaction(plan, gs.d.stable, fresh_stable))
    return (GatedRecycleState(
        rs=RecycleState(q=q, slot_ids=ids, retired=retired), d=d), n_ret)


def _gated_recycled_body(gs: GatedRecycleState, merge_state, packed_acks,
                         packed_holds, packed_votes, *, diss_majority,
                         seq_majority, stab_majority, order_budget,
                         max_entries, watermark, id_stride, fresh_stable,
                         inplace):
    """Absorb holds → gated tick → append to merge → recycle both
    windows."""
    q, d, out = gated_tick(
        gs.rs.q, gs.d, packed_acks, packed_holds, packed_votes,
        diss_majority=diss_majority, seq_majority=seq_majority,
        stab_majority=stab_majority, order_budget=order_budget,
        inplace=inplace)
    merge_state, dropped = _append(merge_state, out["assigned"],
                                   gs.rs.slot_ids, max_entries)
    gs, n_ret = gated_recycle_groups(
        GatedRecycleState(rs=RecycleState(q=q, slot_ids=gs.rs.slot_ids,
                                          retired=gs.rs.retired), d=d),
        watermark=watermark, id_stride=id_stride, fresh_stable=fresh_stable)
    return gs, merge_state, dict(out, n_retired=n_ret, dropped=dropped)


def gated_recycled_tick_merged(gs: GatedRecycleState, merge_state,
                               packed_acks: torch.Tensor,
                               packed_holds: torch.Tensor,
                               packed_votes: torch.Tensor, *,
                               diss_majority: int, seq_majority: int,
                               stab_majority: int, order_budget: int,
                               max_entries: int | None = None,
                               watermark: int, id_stride: int,
                               fresh_stable: bool = False,
                               inplace: bool = False):
    """One step of the sustained gated engine, for host-driven loops that
    re-read ``gs.rs.slot_ids`` between ticks. Returns (gs, merge_state,
    out)."""
    return _gated_recycled_body(
        gs, merge_state, packed_acks, packed_holds, packed_votes,
        diss_majority=diss_majority, seq_majority=seq_majority,
        stab_majority=stab_majority, order_budget=order_budget,
        max_entries=_resolve_max_entries(max_entries, order_budget),
        watermark=watermark, id_stride=id_stride,
        fresh_stable=fresh_stable, inplace=inplace)


def run_gated_recycled_ticks_merged(gs: GatedRecycleState, merge_state,
                                    packed_acks_seq: torch.Tensor,
                                    packed_holds_seq: torch.Tensor,
                                    packed_votes_seq: torch.Tensor, *,
                                    diss_majority: int, seq_majority: int,
                                    stab_majority: int, order_budget: int,
                                    max_entries: int | None = None,
                                    watermark: int, id_stride: int,
                                    fresh_stable: bool = False,
                                    inplace: bool = False):
    """Sustained gated hot loop: T gated recycled steps, then the
    recycle-aware commit gate. Same return contract and traffic caveat as
    :func:`run_recycled_ticks_merged`; holds are int32[T, G, W,
    WORDS_DP]."""
    kw = dict(diss_majority=diss_majority, seq_majority=seq_majority,
              stab_majority=stab_majority, order_budget=order_budget,
              max_entries=_resolve_max_entries(max_entries, order_budget),
              watermark=watermark, id_stride=id_stride,
              fresh_stable=fresh_stable, inplace=inplace)
    dropped = torch.zeros((), dtype=_I32, device=gs.rs.slot_ids.device)
    for a, h, v in zip(packed_acks_seq, packed_holds_seq, packed_votes_seq):
        gs, merge_state, out = _gated_recycled_body(gs, merge_state, a, h, v,
                                                    **kw)
        dropped = dropped + out["dropped"]
    _assert_no_dropped(dropped)
    return (gs, merge_state) + recycled_committed_prefix(gs.rs, merge_state)
