"""Vectorized HT-Paxos quorum/ordering data plane in PyTorch.

The sequencer hot path (§4.1 steps 36–37 plus the ordering layer) over a
sliding window of W in-flight batch ids per ordering group, on packed
bitsets with a leading group axis:

  1. **absorb acks** — OR a packed ack tile into ``ack_bits``, popcount,
     threshold against the disseminator majority (the quorum kernel);
  2. **order** — assign consecutive instances to newly stable ids in slot
     (FIFO) order with an exclusive cumsum, at most ``order_budget`` per
     group per tick (the §5.1 leader pipeline bound);
  3. **commit** — the same quorum pass over phase-2b vote bitsets decides
     assigned instances.

``compact_and_refill_packed`` is window recycling: retire the contiguous
decided instance prefix, shift live slots down in slot order, refill the
freed tail with fresh monotone ids.

Bitsets are ``torch.int32`` with the bits of ``uint32`` words (CPU torch
has no shift or index_copy for ``uint32``). Every function takes the
group axis G explicitly: states are ``[G, W, ...]``, scalars per group
are ``[G]``. The ack and vote absorb run through
``repro_torch.kernels.quorum`` — the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.quorum import popcount_rows  # noqa: F401 (public here too)
from ..kernels.quorum import quorum_update_grouped


class QuorumState(NamedTuple):
    """G sliding windows of W in-flight ids at the sequencer groups."""
    ack_bits: torch.Tensor       # int32[G, W, WORDS_D] disseminator acks
    vote_bits: torch.Tensor      # int32[G, W, WORDS_S] phase-2b votes
    stable: torch.Tensor         # bool[G, W]  member of stable_ids
    instance: torch.Tensor       # int32[G, W] ordering instance, -1 = none
    decided: torch.Tensor        # bool[G, W]  committed by a 2b majority
    next_instance: torch.Tensor  # int32[G]    leader's instance counter


def _words(n: int) -> int:
    return (n + 31) // 32


def init_state(groups: int, window: int, n_diss: int, n_seq: int,
               device=None) -> QuorumState:
    """Fresh windows: no acks, no votes, nothing stable, ordered or
    decided."""
    dev = resolve_device(device)
    gw = (groups, window)
    return QuorumState(
        ack_bits=torch.zeros(gw + (_words(n_diss),), dtype=torch.int32,
                             device=dev),
        vote_bits=torch.zeros(gw + (_words(n_seq),), dtype=torch.int32,
                              device=dev),
        stable=torch.zeros(gw, dtype=torch.bool, device=dev),
        instance=torch.full(gw, -1, dtype=torch.int32, device=dev),
        decided=torch.zeros(gw, dtype=torch.bool, device=dev),
        next_instance=torch.zeros((groups,), dtype=torch.int32, device=dev),
    )


def pack_tile(acks: torch.Tensor) -> torch.Tensor:
    """bool[..., D] → int32[..., ⌈D/32⌉] packed bitset (bit k of word j is
    column 32·j + k, as the reference's little-endian ``uint32`` words)."""
    *lead, D = acks.shape
    words = _words(D)
    a = F.pad(acks.to(torch.int64), (0, words * 32 - D))
    a = a.reshape(*lead, words, 32)
    weights = torch.ones(32, dtype=torch.int64, device=acks.device) \
        << torch.arange(32, dtype=torch.int64, device=acks.device)
    v = (a * weights).sum(dim=-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def absorb_acks_packed(state: QuorumState, packed: torch.Tensor,
                       majority: int, *, inplace: bool = False)\
        -> QuorumState:
    """Steps 1–3 on a packed int32[G, W, WORDS_D] ack tile (one quorum
    kernel launch). ``inplace`` updates ``state.ack_bits`` in place."""
    ack_bits, _, stable = quorum_update_grouped(
        state.ack_bits, packed, state.stable, majority=majority,
        inplace=inplace)
    return state._replace(ack_bits=ack_bits, stable=stable)


def assign_instances_core(state: QuorumState,
                          order_budget: int | None = None)\
        -> tuple[QuorumState, torch.Tensor]:
    """Step 4: each group's leader assigns consecutive instances to newly
    stable ids in slot order, at most ``order_budget`` per call (None =
    unbounded). Returns (state, assigned int32[G, W]: the instance given
    to each slot this call, or -1)."""
    fresh = state.stable & (state.instance < 0)
    f = fresh.to(torch.int32)
    offs = torch.cumsum(f, dim=1, dtype=torch.int32) - f
    if order_budget is not None:
        fresh = fresh & (offs < order_budget)
    assigned = torch.where(fresh, state.next_instance[:, None] + offs, -1)
    instance = torch.where(fresh, assigned, state.instance)
    nxt = state.next_instance + fresh.sum(dim=1, dtype=torch.int32)
    return state._replace(instance=instance, next_instance=nxt), assigned


def absorb_votes_packed(state: QuorumState, packed: torch.Tensor,
                        majority: int, *, inplace: bool = False)\
        -> tuple[QuorumState, torch.Tensor]:
    """Step 5 on a packed int32[G, W, WORDS_S] vote tile: one quorum kernel
    launch gives the new bits and counts; an instance commits once its
    count reaches ``majority`` and it has been assigned. The kernel's own
    threshold output has no instance gate and is not used. Returns
    (state, newly_decided bool[G, W])."""
    vote_bits, counts, _ = quorum_update_grouped(
        state.vote_bits, packed, state.decided, majority=majority,
        inplace=inplace)
    committed = (counts >= majority) & (state.instance >= 0)
    newly = committed & ~state.decided
    return state._replace(vote_bits=vote_bits,
                          decided=state.decided | committed), newly


def engine_tick_packed(state: QuorumState, packed_acks: torch.Tensor,
                       packed_votes: torch.Tensor, *, diss_majority: int,
                       seq_majority: int, order_budget: int | None = None,
                       inplace: bool = False)\
        -> tuple[QuorumState, dict]:
    """One tick of all G groups over packed tiles: absorb acks, assign,
    absorb votes (two quorum kernel launches)."""
    state = absorb_acks_packed(state, packed_acks, diss_majority,
                               inplace=inplace)
    state, assigned = assign_instances_core(state, order_budget)
    state, newly_decided = absorb_votes_packed(state, packed_votes,
                                               seq_majority, inplace=inplace)
    return state, {"assigned": assigned, "newly_decided": newly_decided}


def admitted_mask(state: QuorumState) -> torch.Tensor:
    """bool[G, W]: slots carrying observed dissemination/ordering state —
    nonzero ack bits, stability, an assigned instance, or a decision.
    Vote bits are deliberately excluded (a 2b vote means nothing for an
    unordered slot), as in the reference."""
    return ((state.ack_bits != 0).any(dim=-1) | state.stable
            | (state.instance >= 0) | state.decided)


class CompactionPlan(NamedTuple):
    """Slot permutation of one recycling pass, shared by every per-slot
    field that must move in lockstep (quorum and dissemination windows).

    ``sidx[g, w]`` is the destination row of slot w (== W for a retired
    slot, which is dropped); ``n_keep[g]`` the live slot count after the
    pass; ``adv[g]`` the frontier advance (instances retired)."""
    sidx: torch.Tensor    # int32[G, W]
    n_keep: torch.Tensor  # int32[G]
    adv: torch.Tensor     # int32[G]


def compaction_plan(state: QuorumState, retired: torch.Tensor,
                    enable: torch.Tensor | None = None) -> CompactionPlan:
    """Retire/keep/shift mapping of one recycling pass. A slot retires
    when its instance lies below its group's contiguous decided-instance
    frontier; ``enable`` bool[G] False makes a group's pass a no-op."""
    G, W = state.decided.shape
    valid = state.instance >= 0
    rel = torch.where(valid, state.instance - retired[:, None], W)
    rel = torch.where(rel < 0, W, rel)           # OOB guard (never, by
    #                                              the frontier invariant)
    # decided flags in instance order relative to the base; column W is
    # the sink that the reference's out-of-range-drop scatter discards
    sink = torch.where(rel < W, rel, W).long()
    dec_rel = torch.zeros((G, W + 1), dtype=torch.bool,
                          device=state.decided.device)
    dec_rel.scatter_(1, sink, state.decided)
    # frontier advance: leading run of decided instances
    adv = torch.cumprod(dec_rel[:, :W].to(torch.int32), dim=1,
                        dtype=torch.int32).sum(dim=1, dtype=torch.int32)
    if enable is not None:
        adv = torch.where(enable, adv, 0)
    retire = valid & (rel < adv[:, None])
    keep = (~retire).to(torch.int32)
    dest = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    n_keep = keep.sum(dim=1, dtype=torch.int32)
    sidx = torch.where(keep.bool(), dest, W)
    return CompactionPlan(sidx=sidx, n_keep=n_keep, adv=adv)


def _compact_into(plan: CompactionPlan, field: torch.Tensor,
                  fresh: torch.Tensor) -> torch.Tensor:
    """Scatter each kept row of ``field`` [G, W, ...] to its plan row on
    top of ``fresh`` (same shape). Retired rows land on one sink row past
    the end, so duplicate scatter indices only ever hit the sink."""
    G, W, *rest = field.shape
    rows = torch.arange(G, dtype=torch.int64, device=field.device)[:, None]
    dst = torch.where(plan.sidx < W, plan.sidx + rows * W, G * W)
    out = torch.cat([fresh.reshape(G * W, *rest),
                     fresh.new_zeros((1, *rest))])
    out.index_copy_(0, dst.reshape(-1), field.reshape(G * W, *rest))
    return out[:G * W].view(G, W, *rest)


def apply_compaction(plan: CompactionPlan, field: torch.Tensor,
                     fill) -> torch.Tensor:
    """Shift one per-slot field [G, W, ...] down per ``plan``; freed rows
    get ``fill``."""
    return _compact_into(plan, field, torch.full_like(field, fill))


def compact_and_refill_packed(state: QuorumState, slot_ids: torch.Tensor,
                              retired: torch.Tensor, id_base: torch.Tensor,
                              enable: torch.Tensor | None = None,
                              plan: CompactionPlan | None = None)\
        -> tuple[QuorumState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Window recycling: retire each group's decided instance prefix,
    compact, refill.

    slot_ids int32[G, W] global id of each slot; retired int32[G]
    instances retired so far (the monotone base offset); id_base int32[G]
    first id of each group's id range; enable optional bool[G] (False →
    a bit-exact no-op for that group); plan optional precomputed
    :class:`CompactionPlan` of exactly (state, retired, enable). Fresh
    tail ids continue ``id_base + W + retired + k``. Returns
    (state', slot_ids', retired', n_retired int32[G]); ``next_instance``
    is untouched."""
    W = state.decided.shape[1]
    if plan is None:
        plan = compaction_plan(state, retired, enable)
    new_state = state._replace(
        ack_bits=apply_compaction(plan, state.ack_bits, 0),
        vote_bits=apply_compaction(plan, state.vote_bits, 0),
        stable=apply_compaction(plan, state.stable, False),
        instance=apply_compaction(plan, state.instance, -1),
        decided=apply_compaction(plan, state.decided, False),
    )
    pos = torch.arange(W, dtype=torch.int32, device=slot_ids.device)
    fresh_ids = (id_base[:, None] + W + retired[:, None]
                 + (pos[None, :] - plan.n_keep[:, None]))
    new_ids = _compact_into(plan, slot_ids, fresh_ids.to(torch.int32))
    return new_state, new_ids, retired + plan.adv, plan.adv


def run_ticks(state: QuorumState, acks_seq: torch.Tensor,
              votes_seq: torch.Tensor, *, diss_majority: int,
              seq_majority: int, order_budget: int | None = None)\
        -> tuple[QuorumState, dict]:
    """T ticks of bool[T, G, W, D] / bool[T, G, W, S] traffic. Returns
    (state, outs) with each tick output stacked along a leading T."""
    outs = []
    for acks, votes in zip(acks_seq, votes_seq):
        state, out = engine_tick_packed(
            state, pack_tile(acks), pack_tile(votes),
            diss_majority=diss_majority, seq_majority=seq_majority,
            order_budget=order_budget)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
