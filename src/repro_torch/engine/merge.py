"""Deterministic round-robin merge of G per-group ordered logs.

Multi-Ring Paxos' merge function: each ordering group appends its ordered
ids to a per-group log; a learner consumes the logs round-robin (round r
yields group 0's r-th entry, then group 1's, ...), so every learner
derives the same total order without cross-group coordination. The merge
emits only the maximal prefix whose earlier round-robin positions all
exist (watermarks), and ``SKIP`` tokens hold a position without being
emitted, so an idle group never stalls the merged log.

Logs are fixed-shape ``int32[G, L]`` append buffers; the merged prefix is
returned padded with ``PAD``. Everything is int32, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

SKIP = -2   # explicit null instance: holds a round-robin slot, never emitted
PAD = -1    # padding in fixed-shape outputs / unwritten log tail
RECONFIG = -3  # epoch-boundary marker: holds one aligned round-robin slot
               # in every group's log at a membership switch, never
               # emitted, never blocks commit

_I32 = torch.int32


class MergeState(NamedTuple):
    """Per-group ordered logs plus append watermarks.

    ``overflowed`` counts entries whose append landed past capacity L;
    any nonzero value means the log was undersized and the merged and
    committed counts are a plateau, not the true order."""
    logs: torch.Tensor        # int32[G, L] entries; tail beyond watermark=PAD
    watermarks: torch.Tensor  # int32[G]    appended entries per group
    overflowed: torch.Tensor  # int32[G]    entries dropped past capacity


def init_merge(groups: int, capacity: int, device=None) -> MergeState:
    """Fresh empty logs: int32[G, capacity] all PAD, zero watermarks and
    overflow counters."""
    dev = resolve_device(device)
    return MergeState(
        logs=torch.full((groups, capacity), PAD, dtype=_I32, device=dev),
        watermarks=torch.zeros((groups,), dtype=_I32, device=dev),
        overflowed=torch.zeros((groups,), dtype=_I32, device=dev),
    )


def append_entries(state: MergeState, entries: torch.Tensor,
                   counts: torch.Tensor) -> MergeState:
    """Append ``entries[g, :counts[g]]`` to group g's log at its watermark.

    entries int32[G, K]; counts int32[G] (0 ≤ counts ≤ K). Entries past
    capacity are not stored; their number accumulates in
    ``overflowed``."""
    G, L = state.logs.shape
    K = entries.shape[1]
    j = torch.arange(L, dtype=_I32, device=entries.device)[None, :]
    rel = j - state.watermarks[:, None]
    take = (rel >= 0) & (rel < counts[:, None])
    gathered = torch.gather(entries, 1, rel.clamp(0, K - 1).long())
    logs = torch.where(take, gathered, state.logs)
    counts = counts.to(_I32)
    # entries whose cell index wm+k lands at or past L (the watermark may
    # already exceed L from earlier overflow, hence the clip to [0, counts])
    over = torch.minimum((state.watermarks + counts - L).clamp(min=0),
                         counts)
    return MergeState(logs=logs, watermarks=state.watermarks + counts,
                      overflowed=state.overflowed + over)


def mergeable_counts(watermarks: torch.Tensor) -> torch.Tensor:
    """Per-group count of entries inside the maximal merged prefix:
    count[g] = min(min(wm[0..g]), min(wm[g+1..]) + 1)."""
    big = torch.iinfo(_I32).max
    prefix_min = torch.cummin(watermarks, dim=0).values
    suffix_min = torch.cummin(watermarks.flip(0), dim=0).values.flip(0)
    suffix_after = torch.cat([suffix_min[1:], watermarks.new_full((1,), big)])
    return torch.minimum(prefix_min,
                         torch.minimum(suffix_after,
                                       suffix_after.new_tensor(big - 1)) + 1)


def _round_robin(state: MergeState):
    """(flat logs in position order i·G + g, emit mask, G, L)."""
    G, L = state.logs.shape
    counts = mergeable_counts(state.watermarks)
    pos = torch.arange(G * L, dtype=_I32, device=state.logs.device)
    emit = (pos // G) < counts[(pos % G).long()]
    return state.logs.T.reshape(-1), emit, G, L


def merged_prefix(state: MergeState) -> tuple[torch.Tensor, torch.Tensor]:
    """Maximal merged prefix: (out int32[G·L] padded with PAD, count).
    Control tokens (SKIP, RECONFIG) are dropped and do not count."""
    flat, emit, G, L = _round_robin(state)
    keep = emit & (flat >= 0)
    out_idx = torch.cumsum(keep.to(_I32), dim=0, dtype=_I32) - 1
    out = torch.full((G * L + 1,), PAD, dtype=_I32, device=flat.device)
    out.scatter_(0, torch.where(keep, out_idx, G * L).long(), flat)
    return out[:G * L], keep.sum(dtype=_I32)


def _scatter_rows(assigned: torch.Tensor, slot_ids: torch.Tensor,
                  width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each group's assigned slot ids in slot order, SKIP-padded to
    ``width`` (entries past ``width`` dropped), and n_assigned int32[G]."""
    mask = assigned >= 0
    pos = torch.cumsum(mask.to(_I32), dim=1, dtype=_I32) - 1
    n_assigned = mask.sum(dim=1, dtype=_I32)
    G = assigned.shape[0]
    entries = torch.full((G, width + 1), SKIP, dtype=_I32,
                         device=assigned.device)
    idx = torch.where(mask & (pos < width), pos, width).long()
    entries.scatter_(1, idx, slot_ids.to(_I32))
    return entries[:, :width].contiguous(), n_assigned


def entries_from_assigned(assigned: torch.Tensor, slot_ids: torch.Tensor,
                          max_entries: int)\
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tick's ``assigned`` int32[G, W] → merge entries.

    Returns (entries int32[G, max_entries], counts int32[G], dropped int32
    scalar): each group's newly ordered ids in instance order, padded to
    the per-tick maximum with SKIP; counts are clamped to
    ``max_entries``, and ``dropped`` counts the ordered ids that did not
    fit (always 0 when ``max_entries ≥ order_budget``)."""
    entries, n_assigned = _scatter_rows(assigned, slot_ids, max_entries)
    counts = n_assigned.max().clamp(max=max_entries).expand(
        n_assigned.shape).contiguous()
    dropped = (n_assigned - max_entries).clamp(min=0).sum(dtype=_I32)
    return entries, counts, dropped


def round_entries(assigned: torch.Tensor, slot_ids: torch.Tensor,
                  round_width: int)\
        -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fixed-width merge round per group: the extraction of
    :func:`entries_from_assigned` but exactly ``round_width`` entries wide
    for every group. Returns (entries int32[G, round_width], n_assigned
    int32[G], dropped int32[G])."""
    entries, n_assigned = _scatter_rows(assigned, slot_ids, round_width)
    return entries, n_assigned, (n_assigned - round_width).clamp(min=0)


def committed_prefix_len(state: MergeState,
                         decided_by_instance: torch.Tensor,
                         retired_base: torch.Tensor | None = None)\
        -> torch.Tensor:
    """Length of the merged prefix a state machine may consume.

    ``decided_by_instance`` bool[G, C] marks committed instances; the
    count stops at the first emitted entry whose instance is not
    committed (tokens commit nothing and never block). ``retired_base``
    int32[G] marks every instance below it committed (window recycling
    retired them decided); ``None`` keeps the non-recycled gate."""
    G, L = state.logs.shape
    C = decided_by_instance.shape[1]
    if retired_base is not None:
        decided_by_instance = decided_by_instance | (
            torch.arange(C, dtype=_I32, device=state.logs.device)[None, :]
            < retired_base[:, None])
    in_log = torch.arange(L, dtype=_I32, device=state.logs.device)[None, :] \
        < state.watermarks[:, None]
    # real-id cells only: SKIP and RECONFIG hold positions but carry no
    # instance, commit nothing, and never block
    nonskip = (state.logs >= 0) & in_log
    rank = torch.cumsum(nonskip.to(_I32), dim=1, dtype=_I32) - 1
    ent_dec = torch.where(
        nonskip,
        torch.gather(decided_by_instance, 1, rank.clamp(0, C - 1).long()),
        True)
    flat, emit, _, _ = _round_robin(state)
    keep = emit & (flat >= 0)
    dec = ent_dec.T.reshape(-1)
    # barrier: all-committed so far, in round-robin position order
    barrier = torch.cumprod(torch.where(emit, dec, True).to(_I32), dim=0,
                            dtype=_I32)
    return (keep & (barrier > 0)).sum(dtype=_I32)


# -- pure-python oracle (property-test target) --------------------------------

def oracle_merge(group_logs: list[list[int]]) -> list[int]:
    """Reference merge: strict round-robin over rounds, stop at the first
    missing entry, drop control tokens (SKIP, RECONFIG)."""
    out: list[int] = []
    r = 0
    while True:
        for g in range(len(group_logs)):
            if r >= len(group_logs[g]):
                return out
            e = group_logs[g][r]
            if e >= 0:
                out.append(int(e))
        r += 1


def oracle_is_legal_interleaving(merged: list, group_orders: list[list])\
        -> bool:
    """True iff ``merged`` is a legal interleaving of the per-group orders:
    its restriction to each group's ids equals a prefix of that group's
    order, and it contains no foreign ids (the checker is
    ``core.invariants.check_legal_interleaving``, shared with the DES
    audit)."""
    from ..core.invariants import check_legal_interleaving
    return not check_legal_interleaving(merged, group_orders)
