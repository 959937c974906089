"""Epoch-based dynamic ordering-group membership (drain-then-switch).

The only coordination-bearing state when an HT-Paxos cluster is resized
is the ordering-group ownership of batch ids (§5.5). This module is the
reference's mechanism for the port's engine:

  * an :class:`EpochTable` pins, per epoch, which physical group rows are
    active; :func:`route_ids_epoch` routes a tensor of ids onto them,
    :func:`route_id_epoch` is its python twin for python batch ids;
  * the switch is **drain-then-switch**: rows leaving the active set
    first decide every assigned instance (:func:`is_drained`), then one
    ``merge.RECONFIG`` marker round is appended to every group's log at
    one aligned round (:func:`append_reconfig_marker`), and ids still
    live in a window whose owner changed are re-homed;
  * removed rows are **sealed** (recycled families): their decided
    prefix retires through the shared ``tilesim.CompactionPlan``, so the
    commit gate recovers their whole history from the ``retired`` base
    and the idle row never stalls the merge.

Reconfiguration is a control-plane call between ticking segments. As in
the reference it runs on the host: the state comes to numpy, the slot
swaps happen there, and the new tensors go back to the state's device.
Physical shapes never change (``n_rows`` rows are allocated up front and
epochs activate subsets). No input tensor is modified.

Only admitted-but-unordered slots move. Re-homing swaps the moving slot
with an unadmitted slot of its new owner row, so the id multiset and the
recycling refill invariant survive; ack and hold bitsets travel with the
slot, phase-2b vote bits are zeroed on both sides (votes are per-group
promises, and the slot is unordered).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..core import tilesim
from ..dissem.engine import DissemState, dissem_admitted_mask
from . import merge as merge_mod
from . import router
from .sharded import GatedRecycleState, RecycleState


@dataclass(frozen=True)
class EpochTable:
    """epoch → active physical group rows.

    ``active[e]`` is the strictly increasing tuple of row indices active
    in epoch e; ``n_rows`` is the physical leading dimension G_max every
    engine state is allocated with (defaults to ``max(row) + 1``). Epoch
    e's assignment must never be edited once ids were routed under it:
    in-flight ids carry their routing epoch until decided."""
    active: tuple[tuple[int, ...], ...]
    n_rows: int | None = None

    def __post_init__(self):
        if not self.active:
            raise ValueError("EpochTable needs at least one epoch")
        acts = tuple(tuple(int(g) for g in a) for a in self.active)
        for e, a in enumerate(acts):
            if not a:
                raise ValueError(f"epoch {e} has no active groups")
            if list(a) != sorted(set(a)):
                raise ValueError(
                    f"epoch {e} active rows must be strictly increasing "
                    f"(canonical form), got {a}")
        rows_max = max(max(a) for a in acts)
        n = self.n_rows if self.n_rows is not None else rows_max + 1
        if rows_max >= n:
            raise ValueError(
                f"active row {rows_max} out of range for n_rows={n}")
        object.__setattr__(self, "active", acts)
        object.__setattr__(self, "n_rows", int(n))

    @property
    def n_epochs(self) -> int:
        """Number of configured epochs (ids ``0 .. n_epochs-1``)."""
        return len(self.active)

    def groups(self, epoch: int) -> tuple[int, ...]:
        """The physical row indices active in ``epoch``."""
        return self.active[epoch]


def route_id_epoch(bid, table: EpochTable, epoch: int) -> int:
    """Owner row of a python-level batch id under ``epoch``: crc32 over
    the epoch's active-set size, mapped through the active tuple."""
    active = table.active[epoch]
    return active[router.route_id(bid, len(active))]


def route_ids_epoch(ids: torch.Tensor, table: EpochTable,
                    epoch: int) -> torch.Tensor:
    """uint32 ids (as an integer tensor) → int32 owner row of each id
    under ``epoch``, on the ids' device: ``router.route_ids`` over the
    epoch's active-set size, mapped through the active tuple."""
    active = table.active[epoch]
    if len(active) == 1:
        return torch.full(ids.shape, active[0], dtype=torch.int32,
                          device=ids.device)
    rows = torch.tensor(active, dtype=torch.int32, device=ids.device)
    return rows[router.route_ids(ids, len(active)).long()]


def _route_rows_np(ids_np: np.ndarray, table: EpochTable,
                   epoch: int) -> np.ndarray:
    """Host-side owner rows (numpy twin, the same placement)."""
    active = np.asarray(table.active[epoch], np.int32)
    return active[router.route_u32(ids_np, len(active))]


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy that writes never reach the tensor."""
    return t.detach().cpu().numpy().copy()


def _back(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


# -- drain / marker ------------------------------------------------------------

def is_drained(state, rows=None) -> bool:
    """True iff every assigned ordering instance in ``rows`` (default:
    all) of the leading-G QuorumState is decided — the drain condition
    for deactivating those rows."""
    pending = ((state.instance >= 0) & ~state.decided).cpu().numpy()
    if rows is not None:
        pending = pending[np.asarray(list(rows), np.int32)]
    return not bool(pending.any())


def append_reconfig_marker(ms: merge_mod.MergeState)\
        -> tuple[merge_mod.MergeState, int]:
    """Append the epoch-boundary marker at one aligned merge round.

    Every group's log is padded with SKIP up to ``r = max(watermarks)``
    and a RECONFIG token is written at round r for all groups, advancing
    every watermark to ``r + 1``, so every learner flips epochs at the
    same merge position. Both tokens are dropped from the merged output
    and never block the commit gate. Returns ``(ms', r)``. Raises if the
    log cannot hold the marker round or has overflowed (its cells no
    longer match its watermarks)."""
    logs = _np(ms.logs)
    wm = ms.watermarks.cpu().numpy().astype(np.int64)
    if ms.overflowed.cpu().numpy().any():
        raise ValueError(
            "merge log overflowed before the epoch switch — its cells no "
            "longer match the watermarks; re-init a larger log first")
    G, L = logs.shape
    r = int(wm.max())
    if r + 1 > L:
        raise ValueError(
            f"merge log capacity {L} cannot hold the marker round {r} — "
            "size the log for the whole run incl. one reconfig round")
    for g in range(G):
        logs[g, int(wm[g]):r] = merge_mod.SKIP
        logs[g, r] = merge_mod.RECONFIG
    new_wm = np.full((G,), r + 1, np.int32)
    return merge_mod.MergeState(
        logs=_back(logs, ms.logs), watermarks=_back(new_wm, ms.watermarks),
        overflowed=ms.overflowed), r


# -- state transfer ------------------------------------------------------------

def _check_epochs(table: EpochTable, old_epoch: int, new_epoch: int) -> None:
    for e in (old_epoch, new_epoch):
        if not 0 <= e < table.n_epochs:
            raise ValueError(f"epoch {e} not in table (n={table.n_epochs})")
    if new_epoch == old_epoch:
        raise ValueError("reconfiguration needs two distinct epochs")


def _rehome(slot_ids: np.ndarray, admitted: np.ndarray, ordered: np.ndarray,
            table: EpochTable, old_epoch: int, new_epoch: int,
            removed, move_payloads: list, reset_payloads: list) -> list:
    """Swap re-homed slots into unadmitted slots of their new owner rows
    (in place on the numpy arrays).

    An admitted-but-unordered slot moves iff its owner changed: the new
    epoch's router names another row than the old epoch's did, or its
    current row leaves the active set. ``move_payloads`` are
    ``(array[G, W, ...], zero)`` pairs carried with the slot;
    ``reset_payloads`` are zeroed on both sides. Returns the moves
    ``[(id, src_row, dst_row, dst_slot), ...]`` (rows ascending, slots
    ascending, destinations lowest-index-first)."""
    G, W = slot_ids.shape
    removed = set(removed)
    movable = admitted & ~ordered
    free = ~admitted & ~ordered
    free_q = {g: deque(np.nonzero(free[g])[0].tolist()) for g in range(G)}
    mg, mw = np.nonzero(movable)
    if mg.size == 0:
        return []
    ids_m = slot_ids[mg, mw]
    owner_old = _route_rows_np(ids_m, table, old_epoch)
    owner_new = _route_rows_np(ids_m, table, new_epoch)
    moves = []
    for g, w, oo, on in zip(mg.tolist(), mw.tolist(),
                            owner_old.tolist(), owner_new.tolist()):
        if on == oo and g not in removed:
            continue                      # ownership unchanged: stays put
        tgt = on
        if tgt == g:
            continue                      # already lives at the new owner
        if not free_q[tgt]:
            raise ValueError(
                f"group {tgt} has no unadmitted slot to receive re-homed "
                f"id {int(slot_ids[g, w])} — drain or recycle the "
                "destination rows before switching epochs")
        tw = free_q[tgt].popleft()
        moved_id = int(slot_ids[g, w])
        slot_ids[g, w], slot_ids[tgt, tw] = slot_ids[tgt, tw], slot_ids[g, w]
        for arr, zero in move_payloads:
            arr[tgt, tw] = arr[g, w]
            arr[g, w] = zero
        for arr, zero in reset_payloads:
            arr[tgt, tw] = zero
            arr[g, w] = zero
        # the swapped-in fresh id is unadmitted: reusable as a further
        # destination in this same pass
        free_q[g].append(w)
        moves.append((moved_id, g, tgt, int(tw)))
    return moves


def _drain_check(q, removed) -> None:
    if removed and not is_drained(q, removed):
        raise ValueError(
            f"groups {tuple(removed)} leave the active set but still have "
            "ordered-but-undecided instances — drain them (tick with vote "
            "traffic only) before switching epochs")


def _removed_added(table: EpochTable, old_epoch: int, new_epoch: int):
    old = set(table.active[old_epoch])
    new = set(table.active[new_epoch])
    return sorted(old - new), sorted(new - old)


def _rehome_quorum(q, slot_ids, table, old_epoch, new_epoch, removed,
                   d: DissemState | None = None):
    """Re-home the admitted-but-unordered slots of a quorum window (and
    of its lockstep dissemination window ``d``). Returns
    ``(q', slot_ids', d', moves)``."""
    ids, ack, vote, stab = (_np(t) for t in (slot_ids, q.ack_bits,
                                             q.vote_bits, q.stable))
    admitted = tilesim.admitted_mask(q).cpu().numpy()
    move = [(ack, 0), (stab, False)]
    if d is not None:
        holds, dstab = _np(d.hold_bits), _np(d.stable)
        admitted = admitted | dissem_admitted_mask(d).cpu().numpy()
        move += [(holds, 0), (dstab, False)]
    ordered = (q.instance >= 0).cpu().numpy()
    moves = _rehome(ids, admitted, ordered, table, old_epoch, new_epoch,
                    removed, move_payloads=move, reset_payloads=[(vote, 0)])
    q = q._replace(ack_bits=_back(ack, q.ack_bits),
                   vote_bits=_back(vote, q.vote_bits),
                   stable=_back(stab, q.stable))
    if d is not None:
        d = DissemState(hold_bits=_back(holds, d.hold_bits),
                        stable=_back(dstab, d.stable))
    return q, _back(ids, slot_ids), d, moves


def reconfigure_plain(state, slot_ids, ms, table: EpochTable,
                      old_epoch: int, new_epoch: int):
    """Epoch switch for the plain (non-recycled) engine.

    Removed rows must be drained; their decided slots stay in the window
    (the plain commit gate reads live decided flags). Admitted-but-
    unordered slots are re-homed by swap, so callers must use the
    returned slot ids from here on. Returns ``(state, slot_ids, ms,
    report)``."""
    _check_epochs(table, old_epoch, new_epoch)
    removed, added = _removed_added(table, old_epoch, new_epoch)
    _drain_check(state, removed)
    state, slot_ids, _, moves = _rehome_quorum(
        state, slot_ids, table, old_epoch, new_epoch, removed)
    ms, marker_round = append_reconfig_marker(ms)
    report = _report(new_epoch, table, removed, added, moves, marker_round)
    return state, slot_ids, ms, report


def _seal(q, slot_ids, retired, id_stride: int):
    """Compaction of every row at the epoch boundary (no watermark gate):
    the plan, and the compacted quorum window, ids and base."""
    G = slot_ids.shape[0]
    id_base = torch.arange(G, dtype=torch.int32,
                           device=slot_ids.device) * id_stride
    plan = tilesim.compaction_plan(q, retired)
    q, sids, retired, _ = tilesim.compact_and_refill_packed(
        q, slot_ids, retired, id_base, plan=plan)
    return plan, q, sids, retired


def reconfigure_recycled(rs, ms, table: EpochTable, old_epoch: int,
                         new_epoch: int, *, id_stride: int):
    """Epoch switch for the recycled engine (``RecycleState``).

    Removed rows are drained (checked), then every row is compacted in
    one pass: removed rows **seal** (afterwards ``retired[g] ==
    next_instance[g]``) and kept rows retire their decided prefix too,
    freeing unadmitted slots to receive re-homed ids. A flip with an
    identical active set skips all of this and is an exact engine-state
    no-op. Returns ``(rs, ms, report)``; ``report["sealed_retired"]``
    maps each removed row to its base offset after the seal."""
    _check_epochs(table, old_epoch, new_epoch)
    removed, added = _removed_added(table, old_epoch, new_epoch)
    _drain_check(rs.q, removed)
    if removed or added:
        _, q, sids, retired = _seal(rs.q, rs.slot_ids, rs.retired,
                                    id_stride)
        rs = RecycleState(q=q, slot_ids=sids, retired=retired)
        _check_sealed(rs, removed)
    q, sids, _, moves = _rehome_quorum(rs.q, rs.slot_ids, table, old_epoch,
                                       new_epoch, removed)
    rs = RecycleState(q=q, slot_ids=sids, retired=rs.retired)
    ms, marker_round = append_reconfig_marker(ms)
    report = _report(new_epoch, table, removed, added, moves, marker_round)
    retired = rs.retired.cpu().numpy()
    report["sealed_retired"] = {g: int(retired[g]) for g in removed}
    return rs, ms, report


def reconfigure_gated_recycled(gs, ms, table: EpochTable, old_epoch: int,
                               new_epoch: int, *, id_stride: int,
                               fresh_stable: bool = False):
    """Epoch switch for the gated recycled engine (``GatedRecycleState``).

    :func:`reconfigure_recycled` with the dissemination window moved in
    lockstep: one shared compaction plan per row moves both windows, and
    a re-homed slot carries its hold bitset and stability flag to its new
    owner. ``fresh_stable`` seeds freed slots, as in recycling. Returns
    ``(gs, ms, report)``."""
    _check_epochs(table, old_epoch, new_epoch)
    removed, added = _removed_added(table, old_epoch, new_epoch)
    _drain_check(gs.rs.q, removed)
    if removed or added:
        plan, q, sids, retired = _seal(gs.rs.q, gs.rs.slot_ids,
                                       gs.rs.retired, id_stride)
        gs = GatedRecycleState(
            rs=RecycleState(q=q, slot_ids=sids, retired=retired),
            d=DissemState(
                hold_bits=tilesim.apply_compaction(plan, gs.d.hold_bits, 0),
                stable=tilesim.apply_compaction(plan, gs.d.stable,
                                                fresh_stable)))
        _check_sealed(gs.rs, removed)
    q, sids, d, moves = _rehome_quorum(gs.rs.q, gs.rs.slot_ids, table,
                                       old_epoch, new_epoch, removed, gs.d)
    gs = GatedRecycleState(
        rs=RecycleState(q=q, slot_ids=sids, retired=gs.rs.retired), d=d)
    ms, marker_round = append_reconfig_marker(ms)
    report = _report(new_epoch, table, removed, added, moves, marker_round)
    retired = gs.rs.retired.cpu().numpy()
    report["sealed_retired"] = {g: int(retired[g]) for g in removed}
    return gs, ms, report


def _check_sealed(rs, removed) -> None:
    """Seal postcondition: a drained, compacted removed row holds no
    ordered slot and its base covers every instance it ever assigned
    (cannot fail after ``_drain_check``)."""
    inst = rs.q.instance.cpu().numpy()
    retired = rs.retired.cpu().numpy()
    nxt = rs.q.next_instance.cpu().numpy()
    for g in removed:
        assert not (inst[g] >= 0).any(), \
            f"seal left ordered slots in removed group {g}"
        assert int(retired[g]) == int(nxt[g]), \
            f"seal of group {g} retired {int(retired[g])} < {int(nxt[g])}"


def _report(new_epoch, table, removed, added, moves, marker_round) -> dict:
    return {
        "epoch": int(new_epoch),
        "active": table.active[new_epoch],
        "removed": tuple(removed),
        "added": tuple(added),
        "moved": len(moves),
        "moves": tuple(moves),
        "marker_round": int(marker_round),
    }
