"""Vectorized sharded dissemination & stability engine.

HT-Paxos decouples dissemination (bulk payload replication plus stability
acknowledgements, §4.1 steps 13–20) from ordering. This module is the
dissemination half in the packed-bitset idiom of ``core.tilesim``: a
window of W in-flight batch ids per ordering group, each with a hold
bitset recording which disseminators of the group's partition hold the
batch. An id is **stable**, and may be ordered, once a majority of its
partition holds its batch.

The absorb/stabilize pass is one launch of the stability kernel
(``repro_torch.kernels.dissem``) on a CUDA tensor, its plain version on a
CPU tensor. The gated engine families (``engine.sharded``) thread this
state so a slot's phase-2b votes only absorb once its id is stable.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.tilesim import _words, pack_tile
from ..device import resolve_device
from ..kernels.dissem import stability_update_grouped


class DissemState(NamedTuple):
    """Per-group dissemination window: who holds each in-flight batch.
    Slot (g, w) tracks the same id as the ordering engine's slot (g, w)
    when the two run side by side."""
    hold_bits: torch.Tensor  # int32[G, W, WORDS_D] disseminators holding
    stable: torch.Tensor     # bool[G, W] majority of the partition holds


def init_dissem(groups: int, window: int, n_diss: int, *,
                pre_stable: bool = False, device=None) -> DissemState:
    """Fresh dissemination window. ``n_diss`` is the partition size;
    ``pre_stable=True`` marks every slot stable (which makes the gated
    ordering engine bit-identical to the ungated one)."""
    dev = resolve_device(device)
    return DissemState(
        hold_bits=torch.zeros((groups, window, _words(n_diss)),
                              dtype=torch.int32, device=dev),
        stable=torch.full((groups, window), pre_stable, dtype=torch.bool,
                          device=dev),
    )


def absorb_holds_packed(state: DissemState, packed: torch.Tensor,
                        majority: int, *, inplace: bool = False)\
        -> tuple[DissemState, dict]:
    """OR a packed hold tile int32[G, W, WORDS_D] into the window and
    refresh stability (one stability kernel launch). Returns (state, out)
    with out["counts"] int32[G, W] holder counts, out["newly_stable"]
    bool[G, W] ids crossing the majority this call, and
    out["newly_per_group"] int32[G] their count per group."""
    bits, counts, stable, newly = stability_update_grouped(
        state.hold_bits, packed, state.stable, majority=majority,
        inplace=inplace)
    return (DissemState(hold_bits=bits, stable=stable),
            {"counts": counts, "newly_stable": stable & ~state.stable,
             "newly_per_group": newly})


def stability_tick(state: DissemState, packed: torch.Tensor, *,
                   majority: int) -> tuple[DissemState, dict]:
    """One absorb/stabilize pass (the reference's jitted entry point)."""
    return absorb_holds_packed(state, packed, majority)


def stability_tick_dense(state: DissemState, holds: torch.Tensor, *,
                         majority: int) -> tuple[DissemState, dict]:
    """Bool-tile form of :func:`stability_tick`: holds bool[G, W, D],
    packed with ``tilesim.pack_tile`` (one stability kernel launch on a
    CUDA tensor)."""
    return absorb_holds_packed(state, pack_tile(holds), majority)


def run_stability_ticks(state: DissemState, packed_seq: torch.Tensor, *,
                        majority: int) -> tuple[DissemState, dict]:
    """T ticks of int32[T, G, W, WORDS_D] hold traffic. The stacked
    out["newly_stable"] bool[T, G, W] is the stability schedule."""
    outs = []
    for packed in packed_seq:
        state, out = absorb_holds_packed(state, packed, majority)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def unpack_tile(packed: torch.Tensor, n: int) -> torch.Tensor:
    """int32[..., WORDS] → bool[..., n] (inverse of ``tilesim.pack_tile``).
    Arithmetic shift of a word with bit 31 set fills the high bits with
    ones, but ``& 1`` keeps only bit k of the shifted word."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32)
    return flat[..., :n].to(torch.bool)


def stable_ids(state: DissemState, slot_ids: torch.Tensor) -> torch.Tensor:
    """Global ids of stable slots: int32[G, W], -1 at unstable slots."""
    return torch.where(state.stable, slot_ids.to(torch.int32), -1)


def dissem_admitted_mask(state: DissemState) -> torch.Tensor:
    """bool[G, W]: slots with any dissemination state — a recorded holder
    or an already-stable flag."""
    return (state.hold_bits != 0).any(dim=-1) | state.stable


def unstable_backlog(state: DissemState) -> torch.Tensor:
    """int32[G]: admitted-but-not-yet-stable slots per group."""
    return (dissem_admitted_mask(state) & ~state.stable).sum(
        dim=-1, dtype=torch.int32)
