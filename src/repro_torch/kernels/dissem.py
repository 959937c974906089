"""Stability kernel: the quorum pass over hold bitsets plus the per-group
newly-stable count.

The HT-Paxos dissemination layer's predicate (§4.1 steps 15–20): a batch
id is stable once a majority of its group's disseminator partition holds
the batch. Over a window of W in-flight ids per group:

    new_bits = hold_bits | update            (bitsets [G, W, WORDS])
    counts   = Σ_words popcount(new_bits)
    stable'  = stable | (counts >= majority)
    newly[g] = Σ_w (stable' & ~stable)

On a CUDA tensor the wrapper launches ``csrc/dissem.cu``, which writes
``newly`` once from a cluster reduction, so a call is one device op; on a
CPU tensor it runs the plain PyTorch version beside it; any other device
raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from .quorum import (check_tiles, dispatch_device, launch,
                     quorum_update_grouped_plain, tile_plan)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("dissem.cu", "stability_update_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _P])


def stability_update_grouped_plain(bits, update, stable, *, majority: int,
                                   inplace: bool = False):
    """Plain PyTorch version of the kernel, same contract."""
    new, counts, now = quorum_update_grouped_plain(
        bits, update, stable, majority=majority, inplace=inplace)
    newly = (now & ~stable).sum(dim=1, dtype=torch.int32)
    return new, counts, now, newly


def stability_update_grouped(bits: torch.Tensor, update: torch.Tensor,
                             stable: torch.Tensor, *, majority: int,
                             inplace: bool = False):
    """bits/update int32[G, W, WORDS], stable bool[G, W] →
    (new_bits, counts int32[G, W], new_stable bool[G, W],
    newly int32[G] — ids crossing the majority threshold this call).

    ``inplace=True`` writes ``new_bits`` into ``bits``."""
    check_tiles(bits, update, stable, 3)
    if not bits.is_cuda:
        dispatch_device(bits)              # raises unless on the CPU
        return stability_update_grouped_plain(bits, update, stable,
                                              majority=majority,
                                              inplace=inplace)
    new = bits if inplace else torch.empty_like(bits)
    counts = torch.empty_like(stable, dtype=torch.int32)
    new_stable = torch.empty_like(stable)
    G, W, words = bits.shape
    newly = torch.empty((G,), dtype=torch.int32, device=bits.device)
    pb, pu, pn, plan = tile_plan(bits, update, new, clustered=True)
    launch(KERNEL, bits.get_device(), pb, pu, stable.data_ptr(), pn,
           counts.data_ptr(), new_stable.data_ptr(), newly.data_ptr(), G, W,
           words, int(majority), plan.vec, plan.lanes.bit_length() - 1,
           plan.cluster)
    return new, counts, new_stable, newly
