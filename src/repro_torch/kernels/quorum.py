"""Quorum kernel: fused ack-bitset OR + popcount + majority threshold.

The HT-Paxos sequencer hot path (§4.1 step 36) over a window of W
in-flight ids per ordering group:

    new_bits = bits | update          (bitsets [G, W, WORDS])
    counts   = Σ_words popcount(new_bits)
    stable  |= counts >= majority

Bitsets are ``torch.int32`` tensors holding the bits of the reference's
``uint32`` words. On a CUDA tensor the wrapper launches the hand-written
kernel in ``csrc/quorum.cu``; on a CPU tensor it runs the plain PyTorch
version beside it. Any other device raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("quorum.cu", "quorum_update_launch",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
THREADS = 256        # threads a block, as csrc/quorum.cu and dissem.cu
MAX_CLUSTER = 8      # blocks a cluster, the portable limit


class LaunchPlan(NamedTuple):
    """How the row-pass kernels (``csrc/quorum.cu``, ``csrc/dissem.cu``)
    cover a ``[G, W, WORDS]`` tile."""
    vec: int             # words a load: 4 (16 bytes) or 1
    lanes: int           # lanes a row, a power of two <= 32
    rows_per_block: int  # THREADS // lanes
    cluster: int         # blocks a group (stability kernel); 1 for quorum
    grid: int            # blocks in all


@functools.lru_cache(maxsize=1024)
def launch_plan(groups: int, window: int, words: int, aligned: bool, *,
                clustered: bool) -> LaunchPlan:
    """The lane mapping of a tile: 16-byte loads where ``words % 4 == 0``
    and every bitset pointer is ``aligned`` to 16 bytes, the smallest
    power-of-two segment that covers a row's vectors (at most a warp).
    Unclustered (quorum): one grid over all G*W rows. Clustered
    (stability): one cluster of ``cluster`` blocks per group, the power of
    two >= the group's row blocks, at most 8. A pure function of its
    arguments, so it is cached."""
    vec = 4 if aligned and words % 4 == 0 else 1
    lanes = min(32, 1 << max(0, -(-words // vec) - 1).bit_length())
    rpb = THREADS // lanes
    if not clustered:
        return LaunchPlan(vec, lanes, rpb, 1, -(-groups * window // rpb))
    blocks = -(-window // rpb)
    cluster = min(MAX_CLUSTER, 1 << max(0, blocks - 1).bit_length())
    return LaunchPlan(vec, lanes, rpb, cluster, groups * cluster)


def tile_plan(bits: torch.Tensor, update: torch.Tensor, new: torch.Tensor,
              *, clustered: bool):
    """``(bits, update, new)``'s data pointers and the launch plan of the
    ``[G, W, WORDS]`` tile: 16-byte loads only if all three pointers are
    16-byte aligned (a view with a storage offset may not be)."""
    pb, pu, pn = bits.data_ptr(), update.data_ptr(), new.data_ptr()
    G, W, words = bits.shape
    return pb, pu, pn, launch_plan(G, W, words, not (pb | pu | pn) & 15,
                                   clustered=clustered)


def launch(kernel: CudaKernel, dev: int, *args) -> None:
    """``kernel.launch(*args, stream)`` on CUDA device ``dev`` and its
    current stream; the device guard is entered only when ``dev`` is not
    the current device."""
    if dev == torch.cuda.current_device():
        kernel.launch(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            kernel.launch(*args, torch._C._cuda_getCurrentRawStream(dev))


def popcount_rows(bits: torch.Tensor) -> torch.Tensor:
    """int32[..., WORDS] bitsets → int32[...] set bits per row.

    SWAR popcount on the words widened to int64 and masked to their low
    32 bits, so a word with bit 31 set (a negative int32) counts right."""
    v = bits.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.sum(dim=-1, dtype=torch.int32)


def check_tiles(bits: torch.Tensor, update: torch.Tensor,
                stable: torch.Tensor, rank: int) -> None:
    """Raise unless ``bits``/``update`` are contiguous int32 of one
    rank-``rank`` shape and ``stable`` is contiguous bool of its leading
    shape, all on one device."""
    if bits.dtype != torch.int32 or update.dtype != torch.int32:
        raise TypeError(f"bitsets must be torch.int32, got {bits.dtype} "
                        f"and {update.dtype}")
    if stable.dtype != torch.bool:
        raise TypeError(f"stable must be torch.bool, got {stable.dtype}")
    if bits.dim() != rank or update.shape != bits.shape \
            or stable.shape != bits.shape[:-1]:
        raise ValueError(
            f"expected bits/update of rank {rank} with equal shapes and "
            f"stable of their leading shape, got {tuple(bits.shape)}, "
            f"{tuple(update.shape)}, {tuple(stable.shape)}")
    if not bits.device == update.device == stable.device:
        raise ValueError(f"tensors on different devices: {bits.device}, "
                         f"{update.device}, {stable.device}")
    if not (bits.is_contiguous() and update.is_contiguous()
            and stable.is_contiguous()):
        raise ValueError("bits, update and stable must be contiguous")
    if math.prod(bits.shape[:-1]) >= 2**31:
        raise ValueError("more than 2**31 - 1 window rows")


def dispatch_device(t: torch.Tensor) -> str:
    """``"cpu"`` (plain version) or ``"cuda"`` (kernel); raises on any
    other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no quorum path for device {t.device}")
    return t.device.type


def quorum_update_grouped_plain(bits, update, stable, *, majority: int,
                                inplace: bool = False):
    """Plain PyTorch version of the kernel, same contract."""
    new = torch.bitwise_or(bits, update, out=bits if inplace else None)
    counts = popcount_rows(new)
    return new, counts, stable | (counts >= majority)


def quorum_update_grouped(bits: torch.Tensor, update: torch.Tensor,
                          stable: torch.Tensor, *, majority: int,
                          inplace: bool = False):
    """bits/update int32[G, W, WORDS], stable bool[G, W] →
    (new_bits int32[G, W, WORDS], counts int32[G, W],
    new_stable bool[G, W]).

    ``inplace=True`` writes ``new_bits`` into ``bits`` (the counterpart of
    the reference's buffer donation); ``new_stable`` is always fresh."""
    check_tiles(bits, update, stable, 3)
    if not bits.is_cuda:
        dispatch_device(bits)              # raises unless on the CPU
        return quorum_update_grouped_plain(bits, update, stable,
                                           majority=majority,
                                           inplace=inplace)
    new = bits if inplace else torch.empty_like(bits)
    counts = torch.empty_like(stable, dtype=torch.int32)
    new_stable = torch.empty_like(stable)
    pb, pu, pn, plan = tile_plan(bits, update, new, clustered=False)
    G, W, words = bits.shape
    launch(KERNEL, bits.get_device(), pb, pu, stable.data_ptr(), pn,
           counts.data_ptr(), new_stable.data_ptr(), G * W, words,
           int(majority), plan.vec, plan.lanes.bit_length() - 1, plan.grid)
    return new, counts, new_stable


def quorum_update(bits: torch.Tensor, update: torch.Tensor,
                  stable: torch.Tensor, *, majority: int,
                  inplace: bool = False):
    """Single-group form: bits/update int32[W, WORDS], stable bool[W] —
    a G = 1 launch of :func:`quorum_update_grouped`."""
    check_tiles(bits, update, stable, 2)
    new, counts, new_stable = quorum_update_grouped(
        bits[None], update[None], stable[None], majority=majority,
        inplace=inplace)
    return new[0], counts[0], new_stable[0]
