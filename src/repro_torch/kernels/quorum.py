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
import math

import torch

from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("quorum.cu", "quorum_update_launch",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P])


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
    if dispatch_device(bits) == "cpu":
        return quorum_update_grouped_plain(bits, update, stable,
                                           majority=majority,
                                           inplace=inplace)
    G, W, words = bits.shape
    new = bits if inplace else torch.empty_like(bits)
    counts = torch.empty((G, W), dtype=torch.int32, device=bits.device)
    new_stable = torch.empty((G, W), dtype=torch.bool, device=bits.device)
    with torch.cuda.device(bits.device):
        KERNEL.launch(bits.data_ptr(), update.data_ptr(), stable.data_ptr(),
                      new.data_ptr(), counts.data_ptr(),
                      new_stable.data_ptr(), G * W, words, int(majority),
                      torch.cuda.current_stream().cuda_stream)
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
