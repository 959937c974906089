"""The model layers' kernel entry points.

Each dispatches on the device of the tensors it is given: a CUDA tensor
launches the hand-written kernel, a CPU tensor runs its plain version
(the counterpart of ``repro.kernels.ops``, which dispatches on the
backend instead). Both are differentiable through autograd functions
whose backward is the backward kernel on the card and its plain version
on the CPU: attention through ``FlashAttention``, WKV6 through ``WKV6``
(deterministic on the card: no atomics, a fixed summation order).
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .rwkv6_scan import wkv6_chunked


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = -1) -> torch.Tensor:
    """q [B,Sq,H,h], k/v [B,Skv,K,h|hv] → [B,Sq,H,hv] in q's dtype."""
    return flash_attention(q, k, v, causal=causal, window=window)


def wkv6(r, k, v, wlog, u, *, chunk: int = 128) -> torch.Tensor:
    """r/k/v/wlog [B,S,H,hd], u [H,hd] → f32 [B,S,H,hd]."""
    return wkv6_chunked(r, k, v, wlog, u, chunk=chunk)
