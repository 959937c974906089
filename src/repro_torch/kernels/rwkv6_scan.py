"""WKV6 kernel: the chunked RWKV6 time-mix recurrence with an f32
``[hd, hd]`` state per (batch, head).

Replaces the Pallas TPU kernel ``repro.kernels.rwkv6_scan.wkv6_chunked``.
r/k/v are ``[B, S, H, hd]`` (f32 or bf16), wlog is the f32 log decay of
the same shape, u is the ``[H, hd]`` bonus; the output is f32
``[B, S, H, hd]`` (before the gate). On a CUDA tensor the wrapper
launches ``csrc/wkv6.cu``, which picks its own chunk length; on a CPU
tensor it runs the plain chunked version beside it
(:func:`wkv6_chunked_plain`) with the given ``chunk``. Both use the
overflow-free pairwise intra-chunk decay, so they stay finite where the
reference's factorised form gives NaN. Any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from .ref import wkv6_chunked_ref as wkv6_chunked_plain

__all__ = ["KERNEL", "wkv6_chunked", "wkv6_chunked_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("wkv6.cu", "wkv6_launch",
                    [_P] * 6 + [_I] * 5 + [_P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 128


def check_inputs(r, k, v, wlog, u) -> None:
    """Raise unless r/k/v/wlog share one rank-4 shape, r/k/v one dtype
    (f32 or bf16), wlog and u are f32, u is [H, hd], all on one device."""
    if r.dim() != 4 or not r.shape == k.shape == v.shape == wlog.shape:
        raise ValueError(f"r/k/v/wlog must share one [B,S,H,hd] shape, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(wlog.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"u must be [H, hd] = {tuple(r.shape[2:])}, got "
                         f"{tuple(u.shape)}")
    if not r.dtype == k.dtype == v.dtype or r.dtype not in DTYPES:
        raise TypeError(f"r/k/v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if wlog.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wlog and u must be float32, got {wlog.dtype}, "
                        f"{u.dtype}")
    devices = {t.device for t in (r, k, v, wlog, u)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no wkv6 path for device {r.device}")


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 wlog: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """r/k/v/wlog [B,S,H,hd], u [H,hd] → f32 [B,S,H,hd] WKV output.
    ``chunk`` sets the plain version's chunk length; the result does not
    depend on it beyond f32 rounding."""
    check_inputs(r, k, v, wlog, u)
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, wlog, u, chunk=chunk)
    B, S, H, hd = r.shape
    if hd > MAX_HEAD:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD}, "
                         f"got {hd}")
    if not all(t.is_contiguous() for t in (r, k, v, wlog, u)):
        raise ValueError("r, k, v, wlog and u must be contiguous")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      wlog.data_ptr(), u.data_ptr(), out.data_ptr(), B, S, H,
                      hd, DTYPES[r.dtype],
                      torch.cuda.current_stream().cuda_stream)
    return out
