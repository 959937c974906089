"""Flash attention kernel: blockwise causal / sliding-window GQA attention
with an online softmax in f32.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention``. q is ``[B, Sq, H, h]``, k/v are ``[B, Skv, K, h|hv]``
with H = K·G; the output is ``[B, Sq, H, hv]`` in q's dtype. On a CUDA
tensor the wrapper launches ``csrc/flash_attention.cu``; on a CPU tensor
it runs the plain version beside it (:func:`flash_attention_plain`);
any other device raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import CudaKernel
from .ref import flash_attention_ref as flash_attention_plain

__all__ = ["KERNEL", "flash_attention", "flash_attention_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("flash_attention.cu", "flash_attention_launch",
                    [_P, _P, _P, _P] + [_I] * 9 + [ctypes.c_float, _I, _P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 128


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q/k/v have the kernel's ranks, GQA shapes, one dtype
    (f32 or bf16) and one device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected rank-4 q/k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, h = q.shape
    _, Skv, K, hk = k.shape
    if (k.shape[0], v.shape[0]) != (B, B) or v.shape[1:3] != (Skv, K) \
            or hk != h or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not GQA shapes")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1) -> torch.Tensor:
    """q [B,Sq,H,h], k [B,Skv,K,h], v [B,Skv,K,hv] → [B,Sq,H,hv] in q's
    dtype. Query i and key j sit at positions i and j; causal masks j > i,
    a window w > 0 masks j <= i - w."""
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    B, Sq, H, h = q.shape
    Skv, K, hv = k.shape[1], k.shape[2], v.shape[-1]
    if h > MAX_HEAD or hv > MAX_HEAD:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD}, got "
                         f"h={h}, hv={hv}")
    if Skv == 0:
        raise ValueError("no keys to attend to")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty((B, Sq, H, hv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, Sq, Skv, H, K, h, hv, int(causal),
                      int(window), 1.0 / math.sqrt(h), DTYPES[q.dtype],
                      torch.cuda.current_stream().cuda_stream)
    return out
