"""WKV6 kernel: the chunked RWKV6 time-mix recurrence with an f32
``[hd, hd]`` state per (batch, head).

Replaces the Pallas TPU kernel ``repro.kernels.rwkv6_scan.wkv6_chunked``.
r/k/v are ``[B, S, H, hd]`` (f32 or bf16), wlog is the f32 log decay of
the same shape, u is the ``[H, hd]`` bonus; the output is f32
``[B, S, H, hd]`` (before the gate).

On a CUDA tensor the wrapper makes one call of ``csrc/wkv6.cu``'s
launcher, which runs the scan split over the sequence in chunks of
:data:`CHUNK` tokens: a chunk-state pass (each chunk's own state
contribution and decay, one block per chunk, head and batch), a state
scan over the chunks (one thread per state element), and an output pass
(one block per chunk, head and batch). The chunk states go through a
workspace of :func:`workspace_floats` f32 values that the wrapper
allocates with ``torch.empty`` on the inputs' device. On a CPU tensor it
runs the plain chunked version beside it (:func:`wkv6_chunked_plain`)
with the given ``chunk``. Both keep every decay exponent at or below
zero, so they stay finite where the reference's factorised form gives
NaN. Any other device raises.

Training: on a CPU tensor autograd differentiates the plain version. On a
CUDA tensor the call goes through :class:`WKV6`, whose backward raises
``NotImplementedError``: there is no WKV6 backward kernel yet (ROADMAP.md
queue 2, "WKV6 backward kernel"), and the kernel's output would otherwise
leave the autograd graph and train with missing gradients. Nothing falls
back to the plain version on the card.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from .ref import wkv6_chunked_ref as wkv6_chunked_plain

__all__ = ["CHUNK", "KERNEL", "WKV6", "wkv6_chunked", "wkv6_chunked_plain",
           "workspace_floats"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("wkv6.cu", "wkv6_launch",
                    [_P] * 7 + [_I] * 5 + [_P])
CHUNK = 32          # tokens per chunk of the kernel (kC in csrc/wkv6.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 128


def workspace_floats(B: int, S: int, H: int, hd: int) -> int:
    """f32 values of the kernel's workspace: one [W, W] state and its [W]
    decay per (batch, head) and chunk but the last, W the padded head
    width the kernel runs hd at (32, 64 or 128)."""
    w = 32 if hd <= 32 else 64 if hd <= 64 else 128
    return B * H * max(-(-S // CHUNK) - 1, 0) * w * (w + 1)


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


def _forward(r, k, v, wlog, u) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; no autograd."""
    B, S, H, hd = r.shape
    if hd > MAX_HEAD:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD}, "
                         f"got {hd}")
    if not all(t.is_contiguous() for t in (r, k, v, wlog, u)):
        raise ValueError("r, k, v, wlog and u must be contiguous")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    ws = torch.empty((workspace_floats(B, S, H, hd),), dtype=torch.float32,
                     device=r.device)
    with torch.cuda.device(r.device):
        KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      wlog.data_ptr(), u.data_ptr(), out.data_ptr(),
                      ws.data_ptr(), B, S, H, hd, DTYPES[r.dtype],
                      torch.cuda.current_stream().cuda_stream)
    return out


class WKV6(torch.autograd.Function):
    """The kernel's forward on CUDA tensors; its backward raises, since
    the WKV6 backward kernel does not exist yet."""

    @staticmethod
    def forward(ctx, r, k, v, wlog, u):
        return _forward(r, k, v, wlog, u)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "no WKV6 backward kernel yet: RWKV6 does not train on the CUDA "
            "card (ROADMAP.md queue 2, \"WKV6 backward kernel\"); train it "
            "on the CPU, where autograd differentiates the plain version")


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 wlog: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """r/k/v/wlog [B,S,H,hd], u [H,hd] → f32 [B,S,H,hd] WKV output.
    ``chunk`` sets the plain version's chunk length; the result does not
    depend on it beyond f32 rounding."""
    check_inputs(r, k, v, wlog, u)
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, wlog, u, chunk=chunk)
    return WKV6.apply(r, k, v, wlog, u)
