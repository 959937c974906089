"""WKV6 kernel: the chunked RWKV6 time-mix recurrence with an f32
``[hd, hd]`` state per (batch, head), and its backward kernel.

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

Training: :func:`wkv6_chunked` runs :class:`WKV6`, an autograd function
on both devices. On a CUDA tensor its forward keeps the forward kernel's
workspace, which holds the state entering every chunk but the first, and
its backward is one call of :func:`wkv6_bwd`: ``csrc/wkv6_bwd.cu``'s
launcher (:data:`KERNEL_BWD`), four CUDA kernels in chunks of
:data:`CHUNK` (each chunk's contribution to the gradient of the state
entering it, a reverse scan of those over the chunks, the gradients of
each chunk's inputs from its entering state and the gradient of its
leaving state, and ``du`` summed over the chunks' partials in a fixed
order). No float atomics and a fixed summation order: two calls on the
same inputs give the same bytes, so replicas that train on one log stay
bitwise equal. On a CPU tensor the backward runs
:func:`wkv6_chunked_bwd_plain` at the forward's ``chunk``: the same
function from explicit formulas in plain PyTorch, not the kernel's
arithmetic (which factors the intra-chunk decay on two levels, forms the
chunk-end term from the entering state, and takes its state products in
split TF32; ``tests/test_torch_wkv6_bwd.py`` emulates it). Neither takes
autograd through the plain forward, and nothing falls back to it on the
card. The JAX package has no backward kernel: it takes ``jax.grad``
through its jnp chunked form, whose gradient overflows where its forward
does.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from .ref import wkv6_chunked_bwd_plain
from .ref import wkv6_chunked_ref as wkv6_chunked_plain

__all__ = ["CHUNK", "KERNEL", "KERNEL_BWD", "WKV6", "bwd_workspace_floats",
           "padded_width", "wkv6_bwd", "wkv6_chunked",
           "wkv6_chunked_bwd_plain", "wkv6_chunked_plain", "wkv6_fwd",
           "workspace_floats"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("wkv6.cu", "wkv6_launch",
                    [_P] * 7 + [_I] * 5 + [_P])
# r, k, v, wlog, u, dout, the forward's workspace; dr, dk, dv, dwlog, du;
# workspace; B, S, H, hd, dtype; stream
KERNEL_BWD = CudaKernel("wkv6_bwd.cu", "wkv6_bwd_launch",
                        [_P] * 13 + [_I] * 5 + [_P])
CHUNK = 32          # tokens per chunk of the kernel (kC in csrc/wkv6.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 128


def padded_width(hd: int) -> int:
    """The head width W the kernels run hd at: 32, 64 or 128."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def workspace_floats(B: int, S: int, H: int, hd: int) -> int:
    """f32 values of the kernel's workspace: one [W, W] state and its [W]
    decay per (batch, head) and chunk but the last, W =
    :func:`padded_width` (hd)."""
    w = padded_width(hd)
    return B * H * max(-(-S // CHUNK) - 1, 0) * w * (w + 1)


def bwd_workspace_floats(B: int, S: int, H: int, hd: int) -> int:
    """f32 values of the backward kernel's workspace: the gradient of the
    state leaving every chunk but the last and the decay of the chunk
    after it (laid out as the forward's workspace), then one [W] partial
    of du per (batch, chunk, head)."""
    return (workspace_floats(B, S, H, hd)
            + B * -(-S // CHUNK) * H * padded_width(hd))


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


def _check_kernel_inputs(hd: int, **tensors) -> None:
    """Raise unless the kernels take head dim hd and every tensor is
    contiguous."""
    if hd > MAX_HEAD:
        raise ValueError(f"the kernels take head dims up to {MAX_HEAD}, "
                         f"got {hd}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def wkv6_fwd(r, k, v, wlog, u) -> tuple:
    """One launch of the forward kernel on CUDA tensors; no autograd.
    Returns the output and the workspace, which then holds the state
    entering every chunk but the first (what :func:`wkv6_bwd` takes)."""
    B, S, H, hd = r.shape
    _check_kernel_inputs(hd, r=r, k=k, v=v, wlog=wlog, u=u)
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    ws = torch.empty((workspace_floats(B, S, H, hd),), dtype=torch.float32,
                     device=r.device)
    with torch.cuda.device(r.device):
        KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      wlog.data_ptr(), u.data_ptr(), out.data_ptr(),
                      ws.data_ptr(), B, S, H, hd, DTYPES[r.dtype],
                      torch.cuda.current_stream().cuda_stream)
    return out, ws


def wkv6_bwd(r, k, v, wlog, u, dout, states) -> tuple:
    """One launch of the backward kernel on CUDA tensors: the gradient of
    the WKV6 output at (r, k, v, wlog, u) for its gradient ``dout`` (f32,
    contiguous, r's shape), given ``states``, the forward kernel's
    workspace after its call on the same inputs. Returns (dr, dk, dv) in
    r's dtype, dwlog f32 and du f32 [H, hd]; raises on what the kernel
    does not take."""
    check_inputs(r, k, v, wlog, u)
    B, S, H, hd = r.shape
    if r.device.type != "cuda":
        raise ValueError(f"the backward kernel runs on a CUDA device, not "
                         f"{r.device}")
    if tuple(dout.shape) != tuple(r.shape) or dout.dtype != torch.float32 \
            or dout.device != r.device:
        raise ValueError(f"dout must be float32 {tuple(r.shape)} on "
                         f"{r.device}, got {dout.dtype} {tuple(dout.shape)} "
                         f"on {dout.device}")
    _check_kernel_inputs(hd, r=r, k=k, v=v, wlog=wlog, u=u, dout=dout)
    if states.dtype != torch.float32 or states.device != r.device \
            or states.numel() != workspace_floats(B, S, H, hd) \
            or not states.is_contiguous():
        raise ValueError("states must be the forward's contiguous float32 "
                         f"workspace of {workspace_floats(B, S, H, hd)} "
                         f"values on {r.device}")
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dwlog = torch.empty_like(wlog)
    du = torch.empty_like(u)
    ws = torch.empty((bwd_workspace_floats(B, S, H, hd),),
                     dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        KERNEL_BWD.launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
            u.data_ptr(), dout.data_ptr(), states.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dwlog.data_ptr(), du.data_ptr(),
            ws.data_ptr(), B, S, H, hd, DTYPES[r.dtype],
            torch.cuda.current_stream().cuda_stream)
    return dr, dk, dv, dwlog, du


class WKV6(torch.autograd.Function):
    """WKV6 on both devices: on a CUDA tensor the forward kernel, keeping
    its workspace (the chunks' entering states) for the backward kernel;
    on a CPU tensor the plain chunked version at ``chunk``, whose backward
    is :func:`wkv6_chunked_bwd_plain` at the same ``chunk``."""

    @staticmethod
    def forward(ctx, r, k, v, wlog, u, chunk: int):
        if r.device.type == "cpu":
            out = wkv6_chunked_plain(r, k, v, wlog, u, chunk=chunk)
            states = out.new_empty((0,))
        else:
            out, states = wkv6_fwd(r, k, v, wlog, u)
        ctx.save_for_backward(r, k, v, wlog, u, states)
        ctx.chunk = chunk
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        r, k, v, wlog, u, states = ctx.saved_tensors
        if r.device.type == "cpu":
            grads = wkv6_chunked_bwd_plain(r, k, v, wlog, u, dout,
                                           chunk=ctx.chunk)
        else:
            grads = wkv6_bwd(r, k, v, wlog, u, dout.contiguous(), states)
        return (*grads, None)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 wlog: torch.Tensor, u: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """r/k/v/wlog [B,S,H,hd], u [H,hd] → f32 [B,S,H,hd] WKV output.
    ``chunk`` sets the plain version's chunk length on the CPU; the result
    does not depend on it beyond f32 rounding. Differentiable: it runs
    :class:`WKV6`."""
    check_inputs(r, k, v, wlog, u)
    return WKV6.apply(r, k, v, wlog, u, chunk)
