"""Flash attention kernels: blockwise causal / sliding-window GQA
attention with an online softmax in f32.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention``. q is ``[B, Sq, H, h]``, k/v are ``[B, Skv, K, h|hv]``
with H = K·G; the output is ``[B, Sq, H, hv]`` in q's dtype. The wrapper
dispatches on the device, then on the dtype:

- a bf16 CUDA tensor launches ``csrc/flash_attention_bf16.cu``
  (:data:`KERNEL_BF16`, the tensor cores; h up to 192 and hv up to 128,
  both multiples of 16, anything else raises);
- an f32 CUDA tensor launches ``csrc/flash_attention.cu``
  (:data:`KERNEL`, the CUDA cores: the f32 check path, which TF32 tensor
  cores would not keep within its tolerances). Any h <= 192 and hv <=
  128, and it copies its tiles with 16-byte ``cp.async`` where h and hv
  are multiples of 4 and every pointer is 16-byte aligned, else with
  4-byte copies into the same layout (:func:`f32_plan`);
- a CPU tensor runs the plain version (:func:`flash_attention_plain`) at
  any width; any other device raises.

Every kernel is instantiated at a padded q/k width and a padded v width
(:func:`padded_widths`): one width D of 32, 64 or 128 that holds both h
and hv, or q/k width 192 with v width 128 where 128 < h <= 192 and hv <=
128 (deepseek-v3's MLA prefill: h = 128 + 64, hv = 128). Padding is
zero-filled; an h above 192 or an hv above 128 raises.

:func:`flash_attention` is a ``torch.autograd.Function``
(:class:`FlashAttention`): its backward is :func:`flash_attention_bwd`,
which dispatches the same way (:func:`select_bwd_kernel`):

- a bf16 CUDA tensor launches ``csrc/flash_attention_bwd_bf16.cu``
  (:data:`KERNEL_BWD_BF16`, the tensor cores). It takes the forward's
  log2-domain log-sum-exp of each query row, which the bf16 forward
  writes when an input needs a gradient (:func:`flash_attention_fwd_lse`
  returns it too); without it the backward raises, it never recomputes
  it. The same head widths as the bf16 forward;
- an f32 CUDA tensor launches ``csrc/flash_attention_bwd.cu``
  (:data:`KERNEL_BWD`, f32 arithmetic on the CUDA cores; any h <= 192,
  hv <= 128, 16- or 4-byte copies as :func:`f32_plan` chooses). It takes
  the f32 forward's log-sum-exp the same way and raises without it;
- a CPU tensor runs :func:`flash_attention_bwd_plain`.

Both forward kernels write the LSE (f32 [B,H,Sq], log2 domain) when
:class:`FlashAttention` saves it for a gradient, and not when serving;
the output's bytes are the same either way. Each backward call is one
count, which runs three CUDA kernels (D = do·o, dk/dv, dq; the bf16
route at q/k width 192 runs dk and dv as two kernels, four in all) over
an f32 workspace of :func:`bwd_workspace_floats` values (each row's D).
The JAX package has no backward kernel: it takes ``jax.vjp`` through
``repro.models.layers.flash_attend``. A failed build or launch raises;
nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import CudaKernel
from .ref import flash_attention_bwd_plain
from .ref import flash_attention_lse_plain
from .ref import flash_attention_ref as flash_attention_plain

__all__ = ["KERNEL", "KERNEL_BF16", "KERNEL_BWD", "KERNEL_BWD_BF16",
           "FlashAttention", "bf16_head_width", "bwd_workspace_floats",
           "f32_bwd_tiles", "f32_plan", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd_lse", "flash_attention_lse_plain",
           "flash_attention_plain", "padded_widths", "select_bwd_kernel",
           "select_kernel", "v_width"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P] + [_I] * 9 + [ctypes.c_float]
# ... scale; padded q/k and v widths; copy plan; lse (f32 [B,H,Sq] or
# null); stream
KERNEL = CudaKernel("flash_attention.cu", "flash_attention_lse_launch",
                    _ARGS + [_I, _I, _I, _P, _P])
# ... scale; padded q/k and v widths; lse (f32 [B,H,Sq] or null); stream
KERNEL_BF16 = CudaKernel("flash_attention_bf16.cu",
                         "flash_attention_bf16_launch",
                         _ARGS + [_I, _I, _P, _P])
# q, k, v, o, do, lse, dq, dk, dv, workspace; B, Sq, Skv, H, K, h, hv,
# causal, window; scale; padded q/k and v widths; copy plan; stream
KERNEL_BWD = CudaKernel("flash_attention_bwd.cu",
                        "flash_attention_bwd_launch",
                        [_P] * 10 + [_I] * 9 + [ctypes.c_float, _I, _I, _I,
                                                _P])
# q, k, v, o, do, lse, dq, dk, dv, workspace; the same ints; scale; padded
# q/k and v widths; stream
KERNEL_BWD_BF16 = CudaKernel("flash_attention_bwd_bf16.cu",
                             "flash_attention_bwd_bf16_launch",
                             [_P] * 10 + [_I] * 9 + [ctypes.c_float, _I, _I,
                                                     _P])
MAX_H, MAX_HV = 192, 128   # the widest q/k and v widths any kernel takes
# the padded q/k widths every kernel is built at; each instantiation's v
# width is v_width(width): 32/32, 64/64, 128/128 and 192/128
WIDTHS = (32, 64, 128, 192)
# the f32 kernel's tiling, as csrc/flash_attention.cu: query rows per
# block, keys per K/V tile, threads per block
F32_BLOCK_Q, F32_BLOCK_K, F32_THREADS = 64, 32, 128
# the bf16 backward's tiling, as csrc/flash_attention_bwd_bf16.cu: keys a
# dk/dv block (16 a warp) and query rows a dq block (16 a warp), queries
# or keys an inner step, warps a block
BWD_BLOCK_K, BWD_BLOCK_Q, BWD_HALF, BWD_WARPS = 64, 64, 32, 4
# the f32 backward's tiling, as csrc/flash_attention_bwd.cu: keys a dk/dv
# tile (8 a warp) and query rows a dk/dv step; query rows a dq block (16 a
# warp) and keys a dq K/V tile; warps a block. A causal dk/dv launch gives
# each block key tiles t and n - 1 - t. At q/k width 192 a dk/dv step
# takes 32 query rows and a dq K/V tile 16 keys, so that the tiles fit
# the SM's shared memory
F32_BWD_BLOCK_K, F32_BWD_STEP_Q, F32_BWD_BLOCK_Q, F32_BWD_TILE_K = \
    64, 64, 128, 32
F32_BWD_STEP_Q_192, F32_BWD_TILE_K_192 = 32, 16
F32_BWD_WARPS = 8


def v_width(width: int) -> int:
    """The padded v width of the instantiation at padded q/k width
    ``width``."""
    return min(width, MAX_HV)


def f32_bwd_tiles(width: int) -> tuple[int, int]:
    """``(query rows a dk/dv step, keys a dq K/V tile)`` of the f32
    backward at padded q/k width ``width``."""
    if width > 128:
        return F32_BWD_STEP_Q_192, F32_BWD_TILE_K_192
    return F32_BWD_STEP_Q, F32_BWD_TILE_K


def padded_widths(h: int, hv: int) -> tuple[int, int]:
    """``(q/k width, v width)`` of the instantiation that runs q/k width
    h and v width hv: the least D of 32, 64 and 128 that holds both as
    (D, D), else (192, 128) where 128 < h <= 192 and hv <= 128. Raises
    ValueError for h > 192 or hv > 128."""
    if h < 1 or hv < 1 or h > MAX_H or hv > MAX_HV:
        raise ValueError(f"the flash kernels take q/k widths h up to "
                         f"{MAX_H} and v widths hv up to {MAX_HV}, got "
                         f"h={h}, hv={hv}")
    width = next(w for w in WIDTHS if w >= max(h, hv))
    return width, v_width(width)


def bf16_head_width(h: int, hv: int) -> tuple[int, int]:
    """The padded ``(q/k width, v width)`` the bf16 kernels run q/k width
    h and v width hv at (:func:`padded_widths`). Raises ValueError unless
    h and hv are multiples of 16 with 16 <= h <= 192 and 16 <= hv <=
    128."""
    if h < 16 or hv < 16 or h % 16 or hv % 16 or h > MAX_H or hv > MAX_HV:
        raise ValueError(f"the bf16 kernels take q/k widths h up to "
                         f"{MAX_H} and v widths hv up to {MAX_HV}, both "
                         f"multiples of 16, got h={h}, hv={hv}")
    return padded_widths(h, hv)


def f32_plan(h: int, hv: int, *ptrs: int) -> tuple[int, int, int]:
    """``(width, vwidth, vec)`` of the f32 kernels: the padded q/k and v
    widths that hold h and hv (:func:`padded_widths`), and 1 (16-byte
    copies) where h and hv are multiples of 4 and every pointer in
    ``ptrs`` (the forward's q, k, v, out; the backward's q, k, v, o, do,
    dq, dk, dv) is 16-byte aligned, else 0 (4-byte copies)."""
    width, vwidth = padded_widths(h, hv)
    vec = int(h % 4 == 0 and hv % 4 == 0 and not any(p % 16 for p in ptrs))
    return width, vwidth, vec


def select_kernel(dtype: torch.dtype, h: int, hv: int) -> CudaKernel:
    """The kernel that a CUDA tensor of ``dtype`` launches: bf16 →
    :data:`KERNEL_BF16` (raises for a head width it does not take; never
    the f32 kernel), f32 → :data:`KERNEL` (raises past q/k width 192 or
    v width 128)."""
    if dtype == torch.bfloat16:
        bf16_head_width(h, hv)
        return KERNEL_BF16
    if dtype == torch.float32:
        f32_plan(h, hv)
        return KERNEL
    raise TypeError(f"no attention kernel for {dtype}")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q/k/v have the kernels' ranks, GQA shapes, one dtype
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
    if not q.dtype == k.dtype == v.dtype or \
            q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention path for device {q.device}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: int, lse: bool = False):
    """``(out, lse)``: the forward kernel of q's dtype on a CUDA tensor,
    the plain version on a CPU tensor; no autograd. ``lse`` asks for each
    query row's log2-domain log-sum-exp (f32 [B,H,Sq]), which either
    kernel writes beside its output; else it is None and the kernel is
    given a null pointer."""
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, window=window)
        return out, (flash_attention_lse_plain(q, k, causal=causal,
                                               window=window)
                     if lse else None)
    B, Sq, H, h = q.shape
    Skv, K, hv = k.shape[1], k.shape[2], v.shape[-1]
    kernel = select_kernel(q.dtype, h, hv)
    if Skv == 0:
        raise ValueError("no keys to attend to")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty((B, Sq, H, hv), dtype=q.dtype, device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, K, h, hv, int(causal), int(window), 1.0 / math.sqrt(h)]
    stats = torch.empty((B, H, Sq), dtype=torch.float32,
                        device=q.device) if lse else None
    stats_ptr = stats.data_ptr() if stats is not None else None
    if kernel is KERNEL_BF16:
        if any(x.data_ptr() % 16 for x in (q, k, v)):
            raise ValueError("the bf16 kernel copies 16-byte chunks: q, k "
                             "and v must start on 16-byte boundaries")
        args += [*bf16_head_width(h, hv), stats_ptr]
    else:
        args += [*f32_plan(h, hv, *args[:4]), stats_ptr]
    with torch.cuda.device(q.device):
        kernel.launch(*args, torch.cuda.current_stream().cuda_stream)
    return out, stats


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = -1):
    """``(out, lse)`` with no autograd: the attention output and each
    query row's log2-domain log-sum-exp, f32 [B,H,Sq] (``m + log2 l`` of
    the scaled scores ``s log2(e)/sqrt(h)``, masked ones at -1e30), which
    the backward kernels take as ``lse=``. A CUDA tensor launches the
    forward kernel of its dtype once; a CPU tensor runs the plain
    versions."""
    return _forward(q, k, v, causal=causal, window=window, lse=True)


def bwd_workspace_floats(B: int, Sq: int, H: int) -> int:
    """f32 values of either backward kernel's workspace: each query row's
    D = do . o (both take the forward's log-sum-exp instead of
    recomputing it)."""
    return B * Sq * H


def select_bwd_kernel(dtype: torch.dtype, h: int, hv: int,
                      lse: torch.Tensor | None) -> CudaKernel:
    """The backward kernel that a CUDA tensor of ``dtype`` launches: bf16
    → :data:`KERNEL_BWD_BF16` (raises for a head width the bf16 forward
    does not take), f32 → :data:`KERNEL_BWD` (any h <= 192, hv <= 128).
    Either
    raises without the forward's ``lse``: it is never recomputed and
    nothing falls back."""
    if dtype == torch.bfloat16:
        bf16_head_width(h, hv)
        kernel = KERNEL_BWD_BF16
    elif dtype == torch.float32:
        padded_widths(h, hv)
        kernel = KERNEL_BWD
    else:
        raise TypeError(f"no attention backward kernel for {dtype}")
    if lse is None:
        raise ValueError("the backward kernels take the forward's "
                         "log-sum-exp (lse=, from the forward of "
                         "FlashAttention or flash_attention_fwd_lse); none "
                         "was given")
    return kernel


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = -1,
                        lse: torch.Tensor | None = None):
    """The gradient of :func:`flash_attention` at (q, k, v): ``o`` is its
    output and ``do`` the output's gradient, both [B,Sq,H,hv] in q's
    dtype; ``lse`` is the forward's f32 [B,H,Sq] log2-domain log-sum-exp
    (:func:`flash_attention_fwd_lse`), which a CUDA tensor requires.
    Returns (dq, dk, dv) in q's dtype: the kernel on a CUDA tensor,
    :func:`flash_attention_bwd_plain` on a CPU tensor."""
    check_inputs(q, k, v)
    B, Sq, H, h = q.shape
    Skv, K, hv = k.shape[1], k.shape[2], v.shape[-1]
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, Sq, H, hv) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} [B,Sq,H,hv] = "
                             f"{(B, Sq, H, hv)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         window=window)
    kernel = select_bwd_kernel(q.dtype, h, hv, lse)
    if Skv == 0:
        raise ValueError("no keys to attend to")
    if not all(t.is_contiguous() for t in (q, k, v, o, do)):
        raise ValueError("q, k, v, o and do must be contiguous")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 [B,H,Sq] = "
                         f"{(B, H, Sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ws = torch.empty((bwd_workspace_floats(B, Sq, H),),
                     dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr()]
    outs = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    if kernel is KERNEL_BWD_BF16:
        if any(p % 16 for p in ptrs):
            raise ValueError("the bf16 backward kernel copies 16-byte "
                             "chunks: q, k, v, o and do must start on "
                             "16-byte boundaries")
        plan = list(bf16_head_width(h, hv))
    else:
        plan = list(f32_plan(h, hv, *ptrs, *outs))
    with torch.cuda.device(q.device):
        kernel.launch(
            *ptrs, lse.data_ptr(), *outs, ws.data_ptr(), B, Sq, Skv, H, K,
            h, hv, int(causal), int(window), 1.0 / math.sqrt(h), *plan,
            torch.cuda.current_stream().cuda_stream)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the forward kernel (or the plain
    version on the CPU) and whose backward is :func:`flash_attention_bwd`.
    Saves q, k, v, the output and, where an input of a CUDA call needs a
    gradient, the forward's log-sum-exp for the backward; with no
    gradient to take (serving) the forward launch writes no LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        lse = q.device.type == "cuda" and any(ctx.needs_input_grad[:3])
        out, stats = _forward(q, k, v, causal=causal, window=window,
                              lse=lse)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window, lse=stats)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1) -> torch.Tensor:
    """q [B,Sq,H,h], k [B,Skv,K,h], v [B,Skv,K,hv] → [B,Sq,H,hv] in q's
    dtype. Query i and key j sit at positions i and j; causal masks j > i,
    a window w > 0 masks j <= i - w. Differentiable: it runs
    :class:`FlashAttention`."""
    return FlashAttention.apply(q, k, v, causal, window)
