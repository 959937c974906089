"""RWKV6 (Finch) time mix, the RWKV channel mix and the Mamba-style
diagonal selective SSM of hymba's Mamba heads. Counterpart of
``repro.models.ssm``.

RWKV6 time mix (arXiv:2404.05892) with data-dependent decay:
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t          (state: [h_k, h_v] per head)
    o_t = r_t · (diag(u ⊙ k_t) v_t + S_{t-1})
Prefill runs the chunked form through ``kernels.ops.wkv6`` (the WKV6 kernel
on the card, its plain chunked version on the CPU); decode is the O(1)
recurrent update. The port's chunked form stays finite where the
reference's gives NaN (prompts of 128 tokens or more at the model's decay
range): see ``kernels/rwkv6_scan.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig, ParamFactory

# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def init_rwkv6(pf: ParamFactory, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    h = D // H
    return {
        "w_r": pf.leaf((D, H * h), ("embed", "heads")),
        "w_k": pf.leaf((D, H * h), ("embed", "heads")),
        "w_v": pf.leaf((D, H * h), ("embed", "heads")),
        "w_g": pf.leaf((D, H * h), ("embed", "heads")),
        # data-dependent decay projection (lora-style, simplified: direct)
        "w_w": pf.leaf((D, H * h), ("embed", "heads"), scale=0.006),
        "decay_base": pf.leaf((H * h,), ("heads",), zero=True),
        "bonus_u": pf.leaf((H * h,), ("heads",), zero=True),
        "w_o": pf.leaf((H * h, D), ("heads", "embed")),
        "ln_x": {"scale": pf.ones((D,), (None,))},
    }


def _rwkv6_project(p, x: torch.Tensor, H: int):
    """r, k, v, silu-gate g and the raw decay projection, each
    [B,S,H,h] in x.dtype."""
    B, S, D = x.shape
    h = p["w_r"].shape[1] // H

    def proj(w):
        return (x @ w).reshape(B, S, H, h)
    r, k, v = proj(p["w_r"]), proj(p["w_k"]), proj(p["w_v"])
    g = F.silu(proj(p["w_g"]))
    w_raw = proj(p["w_w"])
    return r, k, v, g, w_raw


def _decay_log(p, w_raw: torch.Tensor, H: int) -> torch.Tensor:
    """w_raw [..., H, h] → log decay in f32 (numerically sensitive)."""
    h = w_raw.shape[-1]
    return -F.softplus(w_raw.float()
                       + p["decay_base"].reshape(H, h).float()) - 1e-4


def rwkv6_chunked(p, cfg: ModelConfig, x: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    """Chunked WKV6 time mix. x [B,S,D] → [B,S,D]; any S."""
    B, S, D = x.shape
    H = cfg.ssm_heads or cfg.n_heads
    hd = D // H
    r, k, v, g, w_raw = _rwkv6_project(p, x, H)
    u = p["bonus_u"].reshape(H, hd).float()
    out = ops.wkv6(r, k, v, _decay_log(p, w_raw, H), u,
                   chunk=min(chunk, S))
    out = out.to(x.dtype) * g
    return out.reshape(B, S, H * hd) @ p["w_o"]


def rwkv6_decode_step(p, cfg: ModelConfig, x: torch.Tensor,
                      state: torch.Tensor):
    """x [B,1,D]; state [B,H,hd,hd] f32. O(1) per token. Returns
    (y [B,1,D], new state)."""
    B, _, D = x.shape
    H = cfg.ssm_heads or cfg.n_heads
    hd = D // H
    r, k, v, g, w_raw = _rwkv6_project(p, x, H)
    r, k, v = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()  # [B,H,hd]
    w = torch.exp(_decay_log(p, w_raw[:, 0], H))
    u = p["bonus_u"].reshape(H, hd).float()
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    state = state * w[..., None] + kv
    out = out[:, None].to(x.dtype).reshape(B, 1, H, hd) * g
    return out.reshape(B, 1, H * hd) @ p["w_o"], state


def rwkv6_sequential_oracle(p, cfg: ModelConfig,
                            x: torch.Tensor) -> torch.Tensor:
    """Token-by-token reference for tests (slow, exact)."""
    B, S, D = x.shape
    H = cfg.ssm_heads or cfg.n_heads
    hd = D // H
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        y, state = rwkv6_decode_step(p, cfg, x[:, t:t + 1], state)
        ys.append(y)
    return torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# channel mix (rwkv6 ffn)
# ---------------------------------------------------------------------------

def init_channel_mix(pf: ParamFactory, d: int, f: int) -> dict:
    return {"w_k": pf.leaf((d, f), ("embed", "mlp")),
            "w_v": pf.leaf((f, d), ("mlp", "embed")),
            "w_r": pf.leaf((d, d), ("embed", None))}


def channel_mix(p, x: torch.Tensor) -> torch.Tensor:
    kk = torch.square(torch.relu(x @ p["w_k"]))   # gate math in x.dtype
    vv = kk @ p["w_v"]
    rr = torch.sigmoid(x @ p["w_r"])
    return rr * vv


# ---------------------------------------------------------------------------
# Mamba-style diagonal selective SSM (hymba heads)
# ---------------------------------------------------------------------------
#     h_t = exp(dt_t A) ⊙ h_{t-1} + (dt_t x_t) ⊗ B_t      (state [e, N])
#     y_t = h_t · C_t + Dskip ⊙ x_t,  gated by silu(x W_gate)
# The reference's prefill scans token by token inside checkpointed chunks
# of 128 (``lax.scan``). A Python loop over tokens would cost one host
# step per token and layer on the card (~37 k per hymba prefill), so the
# port computes the same recurrence in chunks of C tokens with every
# chunk advanced at once: C steps inside the chunks from a zero state,
# NC steps across them to carry each chunk's entry state, then each
# token's share of its entry state, exp(L_t) ⊙ H, where L_t is the sum of
# dt·A from the chunk's start to t. Every exponent is a sum of dt·A <= 0
# (no exp(L_t) · exp(-L_s), which overflows f32 once a sum passes -88.7).
# C = ceil(sqrt(S)) keeps C + NC host steps near 2 sqrt(S).


def init_mamba(pf: ParamFactory, cfg: ModelConfig, d_inner: int) -> dict:
    N = cfg.ssm_state
    return {
        "w_in": pf.leaf((cfg.d_model, d_inner), ("embed", "heads")),
        "w_gate": pf.leaf((cfg.d_model, d_inner), ("embed", "heads")),
        "w_B": pf.leaf((d_inner, N), ("heads", None), scale=0.01),
        "w_C": pf.leaf((d_inner, N), ("heads", None), scale=0.01),
        "w_dt": pf.leaf((d_inner,), ("heads",), zero=True),
        "A_log": pf.leaf((d_inner, N), ("heads", None), zero=True),
        "Dskip": pf.ones((d_inner,), ("heads",)),
        "w_out": pf.leaf((d_inner, cfg.d_model), ("heads", "embed")),
    }


def _mamba_project(p, x: torch.Tensor):
    """x [B,S,D] → the f32 inner stream xf [B,S,e], its gate z
    (silu in x.dtype, then f32), B_ and C_ [B,S,N], the step dt [B,S,e]
    and A = -exp(A_log) [e,N] (< 0)."""
    xi = x @ p["w_in"]
    z = F.silu(x @ p["w_gate"]).float()
    xf = xi.float()
    B_ = xf @ p["w_B"].float()
    C_ = xf @ p["w_C"].float()
    dt = F.softplus(xf * p["w_dt"].float())
    A = -torch.exp(p["A_log"].float())
    return xf, z, B_, C_, dt, A


def selective_scan(xf: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B_: torch.Tensor, C_: torch.Tensor,
                   chunk: int | None = None) -> torch.Tensor:
    """y_t = h_t · C_t of the recurrence above from a zero state, in f32:
    xf, dt [B,S,e], A [e,N], B_, C_ [B,S,N] → [B,S,e]. ``chunk`` (default
    ceil(sqrt(S))) sets C; S need not be a multiple of it (the tail is
    padded with steps of decay 1 and input 0, which change no earlier
    state)."""
    Bsz, S, e = xf.shape
    N = A.shape[-1]
    C = chunk or math.isqrt(S - 1) + 1
    NC = -(-S // C)
    pad = NC * C - S
    la = dt[..., None] * A                                   # [B,S,e,N] <= 0
    u = (dt * xf)[..., None] * B_[:, :, None, :]
    c_ = C_
    if pad:
        la, u = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (la, u))
        c_ = F.pad(C_, (0, 0, 0, pad))
    la = la.reshape(Bsz, NC, C, e, N)
    u = u.reshape(Bsz, NC, C, e, N)
    # the loops take their steps from unbind, whose backward is one stack
    # (a step's own slice would zero-fill and add a full-size gradient)
    us, a = u.unbind(2), torch.exp(la).unbind(2)
    # inside each chunk, from a zero state: all chunks advance together
    h = us[0]
    hs = [h]
    for t in range(1, C):
        h = torch.addcmul(us[t], h, a[t])
        hs.append(h)
    # across chunks: the state entering chunk c
    L = torch.cumsum(la, dim=2)                              # <= 0
    through = torch.exp(L[:, :, -1]).unbind(1)               # [B,e,N] each
    last = h.unbind(1)                                       # chunk ends
    entry = [torch.zeros_like(last[0])]
    for c in range(1, NC):
        entry.append(torch.addcmul(last[c - 1], entry[-1], through[c - 1]))
    H = torch.stack(hs, dim=2) \
        + torch.exp(L) * torch.stack(entry, dim=1)[:, :, None]
    y = torch.einsum("bcten,bctn->bcte", H,
                     c_.reshape(Bsz, NC, C, N))
    return y.reshape(Bsz, NC * C, e)[:, :S]


def mamba_scan(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill path: x [B,S,D] → [B,S,D] in x.dtype, the
    reference's ``mamba_scan`` (its 128-token checkpointed chunks have no
    counterpart here: the whole block runs under ``transformer.remat``,
    so the scan's intermediates live only inside one block's backward)."""
    xf, z, B_, C_, dt, A = _mamba_project(p, x)
    y = selective_scan(xf, dt, A, B_, C_)
    y = y + xf * p["Dskip"].float()
    return (y * z).to(x.dtype) @ p["w_out"]


def mamba_decode_step(p, cfg: ModelConfig, x: torch.Tensor,
                      h: torch.Tensor):
    """x [B,1,D], h [B, d_inner, N] f32 → (y [B,1,D], the new state)."""
    xf, z, B_, C_, dt, A = _mamba_project(p, x)
    xt, bt, ct, dtt = xf[:, 0], B_[:, 0], C_[:, 0], dt[:, 0]
    decay = torch.exp(dtt[..., None] * A[None])
    h = h * decay + (dtt * xt)[..., None] * bt[:, None, :]
    y = torch.einsum("ben,bn->be", h, ct)
    y = y + xt * p["Dskip"].float()
    y = (y * z[:, 0]).to(x.dtype)
    return (y @ p["w_out"])[:, None], h


def mamba_state_spec(cfg: ModelConfig, batch: int, d_inner: int):
    return ((batch, d_inner, cfg.ssm_state), torch.float32)


def rwkv6_state_spec(cfg: ModelConfig, batch: int):
    """One RWKV6 layer's decode state: ((batch, H, hd, hd), f32). The
    decode cache keeps it flattened to [B, H·hd, hd]
    (``models.decode.cache_spec``)."""
    H = cfg.ssm_heads or cfg.n_heads
    hd = cfg.d_model // H
    return ((batch, H, hd, hd), torch.float32)
