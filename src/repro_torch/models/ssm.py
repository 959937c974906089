"""RWKV6 (Finch) time mix and the RWKV channel mix. Counterpart of the
RWKV6 part of ``repro.models.ssm`` (the Mamba heads are not ported yet).

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
        "w_r": pf.leaf((D, H * h)),
        "w_k": pf.leaf((D, H * h)),
        "w_v": pf.leaf((D, H * h)),
        "w_g": pf.leaf((D, H * h)),
        # data-dependent decay projection (lora-style, simplified: direct)
        "w_w": pf.leaf((D, H * h), scale=0.006),
        "decay_base": pf.leaf((H * h,), zero=True),
        "bonus_u": pf.leaf((H * h,), zero=True),
        "w_o": pf.leaf((H * h, D)),
        "ln_x": {"scale": pf.ones((D,))},
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
    return {"w_k": pf.leaf((d, f)), "w_v": pf.leaf((f, d)),
            "w_r": pf.leaf((d, d))}


def channel_mix(p, x: torch.Tensor) -> torch.Tensor:
    kk = torch.square(torch.relu(x @ p["w_k"]))   # gate math in x.dtype
    vv = kk @ p["w_v"]
    rr = torch.sigmoid(x @ p["w_r"])
    return rr * vv
