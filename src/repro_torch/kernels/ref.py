"""Plain PyTorch versions of the two model kernels.

- :func:`flash_attention_ref`: masked softmax attention computed in f32,
  as the TPU kernel computes it, cast to q's dtype. It is the plain
  version that ``flash_attention`` runs on a CPU tensor.
- :func:`flash_attention_lse_plain`: each query row's log2-domain
  log-sum-exp of the scaled, masked scores, as the bf16 forward kernel
  writes it for the bf16 backward kernel.
- :func:`flash_attention_bwd_plain`: the gradient of that function, from
  explicit formulas (not autograd), in f32. It is the plain version of
  the backward kernel, which the JAX package does not have (it takes
  ``jax.vjp`` through ``repro.models.layers.flash_attend``).
- :func:`wkv6_ref`: the sequential WKV6 recurrence, token by token (the
  exact oracle, as ``repro.kernels.ref.wkv6_ref``).
- :func:`wkv6_chunked_ref`: the chunked WKV6 form that ``wkv6_chunked``
  runs on a CPU tensor. It uses the pairwise intra-chunk decay
  ``exp(cum_ex[t] - cum[s])`` (s < t), whose exponent is never positive,
  in place of the reference's ``(r exp(cum_ex)) . (k exp(-cum))``, which
  overflows f32 once a chunk's log decay sums past about -88.7 (a 128-token
  chunk of the rwkv6 models' decay does). Same function, no overflow.
"""
from __future__ import annotations

import math

import torch

MASKED = -1e30


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   device) -> torch.Tensor:
    """bool[Sq, Skv], True = attend; query i and key j at positions i and
    j. Causal: j <= i. Window w > 0: j > i - w (applied with or without
    causality, as in the TPU kernel)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = -1) -> torch.Tensor:
    """q [B,Sq,H,h], k [B,Skv,K,h], v [B,Skv,K,hv] (H = K·G) → [B,Sq,H,hv]
    in q's dtype. Scores, softmax and the weighted sum are f32; a masked
    score is -1e30. A query row that sees no key at all has no defined
    output (here: the mean of v; the kernel's differs)."""
    B, Sq, H, h = q.shape
    Skv, K, hv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, h)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / math.sqrt(h)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, MASKED))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hv).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              causal: bool = True,
                              window: int = -1) -> torch.Tensor:
    """f32 [B,H,Sq]: log2 sum_j 2^(s_ij) for each query row of q
    [B,Sq,H,h] over k [B,Skv,K,h], with s = (q . k) log2(e)/sqrt(h) and a
    masked score at -1e30, taken as m + log2(sum_j 2^(s_ij - m)), m the
    row's max (a row that sees no key gives about -1e30)."""
    B, Sq, H, h = q.shape
    K = k.shape[2]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float().reshape(B, Sq, K, H // K,
                                                           h),
                     k.float()) * (math.log2(math.e) / math.sqrt(h))
    mask = attention_mask(Sq, k.shape[1], causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask, s, torch.full_like(s, MASKED))
    m = s.amax(-1)
    lse = m + torch.log2(torch.exp2(s - m[..., None]).sum(-1))
    return lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              window: int = -1):
    """The gradient of :func:`flash_attention_ref` at (q, k, v), given its
    output ``o`` and the output's gradient ``do`` [B,Sq,H,hv]. Returns
    (dq, dk, dv) in q's dtype. In f32, with s the scaled, masked scores:

        P = softmax(s),  D_i = do_i . o_i,  dS = P (do v^T - D)
        dq = dS k / sqrt(h),  dk = dS^T q / sqrt(h),  dv = P^T do

    (dk and dv summed over the G query heads of each kv head)."""
    B, Sq, H, h = q.shape
    Skv, K, hv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    scale = 1.0 / math.sqrt(h)
    qf = q.float().reshape(B, Sq, K, G, h)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, K, G, hv)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) / math.sqrt(h)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, MASKED))
    p = torch.softmax(logits, dim=-1)                        # [B,K,G,Sq,Skv]
    d = (dof * o.float().reshape(B, Sq, K, G, hv)).sum(-1)   # [B,Sq,K,G]
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    return (dq.reshape(B, Sq, H, h).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def wkv6_ref(r, k, v, wlog, u) -> torch.Tensor:
    """Sequential WKV6 recurrence (exact oracle). r/k/v/wlog [B,S,H,hd],
    u [H,hd] → f32 [B,S,H,hd]."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, wlog))
    uf = u.float()
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 state + uf[None, :, :, None] * kv))
        state = state * torch.exp(wf[:, t])[..., None] + kv
    return torch.stack(outs, dim=1)


def wkv6_chunked_ref(r, k, v, wlog, u, *, chunk: int = 128) -> torch.Tensor:
    """Chunked WKV6, overflow-free. Shapes as :func:`wkv6_ref`; any S (the
    last chunk may be short). Within a chunk, with cum the inclusive
    cumulative log decay and cum_ex = cum - wlog:

        att[t, s] = Σ_d r[t,d] k[s,d] exp(cum_ex[t,d] - cum[s,d])   s < t
        out[t]    = Σ_{s<t} att[t,s] v[s] + (r_t·(u⊙k_t)) v_t
                    + (r_t ⊙ exp(cum_ex_t)) · S0
        S1        = exp(total) ⊙ S0
                    + Σ_s (k_s ⊙ exp(total - cum_s)) ⊗ v_s
    """
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.float().permute(0, 2, 1, 3) for t in (r, k, v, wlog))
    uf = u.float()[None, :, None, :]                    # [1,H,1,hd]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=r.device)
    for t0 in range(0, S, chunk):
        rr, kk, vv, ww = (t[:, :, t0:t0 + chunk] for t in (rf, kf, vf, wf))
        C = rr.shape[2]
        cum = torch.cumsum(ww, dim=2)
        cum_ex = cum - ww
        total = cum[:, :, -1:, :]                       # [B,H,1,hd]
        below = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                      device=r.device), diagonal=-1)
        expo = cum_ex[:, :, :, None, :] - cum[:, :, None, :, :]
        # s >= t would have a positive exponent: mask it before the exp
        dec = torch.exp(torch.where(below[:, :, None], expo,
                                    torch.full_like(expo, -math.inf)))
        att = torch.einsum("bhtk,bhsk,bhtsk->bhts", rr, kk, dec)
        diag = (rr * uf * kk).sum(dim=-1)
        out[:, :, t0:t0 + C] = (att @ vv + diag[..., None] * vv
                                + (rr * torch.exp(cum_ex)) @ state)
        state = (torch.exp(total).transpose(-1, -2) * state
                 + (kk * torch.exp(total - cum)).transpose(-1, -2) @ vv)
    return out.permute(0, 2, 1, 3)
