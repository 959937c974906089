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
- :func:`wkv6_chunked_bwd_plain`: its gradient from explicit formulas
  (not autograd), every exponent at or below zero: the plain version of
  the WKV6 backward kernel, the function it computes (not its arithmetic,
  which ``tests/test_torch_wkv6_bwd.py`` emulates), which the JAX package
  does not have (it takes ``jax.grad`` through
  ``repro.models.ssm.rwkv6_chunked``, whose gradient overflows where its
  forward does).
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


def _wkv6_chunk_decays(ww: torch.Tensor):
    """cum, cum_ex, total of one chunk's log decay ww [B,H,C,hd], and the
    pairwise in-chunk decay dec[t, s] = exp(cum_ex[t] - cum[s]) for s < t
    (0 elsewhere) as [B,H,C,C,hd]: every exponent <= 0."""
    C = ww.shape[2]
    cum = torch.cumsum(ww, dim=2)
    cum_ex = cum - ww
    total = cum[:, :, -1:, :]
    below = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                  device=ww.device), diagonal=-1)
    expo = cum_ex[:, :, :, None, :] - cum[:, :, None, :, :]
    # s >= t would have a positive exponent: mask it before the exp
    dec = torch.exp(torch.where(below[:, :, None], expo,
                                torch.full_like(expo, -math.inf)))
    return cum, cum_ex, total, dec


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
        cum, cum_ex, total, dec = _wkv6_chunk_decays(ww)
        att = torch.einsum("bhtk,bhsk,bhtsk->bhts", rr, kk, dec)
        diag = (rr * uf * kk).sum(dim=-1)
        out[:, :, t0:t0 + C] = (att @ vv + diag[..., None] * vv
                                + (rr * torch.exp(cum_ex)) @ state)
        state = (torch.exp(total).transpose(-1, -2) * state
                 + (kk * torch.exp(total - cum)).transpose(-1, -2) @ vv)
    return out.permute(0, 2, 1, 3)


def wkv6_chunked_bwd_plain(r, k, v, wlog, u, dout, *, chunk: int = 128):
    """The gradient of :func:`wkv6_chunked_ref` at (r, k, v, wlog, u) for
    the output's gradient ``dout`` (f32 [B,S,H,hd]), from explicit
    formulas (not autograd), in f32. Returns (dr, dk, dv) in r's dtype,
    dwlog f32 [B,S,H,hd] and du f32 [H,hd] (summed over batch and
    sequence). The function that the WKV6 backward kernel computes, chunk
    by chunk, every exponent <= 0, with one exp per (t, s, d) pair and the
    state leaving each chunk; the kernel's own arithmetic (the decay
    factored on two levels, the chunk-end term from the entering state,
    split-TF32 state products) is emulated in
    ``tests/test_torch_wkv6_bwd.py``. With S_c the state entering chunk c,
    A[t, s] = do_t · v_s, and in the chunk cum, cum_ex, total and dec as in
    the forward:

        G_c     = the gradient of the state leaving chunk c (0 for the
                  last): G_{c-1} = exp(total_c) ⊙ G_c
                                   + (r ⊙ exp(cum_ex))_cᵀ do_c
        dr_t    = Σ_{s<t} dec[t,s] ⊙ k_s A[t,s]            (intra)
                  + exp(cum_ex_t) ⊙ (S_c do_t)              (inter)
                  + u ⊙ k_t A[t,t]
        dk_s    = Σ_{t>s} dec[t,s] ⊙ r_t A[t,s]            (intra)
                  + exp(total - cum_s) ⊙ (G_c v_s)          (inter)
                  + u ⊙ r_s A[s,s]
        dv_s    = Σ_{t>s} att[t,s] do_t + (r_s·(u⊙k_s)) do_s
                  + (k_s ⊙ exp(total - cum_s)) G_c
        du      = Σ r_t ⊙ k_t A[t,t]

    dwlog_i is the sum of the terms of every (t, s) pair with s < i < t,
    which the decay of token i enters. In chunk c, with f_t = r_t ⊙ (dr
    intra + inter)_t - k_t ⊙ (dk intra + inter)_t and h_t = k_t ⊙ (dk
    intra + inter)_t:

        dwlog_i = Σ_{t>i in c} f_t - h_i + Σ_j G_c[:, j] ⊙ S_{c+1}[:, j]

    (the last term: the pairs that straddle chunk c's end, S_{c+1} the
    state leaving it). Every sum stays inside one chunk, so none of them
    cancels terms from the rest of the sequence."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf, gf = (t.float().permute(0, 2, 1, 3)
                          for t in (r, k, v, wlog, dout))  # [B,H,S,hd]
    uf = u.float()[None, :, None, :]                       # [1,H,1,hd]
    bounds = [(t0, min(t0 + chunk, S)) for t0 in range(0, S, chunk)]
    # the state entering each chunk, and after the last
    states = [torch.zeros((B, H, hd, hd), dtype=torch.float32,
                          device=r.device)]
    for t0, t1 in bounds:
        kk, vv = kf[:, :, t0:t1], vf[:, :, t0:t1]
        cum = torch.cumsum(wf[:, :, t0:t1], dim=2)
        total = cum[:, :, -1:, :]
        states.append(torch.exp(total).transpose(-1, -2) * states[-1]
                      + (kk * torch.exp(total - cum)).transpose(-1, -2)
                      @ vv)
    # the gradient of the state leaving each chunk, last to first
    grads = [torch.zeros_like(states[0])]
    for t0, t1 in bounds[:0:-1]:
        rr, gg = rf[:, :, t0:t1], gf[:, :, t0:t1]
        cum = torch.cumsum(wf[:, :, t0:t1], dim=2)
        grads.append(torch.exp(cum[:, :, -1:, :]).transpose(-1, -2)
                     * grads[-1]
                     + (rr * torch.exp(cum - wf[:, :, t0:t1]))
                     .transpose(-1, -2) @ gg)
    grads = grads[::-1]
    dr, dk, dv, dwlog = (torch.empty((B, H, S, hd), dtype=torch.float32,
                                     device=r.device) for _ in range(4))
    du = torch.zeros((H, hd), dtype=torch.float32, device=r.device)
    for c, (t0, t1) in enumerate(bounds):
        rr, kk, vv, gg = (t[:, :, t0:t1] for t in (rf, kf, vf, gf))
        s_in, s_out, g_out = states[c], states[c + 1], grads[c]
        cum, cum_ex, total, dec = _wkv6_chunk_decays(wf[:, :, t0:t1])
        a = gg @ vv.transpose(-1, -2)                      # A[t, s]
        a_diag = torch.diagonal(a, dim1=-2, dim2=-1)[..., None]
        att = torch.einsum("bhtd,bhsd,bhtsd->bhts", rr, kk, dec)
        bonus = (rr * uf * kk).sum(-1, keepdim=True)        # att[t, t]
        dr_state = (torch.einsum("bhtsd,bhsd,bhts->bhtd", dec, kk, a)
                    + torch.exp(cum_ex) * (gg @ s_in.transpose(-1, -2)))
        k_out = torch.exp(total - cum)
        dk_state = (torch.einsum("bhtsd,bhtd,bhts->bhsd", dec, rr, a)
                    + k_out * (vv @ g_out.transpose(-1, -2)))
        dr[:, :, t0:t1] = dr_state + uf * kk * a_diag
        dk[:, :, t0:t1] = dk_state + uf * rr * a_diag
        dv[:, :, t0:t1] = (att.transpose(-1, -2) @ gg + bonus * gg
                           + (kk * k_out) @ g_out)
        du += (rr * kk * a_diag).sum(dim=(0, 2))
        # Σ_{t>i} f_t, summed from the chunk's last token back
        f = rr * dr_state - kk * dk_state
        after = torch.flip(torch.cumsum(torch.flip(f[:, :, 1:], [2]), dim=2),
                           [2])
        after = torch.cat([after, torch.zeros_like(f[:, :, :1])], dim=2)
        dwlog[:, :, t0:t1] = (after - kk * dk_state
                              + (g_out * s_out).sum(-1)[:, :, None, :])
    back = [x.permute(0, 2, 1, 3) for x in (dr, dk, dv, dwlog)]
    return (*(x.to(r.dtype) for x in back[:3]), back[3], du)
