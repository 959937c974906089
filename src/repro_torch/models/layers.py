"""Transformer building blocks: RMSNorm, RoPE, GQA attention with its
decode cache, multi-head latent attention (MLA) with its compressed
cache, the SwiGLU MLP, the capacity-routed MoE, embeddings and the head.
Counterpart of ``repro.models.layers`` (only what the ported families
call, M-RoPE, MLA, the MoE and the bidirectional attention of whisper's
encoder included).

All shapes use: B batch, S sequence, D d_model, H heads, K kv heads,
h head_dim, F ffn dim, E experts, C expert capacity, V vocab.

The MoE (:func:`moe_apply`) is plain PyTorch on the CPU and on the card,
as it is plain jnp in the reference: its expert FFN is three products
batched over E (``torch.bmm``), and its dispatch and combine are index
operations that have deterministic CUDA implementations (the train step
runs in PyTorch's deterministic mode).

The full-sequence (prefill) branches of :func:`gqa_apply` and
:func:`mla_apply` call the flash attention kernel through
``kernels.ops.attention`` at every S, causal or bidirectional; the
reference switches from the direct softmax to its blockwise form at S >=
1024 (and computes the bidirectional branch with the direct softmax),
and both compute the same function. The decode branches stay plain
PyTorch, as they are plain jnp in the reference.

The layout constraints of ``models.pconstraint`` (the batch dim of
q/k/v and of the attention output, the expert dim of the MoE's dispatch
buffers, the weights' compute layout) are called where the reference
calls them. Without a mesh each returns its input itself.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import ops
from .common import ModelConfig, ParamFactory
from .pconstraint import constrain_batch, constrain_expert
from .pconstraint import weight_compute_layout as wcl

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(pf: ParamFactory, d: int) -> dict:
    return {"scale": pf.ones((d,), (None,))}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32; the full-width tensor stays in x.dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: tuple = ()) -> torch.Tensor:
    """x [B, S, N, h]; positions [B, S], or [3, B, S] for M-RoPE.
    Rotates the two halves of the head dim by position × frequency, in
    f32, and returns x.dtype.

    M-RoPE (qwen2-vl): the h/2 frequencies are split into (t, h, w)
    ``sections``, each rotated by its own position stream. As in the
    reference, only the positions' rank chooses: 2-D positions take the
    standard rotation whatever ``sections`` is (text-only serving)."""
    h = x.shape[-1]
    freqs = rope_freqs(h, theta, x.device)                    # [h/2]
    if positions.dim() == 3:
        if sum(sections) != h // 2:
            raise ValueError(f"M-RoPE sections {sections} must sum to "
                             f"h/2 = {h // 2}")
        sec_id = torch.repeat_interleave(
            torch.arange(len(sections), device=x.device),
            torch.tensor(sections, device=x.device))           # [h/2]
        pos = positions.float()[sec_id]                       # [h/2,B,S]
        ang = pos.permute(1, 2, 0) * freqs                    # [B,S,h/2]
    else:
        ang = positions.float()[..., None] * freqs            # [B,S,h/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_positions(layout, batch: int, device=None):
    """M-RoPE position ids of the Qwen2-VL layout (arXiv:2409.12191,
    §2.1) for a sequence of segments: ``("text", n)`` or ``("image",
    rows, cols)``, the patches row-major. A text token has one id in all
    three streams; an image's patches share the temporal id ``s`` and take
    ``s + row`` and ``s + col``; each segment starts at the largest id
    before it plus 1 (0 for the first). Returns (int32 [3, batch, S] on
    ``device``, default the CUDA card, and the id of the next text
    token). The reference builds no such ids (its data feeds one stream
    three times)."""
    streams, nxt = [], 0
    for seg in layout:
        if seg[0] == "text":
            ids = torch.arange(nxt, nxt + seg[1])
            streams.append(torch.stack([ids, ids, ids]))
            nxt += seg[1]
        elif seg[0] == "image":
            rows, cols = seg[1], seg[2]
            r = torch.arange(rows).repeat_interleave(cols)
            c = torch.arange(cols).repeat(rows)
            streams.append(torch.stack([torch.full_like(r, nxt), nxt + r,
                                        nxt + c]))
            nxt += max(rows, cols)
        else:
            raise ValueError(f"unknown layout segment {seg!r}")
    pos = torch.cat(streams, dim=1).to(torch.int32)           # [3, S]
    return (pos[:, None].expand(3, batch, pos.shape[1]).contiguous()
            .to(resolve_device(device)), nxt)


# ---------------------------------------------------------------------------
# attention (GQA, sliding window, qk-norm, decode cache)
# ---------------------------------------------------------------------------

def init_gqa(pf: ParamFactory, cfg: ModelConfig) -> dict:
    """Weights stay 2-D with the head dims flattened (H·h etc.)."""
    D, H, K, h = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": pf.leaf((D, H * h), ("embed", "heads")),
         "wk": pf.leaf((D, K * h), ("embed", "kv_heads")),
         "wv": pf.leaf((D, K * h), ("embed", "kv_heads")),
         "wo": pf.leaf((H * h, D), ("heads", "embed"))}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(pf, h)
        p["k_norm"] = init_rmsnorm(pf, h)
    return p


def _causal_window_mask(Sq: int, Skv: int, window: int, q_offset: int,
                        device=None) -> torch.Tensor:
    """bool[Sq, Skv]; True = attend. q_offset = absolute pos of query 0."""
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Skv, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,H,h], k/v [B,Skv,K,h], mask [Sq,Skv] or [B,1,Sq,Skv].
    Scores and softmax in f32; the probabilities are rounded to v's dtype
    before the weighted sum, as in the reference (and as the bf16 flash
    kernel rounds its P before P·V); the sum is taken in f32 and the
    output is in v's dtype. In f32 the rounding is the identity."""
    B, Sq, H, h = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, h)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits / math.sqrt(h)
    if mask.dim() == 2:
        mask = mask[None, None, None]
    else:                                   # [B,1,Sq,Skv] → [B,1,1,Sq,Skv]
        mask = mask[:, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    w = w.to(v.dtype).float()
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float()).to(v.dtype)
    return constrain_batch(out.reshape(B, Sq, H, v.shape[-1]))


def write_slots(buf: torch.Tensor, start, val: torch.Tensor) -> None:
    """buf[:, start:start + S] = val (val [B,S,...]) in place; ``start``
    a Python int or a 0-d integer tensor on buf's device (no host
    read)."""
    if isinstance(start, int):
        buf[:, start:start + val.shape[1]] = val
    else:
        slots = start.reshape(1).long() + torch.arange(val.shape[1],
                                                       device=buf.device)
        buf.index_copy_(1, slots, val)


def gqa_apply(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              *, window: int, cache: Optional[dict] = None,
              cache_index: Optional[int] = None, causal: bool = True):
    """Returns (out, new_cache). Prefill: cache None, full S, flash
    attention kernel. ``causal=False`` is the bidirectional branch of the
    reference's ``_gqa_maybe_noncausal`` (whisper's encoder): q and k
    rotated by ``positions``, every key visible (no window), no cache.
    Decode: x is [B,1,D] and ``cache`` holds k/v as
    [B, L, K·h]; this step's k/v are written into it IN PLACE at
    ``cache_index`` (a Python int, or a 0-d integer tensor on the cache's
    device, which a captured step replays with new values), and the
    returned cache is the same dict of the same tensors.

    A sliding-window layer whose cache has no more slots than its window
    (L <= window) keeps a ring: the step's k/v go to slot
    ``cache_index mod L`` and slot j is attended iff ``j <= min(index,
    L - 1)``: every slot once the ring has filled, until then only the
    slots written so far, so the slots hold exactly the window's keys
    when L = window. The reference masks its ring with ``max`` in place
    of ``min`` (``repro/models/decode.py:121``), which attends the
    never-written zero slots until the ring fills (ROADMAP.md queue 3)."""
    B, S, D = x.shape
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = constrain_batch((x @ wcl(p["wq"], (1,))).reshape(B, S, H, h))
    k = constrain_batch((x @ wcl(p["wk"], (1,))).reshape(B, S, K, h))
    v = constrain_batch((x @ wcl(p["wv"], (1,))).reshape(B, S, K, h))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if not causal and cache is not None:
        raise ValueError("bidirectional attention has no decode cache")
    if cache is None:
        out = ops.attention(q, k, v, causal=causal,
                            window=window if causal else -1)
        new_cache = None
    else:
        ck, cv = cache["k"], cache["v"]
        Skv = ck.shape[1]
        if 0 < window and Skv <= window:                 # the ring
            write_slots(ck, cache_index % Skv, k.reshape(B, S, K * h))
            write_slots(cv, cache_index % Skv, v.reshape(B, S, K * h))
            last = min(cache_index, Skv - 1) \
                if isinstance(cache_index, int) \
                else torch.clamp(cache_index, max=Skv - 1)
            m = torch.arange(Skv, device=x.device)[None, :] <= last
        else:
            write_slots(ck, cache_index, k.reshape(B, S, K * h))
            write_slots(cv, cache_index, v.reshape(B, S, K * h))
            m = _causal_window_mask(S, Skv, window, cache_index, x.device)
        out = attend(q, ck.reshape(B, Skv, K, h), cv.reshape(B, Skv, K, h),
                     m)
        new_cache = cache
    y = out.reshape(B, S, H * h) @ wcl(p["wo"], (0,))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA: deepseek-v3's multi-head latent attention
# ---------------------------------------------------------------------------

def init_mla(pf: ParamFactory, cfg: ModelConfig) -> dict:
    """The reference's leaves: the query's low-rank pair ``wq_a`` [D, qr]
    and ``wq_b`` [qr, H·(dn+dr)] with the norm ``q_a_norm`` between them;
    ``wkv_a`` [D, kvr+dr] (the latent and the shared rope key); the
    latent's norm ``kv_a_norm``; its expansions ``wk_b`` [kvr, H·dn] and
    ``wv_b`` [kvr, H·dv]; ``wo`` [H·dv, D]."""
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {"wq_a": pf.leaf((D, qr), ("embed", "q_lora")),
            "q_a_norm": init_rmsnorm(pf, qr),
            "wq_b": pf.leaf((qr, H * (dn + dr)), ("q_lora", "heads")),
            "wkv_a": pf.leaf((D, kvr + dr), ("embed", None)),
            "kv_a_norm": init_rmsnorm(pf, kvr),
            "wk_b": pf.leaf((kvr, H * dn), ("kv_lora", "heads")),
            "wv_b": pf.leaf((kvr, H * dv), ("kv_lora", "heads")),
            "wo": pf.leaf((H * dv, D), ("heads", "embed"))}


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The compressed cache: the normed latent ``c_kv`` [B, L, kvr] and
    the rotated shared key ``k_rope`` [B, L, dr] (576 values a token for
    deepseek-v3, against H·(dn+dv) = 32,768 for its expanded keys and
    values)."""
    return {"c_kv": ((batch, max_len, cfg.kv_lora_rank), cfg.dtype),
            "k_rope": ((batch, max_len, cfg.qk_rope_dim), cfg.dtype)}


def mla_apply(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              *, cache: Optional[dict] = None, cache_index=None):
    """MLA (arXiv:2412.19437 §2.1.1). Returns (out [B,S,D], new_cache).

    The query goes through its low-rank pair, split into a part without
    rotation (dn) and a rotated part (dr); the keys and values come from
    one normed latent ``c_kv`` (kvr) per token, and one rotated key
    ``k_rope`` (dr) per token is shared by every head. The score of a
    head is (q_nope · k_nope + q_rope · k_rope) / sqrt(dn + dr).

    - No cache (prefill, training): the latent is expanded into per-head
      keys [B,S,H,dn] and values [B,S,H,dv], the shared rope key is
      copied into every head, and q [B,S,H,dn+dr], k and v (contiguous)
      go through one causal flash call (``kernels.ops.attention``) at
      every S: deepseek-v3's widths launch the kernels' (192, 128)
      instantiation. The kernel scales by 1/sqrt of q's width, which is
      MLA's scale. The reference takes its direct softmax below S = 1024
      and ``flash_attend`` from there; both compute this function, and the
      port keeps one kernel at every S, as ``gqa_apply`` does.
    - A cache and S = 1 (decode): the absorbed form of the reference. The
      step's latent and rope key are written into ``cache["c_kv"]`` and
      ``cache["k_rope"]`` IN PLACE at ``cache_index`` (an int, or a 0-d
      integer tensor on the cache's device); q_nope is absorbed through
      ``wk_b`` into the latent space, the scores are taken against the
      cached latents and rope keys in f32 (from the cache's dtype, as the
      reference's ``preferred_element_type``), slots after
      ``cache_index`` masked at -1e30, the softmax weights cast to the
      cache's dtype, the context gathered in the latent space and only
      then expanded through ``wv_b``. Plain PyTorch, as the reference's
      is plain jnp.
    - A cache and S > 1 (a chunk written at ``cache_index``): the cache is
      written the same way, the whole cache is expanded and query row i
      sees the slots up to ``cache_index + i``. The reference's branch
      shows every row only the slots up to ``cache_index`` (its mask
      ignores the row), which is not causal (ROADMAP.md queue 3); no
      path of either package takes it."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    ql = rmsnorm(p["q_a_norm"], x @ wcl(p["wq_a"], ()), cfg.norm_eps)
    q = constrain_batch((ql @ wcl(p["wq_b"], (1,)))
                        .reshape(B, S, H, dn + dr))
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = x @ wcl(p["wkv_a"], ())                          # [B,S,kvr+dr]
    c_kv = rmsnorm(p["kv_a_norm"], kv[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]          # [B,S,dr]
    if cache is not None:
        write_slots(cache["c_kv"], cache_index, c_kv)
        write_slots(cache["k_rope"], cache_index, k_rope)
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Skv = c_kv.shape[1]
    if cache is not None and S == 1:
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope,
                             p["wk_b"].reshape(kvr, H, dn))
        logits = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(),
                               c_kv.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                                 k_rope.float())) / math.sqrt(dn + dr)
        mask = torch.arange(Skv, device=x.device) <= cache_index
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1).to(c_kv.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", w, c_kv)
        out = torch.einsum("bqhr,rhv->bqhv", ctx,
                           p["wv_b"].reshape(kvr, H, dv))
        return (constrain_batch(out.reshape(B, S, H * dv))
                @ wcl(p["wo"], (0,))), cache
    k_nope = constrain_batch((c_kv @ wcl(p["wk_b"], (1,)))
                             .reshape(B, Skv, H, dn))
    vfull = constrain_batch((c_kv @ wcl(p["wv_b"], (1,)))
                            .reshape(B, Skv, H, dv))
    kfull = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Skv, H, dr)],
                      dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    if cache is None:
        out = ops.attention(qfull, kfull, vfull, causal=True)
    else:
        out = attend(qfull, kfull, vfull,
                     _causal_window_mask(S, Skv, -1, cache_index, x.device))
    return (constrain_batch(out.reshape(B, S, H * dv))
            @ wcl(p["wo"], (0,))), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(pf: ParamFactory, d: int, f: int) -> dict:
    return {"w_gate": pf.leaf((d, f), ("embed", "mlp")),
            "w_up": pf.leaf((d, f), ("embed", "mlp")),
            "w_down": pf.leaf((f, d), ("mlp", "embed"))}


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    g = x @ wcl(p["w_gate"], (1,))
    u = x @ wcl(p["w_up"], (1,))
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ wcl(p["w_down"], (0,))


# ---------------------------------------------------------------------------
# MoE with capacity-based scatter dispatch
# ---------------------------------------------------------------------------

def init_moe(pf: ParamFactory, cfg: ModelConfig) -> dict:
    """Router [D, E] (normal × 0.006), the experts' SwiGLU weights
    stacked over E, and the shared expert's MLP when the config has
    one."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    p = {"router": pf.leaf((D, E), ("embed", None), scale=0.006),
         "w_gate": pf.leaf((E, D, F), ("expert", "embed", "moe_mlp")),
         "w_up": pf.leaf((E, D, F), ("expert", "embed", "moe_mlp")),
         "w_down": pf.leaf((E, F, D), ("expert", "moe_mlp", "embed"))}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(pf, D, (cfg.moe_d_ff or cfg.d_ff)
                               * cfg.n_shared_experts)
    return p


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a dispatch of ``n_tokens`` tokens:
    ``max(8, ceil8(ceil(T·k·cf / E)))``, the reference's float
    arithmetic."""
    c = int(math.ceil(n_tokens * cfg.experts_per_token
                      * cfg.capacity_factor / cfg.n_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


class MoeRouting(NamedTuple):
    """One dispatch's routing. ``probs`` [T, E] f32 router softmax;
    ``gate`` [T, k] f32, renormalised over the top k; ``expert`` [T·k]
    the flat expert ids (token-major); ``slot`` [T·k] each choice's place
    in its expert, first come first served, ``capacity`` for a dropped
    one; ``keep`` [T·k] bool; ``counts`` [E] f32 the choices of each
    expert, dropped ones included."""
    probs: torch.Tensor
    gate: torch.Tensor
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    capacity: int


def moe_route(p, cfg: ModelConfig, xf: torch.Tensor) -> MoeRouting:
    """Route the tokens ``xf`` [T, D]. The router product is taken in f32
    (the reference's ``preferred_element_type``: a bf16 product is exact
    in f32), then softmax and top-k, the gate renormalised with a clip at
    1e-9. A choice's place in its expert is its rank among the choices of
    that expert in token order: a stable sort of the flat ids, and each
    expert's first index in it (``searchsorted``)."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    C = moe_capacity(T, cfg)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = eidx.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(E, device=xf.device)
    starts = torch.searchsorted(sorted_e, experts)
    ends = torch.searchsorted(sorted_e, experts, right=True)
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(T * k, device=xf.device) - starts[sorted_e]
    keep = pos < C
    return MoeRouting(probs, gate, flat_e, torch.where(keep, pos, C), keep,
                      (ends - starts).float(), C)


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routing with per-expert capacity C = ``moe_capacity(B·S)``;
    a dropped choice adds nothing (the token passes through the
    residual). Returns (y [B,S,D], aux).

    Dispatch: each choice's token is written into ``[E, C+1, D]`` at
    (expert, slot); the dropped ones land in slot C, which is sliced off
    (the reference's scatter with ``mode="drop"``). The expert FFN is one
    product batched over E for each weight, silu in f32 cast back to
    x.dtype. Combine: each choice reads its row back (a dropped one reads
    any row and is zeroed), times its gate in x.dtype, summed over k;
    plus the shared expert. ``aux`` is the switch load-balance loss
    ``E · Σ_e mean_t(probs) · counts_e / (T·k)``, with no gradient
    through the counts."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, D)
    r = moe_route(p, cfg, xf)
    C = r.capacity
    tok = torch.arange(T * k, device=x.device) // k
    buf = x.new_zeros((E, C + 1, D)).index_put((r.expert, r.slot), xf[tok])
    buf = constrain_expert(buf[:, :C])
    g = torch.bmm(buf, wcl(p["w_gate"], (0,)))
    u = torch.bmm(buf, wcl(p["w_up"], (0,)))
    h = F.silu(g.float()).to(x.dtype) * u
    out = constrain_expert(torch.bmm(h, wcl(p["w_down"], (0,))))  # [E,C,D]
    y_tok = out[r.expert, torch.where(r.keep, r.slot, 0)]
    y_tok = torch.where(r.keep[:, None], y_tok, 0.0)
    y_tok = y_tok * r.gate.reshape(T * k)[:, None].to(y_tok.dtype)
    y = y_tok.reshape(T, k, D).sum(dim=1).reshape(B, S, D)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x)
    aux = E * torch.sum(r.probs.mean(dim=0) * (r.counts / (T * k)))
    return y, aux


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embed(pf: ParamFactory, cfg: ModelConfig) -> dict:
    p = {"tok": pf.leaf((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                        scale=0.02)}
    if not cfg.tie_embeddings:
        p["out"] = pf.leaf((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return p


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def logits_apply(p, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        return torch.einsum("bsd,vd->bsv", x, p["tok"])
    return x @ p["out"]
