"""LM assembly for the ported families: dense GQA stacks (yi-6b; and
qwen2-vl-7b, whose vision-language backbone is the dense block with
M-RoPE over stub embeddings) and the attention-free RWKV6 stack
(rwkv6-3b). Counterpart of ``repro.models.transformer`` for those
families.

The reference stacks each homogeneous segment's parameters along a
leading layer axis and runs it under ``lax.scan``; the port keeps one
parameter tree per layer (an ``nn.ModuleList`` per segment) and loops over
the layers in Python. MLA, MoE, the hybrid (hymba) and encoder-decoder
(whisper) families are not ported yet (ROADMAP.md queue 1 item 12).

Training: the losses (``ce_loss``, ``ce_loss_seqchunk``, ``lm_loss``) are
the reference's for the dense, vision-language and RWKV6 families. The
reference saves nothing inside a layer (``REMAT_POLICY =
nothing_saveable`` on each scanned block); the port runs each block
under non-reentrant ``torch.utils.checkpoint`` whenever grad is enabled,
so the backward recomputes the block's forward (flash kernel included)
from the block's input, and the loss runs each 512-token chunk of the
head and log-softmax under its own checkpoint, never holding the
[B,S,V] f32 logits.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from . import ssm as S
from .common import ModelConfig, ParamFactory, ParamTree

# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.attn_kind != "gqa" or cfg.family not in ("dense", "vlm") \
            or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA blocks are ported (attn_kind "
            f"{cfg.attn_kind!r}, family {cfg.family!r}); ROADMAP.md queue 1 "
            f"item 12")


def init_block(pf: ParamFactory, cfg: ModelConfig) -> dict:
    """Dense GQA block: pre-norm attention and SwiGLU MLP (also the
    vision-language backbone's)."""
    _check_dense(cfg)
    return {"ln1": L.init_rmsnorm(pf, cfg.d_model),
            "ln2": L.init_rmsnorm(pf, cfg.d_model),
            "attn": L.init_gqa(pf, cfg),
            "mlp": L.init_mlp(pf, cfg.d_model, cfg.d_ff)}


def block_apply(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, window: int, cache=None,
                cache_index=None):
    """One transformer block. Returns (x, new_cache). The reference also
    returns an auxiliary MoE loss, which is always 0 without MoE."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, nc = L.gqa_apply(p["attn"], cfg, h, positions, window=window,
                        cache=None if cache is None else cache["attn"],
                        cache_index=cache_index)
    x = x + a
    y = L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + y, (None if nc is None else {"attn": nc})


# rwkv6 block -----------------------------------------------------------------

def init_rwkv_block(pf: ParamFactory, cfg: ModelConfig) -> dict:
    return {"ln1": L.init_rmsnorm(pf, cfg.d_model),
            "ln2": L.init_rmsnorm(pf, cfg.d_model),
            "tmix": S.init_rwkv6(pf, cfg),
            "cmix": S.init_channel_mix(pf, cfg.d_model, cfg.d_ff)}


def rwkv_block_apply(p, cfg: ModelConfig, x: torch.Tensor, *, cache=None):
    """Returns (x, new_cache). Decode: ``cache["state"]`` is the flattened
    [B, H·hd, hd] f32 state; the new state comes back in a new tensor."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cache is None:
        y = S.rwkv6_chunked(p["tmix"], cfg, h)
        nc = None
    else:
        H = cfg.ssm_heads or cfg.n_heads
        hd = cfg.d_model // H
        B = h.shape[0]
        st_in = cache["state"].reshape(B, H, hd, hd)
        y, st = S.rwkv6_decode_step(p["tmix"], cfg, h, st_in)
        nc = {"state": st.reshape(B, H * hd, hd)}
    x = x + y
    x = x + S.channel_mix(p["cmix"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, nc


# ---------------------------------------------------------------------------
# stack plan
# ---------------------------------------------------------------------------

def plan_segments(cfg: ModelConfig) -> list[dict]:
    """Layer plan → list of segments, each {kind, n, ...}, as the
    reference plans them for the ported families."""
    if cfg.family == "ssm" and cfg.ssm_kind == "rwkv6":
        return [{"kind": "rwkv", "n": cfg.n_layers, "scanned": True}]
    _check_dense(cfg)
    return [{"kind": "block", "n": cfg.n_layers, "moe": False,
             "window": cfg.window, "scanned": True}]


def init_segment(pf: ParamFactory, cfg: ModelConfig, seg: dict) -> list:
    """One parameter tree per layer of the segment."""
    init = init_rwkv_block if seg["kind"] == "rwkv" else init_block
    return [init(pf, cfg) for _ in range(seg["n"])]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The language model's parameters: ``embed``, ``ln_f`` and
    ``segments["seg<i>"]``, a list of per-layer trees. Indexes like the
    reference's parameter dict (``lm["embed"]["tok"]``);
    ``forward(tokens)`` returns the final hidden states."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.ln_f = ParamTree(tree["ln_f"])
        self.segments = nn.ModuleDict({
            name: nn.ModuleList(ParamTree(layer) for layer in layers)
            for name, layers in tree["segments"].items()})

    def __getitem__(self, key: str):
        if key not in ("embed", "ln_f", "segments"):
            raise KeyError(key)
        return getattr(self, key)

    def keys(self) -> list:
        return ["embed", "ln_f", "segments"]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, Sq = tokens.shape
        positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
        return backbone_forward(self, self.cfg,
                                L.embed_apply(self["embed"], tokens),
                                positions)


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device=None) -> LM:
    """Draw the model's parameters from ``generator`` (a torch.Generator
    on ``device``) in ``cfg.dtype``. ``device`` defaults to the CUDA card
    and raises without one; ``"meta"`` gives shapes without arrays."""
    pf = ParamFactory(generator, cfg.dtype, resolve_device(device))
    tree = {"embed": L.init_embed(pf, cfg),
            "ln_f": L.init_rmsnorm(pf, cfg.d_model)}
    tree["segments"] = {f"seg{i}": init_segment(pf, cfg, s)
                        for i, s in enumerate(plan_segments(cfg))}
    return LM(cfg, tree)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def remat(fn, *args):
    """``fn(*args)``; under non-reentrant activation checkpointing when
    grad is enabled (the counterpart of ``jax.checkpoint`` with
    ``nothing_saveable``). The functions it wraps draw no random numbers,
    so the RNG state is not saved."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def backbone_forward(params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] (after the embedding; positions [B,S], or [3,B,S] for
    M-RoPE) → final-normed hidden [B,S,D]. The reference also returns the
    summed MoE auxiliary loss (0 here). With grad enabled each block runs
    under :func:`remat`."""
    for i, seg in enumerate(plan_segments(cfg)):
        for lp in params["segments"][f"seg{i}"]:
            if seg["kind"] == "rwkv":
                def body(h, lp=lp):
                    return rwkv_block_apply(lp, cfg, h)[0]
            else:
                def body(h, lp=lp, window=seg["window"]):
                    return block_apply(lp, cfg, h, positions,
                                       window=window)[0]
            x = remat(body, x)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def ce_loss(logits: torch.Tensor, targets: torch.Tensor,
            weights: torch.Tensor | None = None) -> torch.Tensor:
    """logits [B,S,V] (any float dtype), targets int [B,S] → mean
    next-token negative log-likelihood in f32 (weighted mean with
    ``weights``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - gold
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _chunk_nll(embed_params, tie: bool, h_c, t_c, w_c):
    logits = L.logits_apply(embed_params, h_c, tie).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t_c[..., None])[..., 0]
    return ((lse - gold) * w_c).sum()


def ce_loss_seqchunk(embed_params, hidden: torch.Tensor,
                     targets: torch.Tensor, tie: bool,
                     weights: torch.Tensor | None = None, shift: int = 1,
                     chunk: int = 512) -> torch.Tensor:
    """Sequence-chunked next-token CE: predicts token t + ``shift`` from
    hidden [B,S,D]. Each ``chunk`` of positions computes its [B,chunk,V]
    logits, reduces them and (with grad enabled) drops them: the backward
    recomputes each chunk (:func:`remat`). S not a multiple of ``chunk``
    runs as one chunk, as in the reference."""
    B, S, _ = hidden.shape
    pad = torch.zeros((B, shift), dtype=targets.dtype, device=targets.device)
    tgt = torch.cat([targets[:, shift:], pad], dim=1)
    w = torch.cat([torch.ones((B, S - shift), device=hidden.device),
                   torch.zeros((B, shift), device=hidden.device)], dim=1)
    if weights is not None:
        w = w * weights.float()
    if S % chunk != 0:
        chunk = S
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        tot = tot + remat(lambda h_c, t_c, w_c: _chunk_nll(
            embed_params, tie, h_c, t_c, w_c), hidden[:, sl], tgt[:, sl],
            w[:, sl])
        cnt = cnt + w[:, sl].sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg: ModelConfig, batch: dict):
    """Next-token loss of the dense, vision-language and RWKV6 families.
    batch: tokens [B,S], or the stub frontend's embeds [B,S,D] (then
    labels [B,S]); optional positions ([B,S], or [3,B,S] for M-RoPE),
    labels, loss_weights. Returns (loss, metrics) with metrics ``ce`` and
    ``aux`` (the MoE auxiliary loss, always 0 here). The hybrid,
    encoder-decoder and MTP branches of the reference raise."""
    if cfg.is_encoder_decoder or cfg.family == "hybrid" or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: lm_loss of the {cfg.family} family (encoder-"
            f"decoder, hybrid or MTP) is not ported: ROADMAP.md queue 1 "
            f"item 12")
    if "embeds" in batch:                         # vlm stub frontend
        x = batch["embeds"].to(cfg.dtype)
        B, Sq = x.shape[:2]
    else:
        x = L.embed_apply(params["embed"], batch["tokens"])
        B, Sq = batch["tokens"].shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    hidden = backbone_forward(params, cfg, x, positions)
    targets = batch["labels"] if "labels" in batch else batch["tokens"]
    loss = ce_loss_seqchunk(params["embed"], hidden, targets,
                            cfg.tie_embeddings,
                            weights=batch.get("loss_weights"), shift=1)
    aux = torch.zeros((), device=hidden.device)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}
