"""LM assembly for the ported families: dense GQA stacks (yi-6b) and the
attention-free RWKV6 stack (rwkv6-3b). Counterpart of
``repro.models.transformer`` for those families.

The reference stacks each homogeneous segment's parameters along a
leading layer axis and runs it under ``lax.scan``; the port keeps one
parameter tree per layer (an ``nn.ModuleList`` per segment) and loops over
the layers in Python. MLA, MoE, the hybrid (hymba) and encoder-decoder
(whisper) families, ``lm_loss`` and the training path are not ported
yet (ROADMAP.md queue 1 items 12-13).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from . import ssm as S
from .common import ModelConfig, ParamFactory, ParamTree

# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.attn_kind != "gqa" or cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA blocks are ported (attn_kind "
            f"{cfg.attn_kind!r}, family {cfg.family!r}); ROADMAP.md queue 1 "
            f"item 12")


def init_block(pf: ParamFactory, cfg: ModelConfig) -> dict:
    """Dense GQA block: pre-norm attention and SwiGLU MLP."""
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

def backbone_forward(params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] (after the embedding) → final-normed hidden [B,S,D]. The
    reference also returns the summed MoE auxiliary loss (0 here)."""
    for i, seg in enumerate(plan_segments(cfg)):
        for lp in params["segments"][f"seg{i}"]:
            if seg["kind"] == "rwkv":
                x, _ = rwkv_block_apply(lp, cfg, x)
            else:
                x, _ = block_apply(lp, cfg, x, positions,
                                   window=seg["window"])
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
