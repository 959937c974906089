"""Prefill and single-token decode (the serving path) for every family.
Counterpart of ``repro.models.decode``.

The cache keeps the reference's pytree (``cache_spec``):
``{"seg0": {"attn": {"k", "v": [n, B, L, K·h]}}}`` for a dense GQA stack,
``{"seg0": {"dense": {"attn": ...}, "moe": {"attn": ...}}}`` (each
``[n, B, L, K·h]`` over the n pairs) for dense/MoE pairs, MLA's
compressed cache ``{"attn": {"c_kv": [n, B, L, kvr], "k_rope": [n, B,
L, dr]}}`` in each of deepseek-v3's two segments (the dense prefix, then
the MoE layers; ``layers.mla_apply``),
``{"seg0": {"state": [n, B, H·hd, hd]}}`` (f32) for an RWKV6 stack, and
for the hybrid family (hymba) one entry per segment with the Mamba state
beside the attention cache, ``{"attn": {"k", "v"}, "ssm": [B, d, N]}``
(f32), with no layer axis for an unscanned (global) layer; the
encoder-decoder (whisper) adds the cross-attention's keys and values of
the encoder memory, ``{"cross": {"k", "v": [n, B, T, K·h]}}``, filled
once (:func:`fill_cross_cache`) and only read by the decode steps. A
sliding-window layer's cache holds ``min(window, L)`` slots: a ring
buffer (``layers.gqa_apply``). :func:`decode_step` updates the cache
IN PLACE (the reference returns a new one) and returns the same dict;
the tests hold the updated cache equal to the reference's new cache.

The hybrid family's sequence runs behind its 128 meta tokens, as
``transformer.lm_loss`` runs it. :func:`decode_step` offsets the cache
slot and the 2-D positions by 128, as the reference's does; a caller
first writes the meta tokens into slots 0-127 (``launch.serve.generate``
feeds them as ``embeds`` at index -128 ... -1 with positions -128, i.e.
rotation 0), and sizes the cache at 128 + the sequence. :func:`prefill`
puts the meta tokens before the prompt. The reference's ring mask, its
prefill and its serving launcher differ (ROADMAP.md queue 3): see
``layers.gqa_apply`` and :func:`prefill`.

The encoder-decoder's step (:func:`decode_step_encdec`) runs each
decoder layer's sublayers in the order of ``transformer.encdec_forward``,
the model ``lm_loss`` trains: self-attention, the MLP, then
cross-attention. The reference's ``decode_step_encdec`` runs the
cross-attention before the MLP, so its decode is not its forward
(ROADMAP.md queue 3).

``index`` is a Python int, or a 0-d integer tensor on the card: then no
op of :func:`decode_step` or :func:`decode_step_encdec` reads a value
back to the host, and a captured CUDA graph of the step replays with the
index buffer's new value (``launch.serve.generate`` on the card).
"""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from . import layers as L
from . import ssm as S
from .common import ModelConfig
from .transformer import (META_TOKENS, block_apply, encdec_forward,
                          lm_hidden, plan_segments, rwkv_block_apply,
                          segment_layers)

# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def _kv_len(seq_len: int, window: int) -> int:
    return seq_len if window <= 0 else min(window, seq_len)


def block_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                     window: int) -> dict:
    """{"attn": {"k", "v": ((batch, L, K·h), dtype)}} for a GQA block, L
    = ``min(window, seq_len)`` for a sliding-window layer; {"attn":
    ``layers.mla_cache_spec``} for an MLA block (no window); the hybrid
    family adds the Mamba state ``"ssm"``: ((batch, d_model, N), f32)."""
    if cfg.attn_kind == "mla":
        return {"attn": L.mla_cache_spec(cfg, batch, seq_len)}
    Lkv = _kv_len(seq_len, window)
    kv = cfg.n_kv_heads * cfg.hd
    spec = {"attn": {"k": ((batch, Lkv, kv), cfg.dtype),
                     "v": ((batch, Lkv, kv), cfg.dtype)}}
    if cfg.family == "hybrid":
        spec["ssm"] = S.mamba_state_spec(cfg, batch, cfg.d_model)
    return spec


def _prepend(spec, n: int):
    if isinstance(spec, tuple):
        shape, dt = spec
        return ((n, *shape), dt)
    return {k: _prepend(v, n) for k, v in spec.items()}


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Full cache spec: nested dicts of (shape, dtype) leaves. ``seq_len``
    is the number of slots of a full-length cache; a hybrid model's
    sequence needs 128 more for its meta tokens. The encoder-decoder's
    ``"cross"`` holds k and v [n_layers, batch, encoder_len, K·h] in
    ``cfg.dtype``."""
    out = {}
    for i, seg in enumerate(plan_segments(cfg)):
        if seg["kind"] == "rwkv":
            H = cfg.ssm_heads or cfg.n_heads
            hd = cfg.d_model // H
            leaf = {"state": ((seg["n"], batch, H * hd, hd), torch.float32)}
        elif seg["kind"] == "pair":
            leaf = {part: _prepend(block_cache_spec(cfg, batch, seq_len,
                                                    seg["window"]), seg["n"])
                    for part in ("dense", "moe")}
        else:
            leaf = block_cache_spec(cfg, batch, seq_len, seg["window"])
            if seg["scanned"]:
                leaf = _prepend(leaf, seg["n"])
        out[f"seg{i}"] = leaf
    if cfg.is_encoder_decoder:
        kv = ((cfg.n_layers, batch, cfg.encoder_len,
               cfg.n_kv_heads * cfg.hd), cfg.dtype)
        out["cross"] = {"k": kv, "v": kv}
    return out


def cache_zeros(spec, device=None) -> Any:
    """Zero cache on ``device`` (default: the CUDA card; raises without
    one)."""
    dev = resolve_device(device)
    if isinstance(spec, tuple):
        return torch.zeros(spec[0], dtype=spec[1], device=dev)
    return {k: cache_zeros(v, dev) for k, v in spec.items()}


def cache_abstract(spec) -> Any:
    """The cache of ``spec`` on the meta device: its shapes and dtypes,
    no storage (the reference's ``ShapeDtypeStruct`` leaves)."""
    return cache_zeros(spec, "meta")


# ---------------------------------------------------------------------------
# decode: one new token against a filled cache
# ---------------------------------------------------------------------------

def _check_device(params, t: torch.Tensor) -> None:
    if t.device != params["embed"]["tok"].device:
        raise ValueError(f"inputs on {t.device}, parameters on "
                         f"{params['embed']['tok'].device}")


def _inputs(params, cfg: ModelConfig, batch: dict, key: str) -> torch.Tensor:
    """The first layer's input [B,S,D]: the stub frontend's ``embeds``
    (in ``cfg.dtype``) when the batch has them, else the embedding of
    ``batch[key]`` (token ids)."""
    ref = batch["embeds"] if "embeds" in batch else batch[key]
    _check_device(params, ref)
    if "embeds" in batch:
        return ref.to(cfg.dtype)
    return L.embed_apply(params["embed"], ref)


def _index_positions(index, batch: int, device) -> torch.Tensor:
    """int32 [batch, 1] 2-D positions equal to ``index`` (an int, or a 0-d
    tensor read on the device, not on the host)."""
    if isinstance(index, int):
        return torch.full((batch, 1), index, dtype=torch.int32,
                          device=device)
    return index.to(torch.int32).reshape(1, 1).expand(batch, 1)


def _layer_cache(c: dict, n: int | None) -> dict:
    """Layer n's views of a segment's stacked cache (the cache itself for
    an unscanned segment, n None)."""
    return {k: _layer_cache(v, n) if isinstance(v, dict)
            else v if n is None else v[n] for k, v in c.items()}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: dict, cache: dict):
    """batch: {"token": [B,1] int (or "embeds": [B,1,D]), "index": cache
    slot of the token (an int, or a 0-d integer tensor on the cache's
    device), optional "positions": [B,1], or [3,B,1] for M-RoPE}. The
    cache slot and the causal mask follow ``index``; the rotation follows
    ``positions`` (default: ``index``), which after an image differ. The
    hybrid family offsets the slot and 2-D positions by 128 (its meta
    tokens; index -128 is slot 0). Returns (logits [B,V], cache) with
    the cache updated in place."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} decodes with decode_step_encdec")
    index = batch["index"]
    if not torch.is_tensor(index):
        index = int(index)
    x = _inputs(params, cfg, batch, "token")
    B = x.shape[0]
    positions = batch.get("positions")
    if positions is None:
        positions = _index_positions(index, B, x.device)
    if cfg.family == "hybrid":
        index = index + META_TOKENS
        if positions.dim() == 2:
            positions = positions + META_TOKENS
    for i, seg in enumerate(plan_segments(cfg)):
        c = cache[f"seg{i}"]
        layers = segment_layers(params["segments"][f"seg{i}"])
        if seg["kind"] == "rwkv":
            for n, lp in enumerate(layers):
                x, nc = rwkv_block_apply(lp, cfg, x,
                                         cache={"state": c["state"][n]})
                c["state"][n].copy_(nc["state"])
        elif seg["kind"] == "pair":
            for n, lp in enumerate(layers):
                for part, moe in (("dense", False), ("moe", True)):
                    x, _, _ = block_apply(lp[part], cfg, x, positions,
                                          moe=moe, window=seg["window"],
                                          cache=_layer_cache(c[part], n),
                                          cache_index=index)
        else:
            for n, lp in enumerate(layers):
                x, _, _ = block_apply(
                    lp, cfg, x, positions, moe=seg["moe"],
                    window=seg["window"],
                    cache=_layer_cache(c, n if seg["scanned"] else None),
                    cache_index=index)
    hidden = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.logits_apply(params["embed"], hidden, cfg.tie_embeddings)
    return logits[:, 0], cache


@torch.no_grad()
def fill_cross_cache(params, cfg: ModelConfig, mem: torch.Tensor,
                     cache: dict) -> dict:
    """Write each decoder layer's cross-attention keys and values of the
    encoder memory mem [B, T, D] (``mem @ wk``, ``mem @ wv``, not
    rotated, as the reference's launcher computes them) into
    ``cache["cross"]`` IN PLACE; returns the cache."""
    for n, xp in enumerate(params["cross"]):
        cache["cross"]["k"][n].copy_(mem @ xp["attn"]["wk"])
        cache["cross"]["v"][n].copy_(mem @ xp["attn"]["wv"])
    return cache


@torch.no_grad()
def decode_step_encdec(params, cfg: ModelConfig, batch: dict, cache: dict):
    """The encoder-decoder's step. batch: {"token": [B,1] int (or
    "embeds": [B,1,D]), "index": cache slot and position of the token (an
    int, or a 0-d integer tensor on the cache's device); any other key,
    such as "positions", is not read}; ``cache`` holds the self-attention
    caches and the filled ``"cross"`` keys and values
    (:func:`fill_cross_cache`). Each decoder layer runs its block
    (self-attention against the cache, written IN PLACE at ``index``,
    then the MLP) and then cross-attention of the normed stream to every
    encoder frame (plain ``layers.attend``), the order of
    ``transformer.encdec_forward``. Returns (logits [B,V], cache)."""
    index = batch["index"]
    if not torch.is_tensor(index):
        index = int(index)
    x = _inputs(params, cfg, batch, "token")
    B = x.shape[0]
    positions = _index_positions(index, B, x.device)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    Te = ck.shape[2]
    visible = torch.ones((1, Te), dtype=torch.bool, device=x.device)
    layers = segment_layers(params["segments"]["seg0"])
    for n, (lp, xp) in enumerate(zip(layers, params["cross"])):
        x, _, _ = block_apply(lp, cfg, x, positions, moe=False, window=-1,
                              cache=_layer_cache(cache["seg0"], n),
                              cache_index=index)
        h = L.rmsnorm(xp["ln"], x, cfg.norm_eps)
        q = (h @ xp["attn"]["wq"]).reshape(B, 1, H, hd)
        o = L.attend(q, ck[n].reshape(B, Te, K, hd),
                     cv[n].reshape(B, Te, K, hd), visible)
        x = x + o.reshape(B, 1, H * hd) @ xp["attn"]["wo"]
    hidden = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.logits_apply(params["embed"], hidden, cfg.tie_embeddings)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _batch_rows(batch: dict, rows: slice) -> dict:
    """The batch's rows ``rows``: axis 1 of M-RoPE positions [3,B,S],
    axis 0 of every other value."""
    return {k: v[:, rows] if k == "positions" and v.dim() == 3 else v[rows]
            for k, v in batch.items()}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, batch_chunks: int = 0):
    """batch: {"tokens": [B,S] int, or the stub frontend's "embeds":
    [B,S,D]; optional "positions": [B,S], or [3,B,S] for M-RoPE; for the
    encoder-decoder "frames": [B,T,D], which a chunk takes on axis 0 and
    the forward encodes (``transformer.encdec_forward``)}. Returns
    (last-token logits [B,V], None): the reference's prefill runs the
    full-sequence forward and fills no cache, and so does this one. The
    hybrid family's forward runs the prompt behind its 128 meta tokens,
    as ``lm_loss`` does (``transformer.lm_hidden``); the reference's
    prefill leaves them out (ROADMAP.md queue 3), so its logits are not
    those of the model that ``lm_loss`` trains.

    ``batch_chunks`` > 1 runs the batch in that many chunks, one after
    the other; 0 → 8 chunks for B >= 16, 4 for B >= 8, else 1, as in the
    reference. Without MoE every row is independent, so chunking changes
    nothing. With MoE it does: each chunk is one dispatch whose capacity
    follows the chunk's B/chunks · S tokens, and which tokens are dropped
    depends on the chunk's other rows, as in the reference's ``lax.map``
    over chunks (ROADMAP.md queue 3). A chunk takes its rows of M-RoPE
    positions on their batch axis (1); the reference's chunking swaps the
    position streams and the rows where a chunk holds 3 rows (ROADMAP.md
    queue 3)."""
    B, Sq = (batch["embeds"] if "embeds" in batch
             else batch["tokens"]).shape[:2]
    if batch_chunks == 0:
        batch_chunks = 8 if B >= 16 else (4 if B >= 8 else 1)
    if batch_chunks > 1 and B % batch_chunks == 0:
        n = B // batch_chunks
        return torch.cat([
            prefill(params, cfg, _batch_rows(batch, slice(c * n,
                                                           (c + 1) * n)),
                    batch_chunks=1)[0]
            for c in range(batch_chunks)]), None
    if cfg.is_encoder_decoder:
        _check_device(params, batch["frames"])
        _check_device(params, batch["tokens"])
        hidden, _ = encdec_forward(params, cfg, batch["frames"],
                                   batch["tokens"])
        logits = L.logits_apply(params["embed"], hidden[:, -1:],
                                cfg.tie_embeddings)
        return logits[:, 0], None
    x = _inputs(params, cfg, batch, "tokens")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    hidden, _ = lm_hidden(params, cfg, x, positions)
    logits = L.logits_apply(params["embed"], hidden[:, -1:],
                            cfg.tie_embeddings)
    return logits[:, 0], None
