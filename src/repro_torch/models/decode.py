"""Prefill and single-token decode (the serving path) for the ported
families. Counterpart of ``repro.models.decode``.

The cache keeps the reference's pytree (``cache_spec``):
``{"seg0": {"attn": {"k", "v": [n, B, L, K·h]}}}`` for a dense GQA stack,
``{"seg0": {"dense": {"attn": ...}, "moe": {"attn": ...}}}`` (each
``[n, B, L, K·h]`` over the n pairs) for dense/MoE pairs, and
``{"seg0": {"state": [n, B, H·hd, hd]}}`` (f32) for an RWKV6 stack.
:func:`decode_step` updates the cache IN PLACE (the reference returns a
new one) and returns the same dict; the tests hold the updated cache
equal to the reference's new cache.

Full-length GQA caches only: the sliding-window ring buffer (hymba) is
not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from . import layers as L
from .common import ModelConfig
from .transformer import (backbone_forward, block_apply, plan_segments,
                          rwkv_block_apply)

# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def _kv_len(seq_len: int, window: int) -> int:
    return seq_len if window <= 0 else min(window, seq_len)


def block_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                     window: int) -> dict:
    """{"attn": {"k", "v": ((batch, L, K·h), dtype)}} for a GQA block."""
    if cfg.attn_kind != "gqa" or cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: only GQA block caches are ported; ROADMAP.md "
            f"queue 1 item 12")
    Lkv = _kv_len(seq_len, window)
    kv = cfg.n_kv_heads * cfg.hd
    return {"attn": {"k": ((batch, Lkv, kv), cfg.dtype),
                     "v": ((batch, Lkv, kv), cfg.dtype)}}


def _prepend(spec, n: int):
    if isinstance(spec, tuple):
        shape, dt = spec
        return ((n, *shape), dt)
    return {k: _prepend(v, n) for k, v in spec.items()}


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Full cache spec: nested dicts of (shape, dtype) leaves."""
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
            leaf = _prepend(block_cache_spec(cfg, batch, seq_len,
                                             seg["window"]), seg["n"])
        out[f"seg{i}"] = leaf
    return out


def cache_zeros(spec, device=None) -> Any:
    """Zero cache on ``device`` (default: the CUDA card; raises without
    one)."""
    dev = resolve_device(device)
    if isinstance(spec, tuple):
        return torch.zeros(spec[0], dtype=spec[1], device=dev)
    return {k: cache_zeros(v, dev) for k, v in spec.items()}


# ---------------------------------------------------------------------------
# decode: one new token against a filled cache
# ---------------------------------------------------------------------------

def block_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict, index: int, *,
                 moe: bool, window: int):
    """One block, one token, full-length cache. Returns (x, new_cache);
    the cache is updated in place. With ``moe`` the MoE dispatches the B
    tokens of this step (T = B, so C = ``moe_capacity(B)``, 8 for B up
    to 819 at llama4's 128 experts)."""
    W = cache["attn"]["k"].shape[1]
    if not (window <= 0 or W > window):
        raise NotImplementedError(
            "the sliding-window ring-buffer cache is not ported: ROADMAP.md "
            "queue 1 item 12")
    x, nc, _ = block_apply(p, cfg, x, positions, moe=moe, window=window,
                           cache=cache, cache_index=index)
    return x, nc


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


def _layer_cache(c: dict, n: int) -> dict:
    """Layer n's views of a segment's stacked k/v cache."""
    return {"attn": {"k": c["attn"]["k"][n], "v": c["attn"]["v"][n]}}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: dict, cache: dict):
    """batch: {"token": [B,1] int (or "embeds": [B,1,D]), "index": int
    cache slot of the token, optional "positions": [B,1], or [3,B,1] for
    M-RoPE}. The cache slot and the causal mask follow ``index``; the
    rotation follows ``positions`` (default: ``index``), which after an
    image differ. Returns (logits [B,V], cache) with the cache updated in
    place."""
    index = int(batch["index"])
    x = _inputs(params, cfg, batch, "token")
    B = x.shape[0]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.full((B, 1), index, dtype=torch.int32,
                               device=x.device)
    for i, seg in enumerate(plan_segments(cfg)):
        c = cache[f"seg{i}"]
        layers = params["segments"][f"seg{i}"]
        if seg["kind"] == "rwkv":
            for n, lp in enumerate(layers):
                x, nc = rwkv_block_apply(lp, cfg, x,
                                         cache={"state": c["state"][n]})
                c["state"][n].copy_(nc["state"])
        elif seg["kind"] == "pair":
            for n, lp in enumerate(layers):
                for part, moe in (("dense", False), ("moe", True)):
                    x, _ = block_decode(lp[part], cfg, x, positions,
                                        _layer_cache(c[part], n), index,
                                        moe=moe, window=seg["window"])
        else:
            for n, lp in enumerate(layers):
                x, _ = block_decode(lp, cfg, x, positions,
                                    _layer_cache(c, n), index,
                                    moe=seg["moe"], window=seg["window"])
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
    [B,S,D]; optional "positions": [B,S], or [3,B,S] for M-RoPE}. Returns
    (last-token logits [B,V], None): the reference's prefill runs the
    full-sequence forward and fills no cache, and so does this one.

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
    x = _inputs(params, cfg, batch, "tokens")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    hidden, _ = backbone_forward(params, cfg, x, positions)
    logits = L.logits_apply(params["embed"], hidden[:, -1:],
                            cfg.tie_embeddings)
    return logits[:, 0], None
