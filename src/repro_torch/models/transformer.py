"""LM assembly for every family of the reference: dense GQA stacks
(yi-6b; and qwen2-vl-7b, whose vision-language backbone is the dense
block with M-RoPE over stub embeddings), llama4-maverick's dense and MoE
layers in pairs (``moe_interleave=2``), deepseek-v3's MLA blocks (a
dense prefix of ``n_dense_layers``, then MoE layers, and the MTP head),
hymba's hybrid blocks (attention and Mamba heads in parallel on the
same input, sliding-window attention except in the global layers, 128
meta tokens before the sequence), whisper's
encoder-decoder (bidirectional dense blocks over stub frame embeddings,
then decoder blocks each followed by cross-attention to the encoder's
output) and the attention-free RWKV6 stack (rwkv6-3b). Counterpart of
``repro.models.transformer``.

The reference stacks each homogeneous segment's parameters along a
leading layer axis and runs it under ``lax.scan``; the port keeps one
parameter tree per layer (an ``nn.ModuleList`` per segment; a pair
segment holds one ``{"dense", "moe"}`` tree per pair) and loops over the
layers in Python. A segment the reference does not scan (hymba's global
layers) is one layer's tree with no layer axis, as in the reference: a
``ParamTree``, whose leaves ``reference_leaves`` reports unstacked. The
encoder-decoder keeps the reference's ``encoder`` (``{"blocks": one
tree per layer, "ln"}``) and ``cross`` (one ``{"ln", "attn"}`` tree per
decoder layer) beside them; a config with ``mtp`` keeps the reference's
``mtp`` tree (``{"proj", "block", "ln"}``, one block with no layer
axis).

Training: the losses (``ce_loss``, ``ce_loss_seqchunk``, ``lm_loss``
with the MTP term) are the reference's. The reference saves nothing
inside a layer (``REMAT_POLICY = nothing_saveable`` on each scanned
block, pair, or decoder block with its cross-attention); the port runs
each block (each decoder block with its cross-attention, and the MTP
block) under non-reentrant ``torch.utils.checkpoint`` whenever grad is
enabled, so the backward recomputes the block's forward (flash kernel,
Mamba scan and MoE routing included) from the block's input, and the
loss runs each 512-token chunk of the head and log-softmax under its own
checkpoint, never holding the [B,S,V] f32 logits. The recomputed routing is the
forward's: the same ops on the same input (deterministic on the card,
where a train step runs in PyTorch's deterministic mode).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from . import layers as L
from . import ssm as S
from .common import AxesFactory, ModelConfig, ParamFactory, ParamTree
from .pconstraint import constrain_batch

# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


META_TOKENS = 128      # hymba's learned prefix (``meta_tokens`` [128, D])


def _check_ported(cfg: ModelConfig) -> None:
    """The block layouts of the reference's families: GQA or MLA blocks,
    dense (family "dense" or "vlm") or MoE (family "moe": dense and MoE
    layers in pairs with ``moe_interleave`` > 1, else a dense prefix of
    ``n_dense_layers`` and then MoE layers); GQA blocks with Mamba heads
    (family "hybrid") or in the encoder-decoder (family "audio" with
    ``is_encoder_decoder``). Any other combination raises."""
    dense = cfg.family in ("dense", "vlm") and not cfg.n_experts
    moe = cfg.family == "moe" and bool(cfg.n_experts)
    hybrid = cfg.family == "hybrid" and cfg.ssm_kind == "mamba" \
        and not cfg.n_experts
    encdec = cfg.family == "audio" and cfg.is_encoder_decoder \
        and not cfg.n_experts
    attn = cfg.attn_kind == "gqa" \
        or (cfg.attn_kind == "mla" and (dense or moe))
    if not attn or not (dense or moe or hybrid or encdec):
        raise NotImplementedError(
            f"{cfg.name}: no such block layout in the reference's families "
            f"(attn_kind {cfg.attn_kind!r}, family {cfg.family!r}, "
            f"n_experts {cfg.n_experts}, ssm_kind {cfg.ssm_kind!r})")


def init_block(pf: ParamFactory, cfg: ModelConfig, *, moe: bool) -> dict:
    """Pre-norm attention (GQA, or MLA where ``attn_kind`` is "mla"),
    then the SwiGLU MLP, or the MoE with ``moe``. The hybrid family adds
    the Mamba heads (``ssm``, d_inner = d_model) and the two norms of the
    heads' outputs."""
    _check_ported(cfg)
    p = {"ln1": L.init_rmsnorm(pf, cfg.d_model),
         "ln2": L.init_rmsnorm(pf, cfg.d_model),
         "attn": (L.init_mla if cfg.attn_kind == "mla" else L.init_gqa)(
             pf, cfg)}
    if cfg.family == "hybrid":
        p["ssm"] = S.init_mamba(pf, cfg, d_inner=cfg.d_model)
        p["ssm_norm"] = L.init_rmsnorm(pf, cfg.d_model)
        p["attn_norm"] = L.init_rmsnorm(pf, cfg.d_model)
    if moe:
        p["moe"] = L.init_moe(pf, cfg)
    else:
        p["mlp"] = L.init_mlp(pf, cfg.d_model, cfg.d_ff)
    return p


def block_apply(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, moe: bool, window: int,
                cache=None, cache_index=None, causal: bool = True):
    """One transformer block. Returns (x, new_cache, aux): aux is the
    MoE's auxiliary loss with ``moe``, else an f32 zero. ``causal=False``
    makes its attention bidirectional (whisper's encoder; no cache,
    ``layers.gqa_apply``). With a cache
    (one decode step; ``layers.gqa_apply``, a ring in a sliding-window
    layer, or ``layers.mla_apply``'s compressed cache) the cache is
    updated IN PLACE and returned: a hybrid block
    also steps its Mamba state ``cache["ssm"]``. The hybrid block runs
    the attention and the Mamba heads on the same normed input, RMS-norms
    each output and averages them (arXiv:2411.13676 eq. 3). An MLA block
    is causal and takes no window, as in the reference."""
    x = constrain_batch(x)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_cache = None if cache is None else cache["attn"]
    if cfg.attn_kind == "mla":
        if not causal:
            raise ValueError("MLA attention is causal")
        a, nc = L.mla_apply(p["attn"], cfg, h, positions, cache=attn_cache,
                            cache_index=cache_index)
    else:
        a, nc = L.gqa_apply(p["attn"], cfg, h, positions, window=window,
                            cache=attn_cache, cache_index=cache_index,
                            causal=causal)
    if cfg.family == "hybrid":
        if cache is None:
            m = S.mamba_scan(p["ssm"], cfg, h)
        else:
            m, state = S.mamba_decode_step(p["ssm"], cfg, h, cache["ssm"])
            cache["ssm"].copy_(state)
        a = 0.5 * (L.rmsnorm(p["attn_norm"], a, cfg.norm_eps)
                   + L.rmsnorm(p["ssm_norm"], m, cfg.norm_eps))
    x = x + a
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if moe:
        y, aux = L.moe_apply(p["moe"], cfg, h2)
    else:
        y = L.mlp_apply(p["mlp"], h2)
        aux = torch.zeros((), device=x.device)
    return x + y, (None if nc is None else cache), aux


# rwkv6 block -----------------------------------------------------------------

def init_rwkv_block(pf: ParamFactory, cfg: ModelConfig) -> dict:
    return {"ln1": L.init_rmsnorm(pf, cfg.d_model),
            "ln2": L.init_rmsnorm(pf, cfg.d_model),
            "tmix": S.init_rwkv6(pf, cfg),
            "cmix": S.init_channel_mix(pf, cfg.d_model, cfg.d_ff)}


def rwkv_block_apply(p, cfg: ModelConfig, x: torch.Tensor, *, cache=None):
    """Returns (x, new_cache). Decode: ``cache["state"]`` is the flattened
    [B, H·hd, hd] f32 state; the new state comes back in a new tensor."""
    x = constrain_batch(x)
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
    reference plans them. With ``moe_interleave`` > 1 (llama4) one
    ``"pair"`` segment of ``n_layers // moe_interleave`` (dense block,
    MoE block) pairs; with experts and ``moe_interleave`` 1 (deepseek-v3)
    a scanned segment of the ``n_dense_layers`` dense blocks (none if 0),
    then one of the MoE blocks. The hybrid family (hymba): each global
    layer (``global_layers``, default the first, middle and last) is an
    unscanned segment of one full-attention block, and each run of
    layers between them one scanned segment at ``window``."""
    if cfg.family == "ssm" and cfg.ssm_kind == "rwkv6":
        return [{"kind": "rwkv", "n": cfg.n_layers, "scanned": True}]
    _check_ported(cfg)
    if cfg.family == "hybrid":
        glb = set(cfg.global_layers or
                  (0, cfg.n_layers // 2, cfg.n_layers - 1))
        segs, i = [], 0
        while i < cfg.n_layers:
            if i in glb:
                segs.append({"kind": "block", "n": 1, "moe": False,
                             "window": -1, "scanned": False})
                i += 1
                continue
            j = i
            while j < cfg.n_layers and j not in glb:
                j += 1
            segs.append({"kind": "block", "n": j - i, "moe": False,
                         "window": cfg.window, "scanned": True})
            i = j
        return segs
    if cfg.n_experts and cfg.moe_interleave > 1:
        if cfg.n_layers % cfg.moe_interleave:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"pairs of {cfg.moe_interleave}")
        return [{"kind": "pair", "n": cfg.n_layers // cfg.moe_interleave,
                 "moe": True, "window": cfg.window, "scanned": True}]
    if cfg.n_experts:
        dense = [{"kind": "block", "n": cfg.n_dense_layers, "moe": False,
                  "window": cfg.window, "scanned": True}]
        return dense[:bool(cfg.n_dense_layers)] + [
            {"kind": "block", "n": cfg.n_layers - cfg.n_dense_layers,
             "moe": True, "window": cfg.window, "scanned": True}]
    return [{"kind": "block", "n": cfg.n_layers, "moe": False,
             "window": cfg.window, "scanned": True}]


def init_segment(pf: ParamFactory, cfg: ModelConfig, seg: dict):
    """One parameter tree per layer (per pair) of the segment; an
    unscanned segment's one tree, with no layer axis."""
    if not seg["scanned"]:
        return init_block(pf, cfg, moe=seg["moe"])
    if seg["kind"] == "rwkv":
        return [init_rwkv_block(pf, cfg) for _ in range(seg["n"])]
    if seg["kind"] == "pair":
        return [{"dense": init_block(pf, cfg, moe=False),
                 "moe": init_block(pf, cfg, moe=True)}
                for _ in range(seg["n"])]
    return [init_block(pf, cfg, moe=seg["moe"]) for _ in range(seg["n"])]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _module(tree):
    """A layout node as a module: a dict of tensors and dicts a
    :class:`ParamTree`, a list of per-layer dicts an ``nn.ModuleList``,
    a dict holding a list an ``nn.ModuleDict``."""
    if isinstance(tree, list):
        return nn.ModuleList(_module(layer) for layer in tree)
    if any(isinstance(v, list) for v in tree.values()):
        return nn.ModuleDict({k: _module(v) for k, v in tree.items()})
    return ParamTree(tree)


def _layout(module):
    """The inverse of :func:`_module`: nested dicts and lists of the
    parameter tensors."""
    if isinstance(module, nn.ModuleList):
        return [_layout(m) for m in module]
    if isinstance(module, nn.ModuleDict):
        return {k: _layout(m) for k, m in module.items()}
    return module.to_dict()


class LM(nn.Module):
    """The language model's parameters: ``embed``, ``ln_f``,
    ``segments["seg<i>"]`` (a list of per-layer trees, or one layer's
    tree for an unscanned segment); with ``cfg.mtp`` the MTP head's
    ``mtp`` (``{"proj" [2D, D], "block", "ln"}``); for the hybrid family
    ``meta_tokens`` [128, D]; for the encoder-decoder ``encoder``
    (``{"blocks": a list of per-layer trees, "ln"}``) and ``cross`` (a
    list of ``{"ln", "attn"}`` trees, one per decoder layer). Indexes like
    the reference's parameter dict (``lm["embed"]["tok"]``);
    ``forward(tokens)`` returns the tokens' final hidden states
    (:func:`lm_hidden`; the encoder-decoder's need ``frames``,
    :func:`encdec_forward`)."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.ln_f = ParamTree(tree["ln_f"])
        self.segments = nn.ModuleDict({
            name: _module(layers)
            for name, layers in tree["segments"].items()})
        if "meta_tokens" in tree:
            self.meta_tokens = nn.Parameter(tree["meta_tokens"])
        if "mtp" in tree:
            self.mtp = ParamTree(tree["mtp"])
        if "encoder" in tree:
            self.encoder = _module(tree["encoder"])
            self.cross = _module(tree["cross"])

    def __getitem__(self, key: str):
        if key not in self.keys():
            raise KeyError(key)
        return getattr(self, key)

    def keys(self) -> list:
        return ["embed", "ln_f", "segments"] + (
            ["meta_tokens"] if "meta_tokens" in self._parameters else []) + (
            ["mtp"] if "mtp" in self._modules else []) + (
            ["encoder", "cross"] if "encoder" in self._modules else [])

    def tree(self) -> dict:
        """The parameter tensors in the layout :class:`LM` is built from:
        nested dicts, a list of layer dicts per scanned segment (and for
        the encoder's blocks and the cross-attention)."""
        out = {k: _layout(self[k]) for k in self.keys()
               if k != "meta_tokens"}
        if "meta_tokens" in self.keys():
            out["meta_tokens"] = self.meta_tokens.data
        return out

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frames: torch.Tensor | None = None) -> torch.Tensor:
        if self.cfg.is_encoder_decoder:
            return encdec_forward(self, self.cfg, frames, tokens)[0]
        B, Sq = tokens.shape
        positions = torch.arange(Sq, device=tokens.device)[None].expand(B, Sq)
        return lm_hidden(self, self.cfg,
                         L.embed_apply(self["embed"], tokens), positions)[0]


def segment_layers(seg_params) -> list:
    """The per-layer trees of a segment's parameters (or of its cache):
    the list itself, or ``[tree]`` for an unscanned segment."""
    if isinstance(seg_params, (list, tuple, nn.ModuleList)):
        return list(seg_params)
    return [seg_params]


def _lm_tree(pf: ParamFactory, cfg: ModelConfig) -> dict:
    """The model's layout (:meth:`LM.tree`) with ``pf``'s leaves."""
    tree = {"embed": L.init_embed(pf, cfg),
            "ln_f": L.init_rmsnorm(pf, cfg.d_model)}
    tree["segments"] = {f"seg{i}": init_segment(pf, cfg, s)
                        for i, s in enumerate(plan_segments(cfg))}
    if cfg.family == "hybrid":
        tree["meta_tokens"] = pf.leaf((META_TOKENS, cfg.d_model),
                                      (None, "embed"))
    if cfg.mtp:
        tree["mtp"] = {"proj": pf.leaf((2 * cfg.d_model, cfg.d_model),
                                       ("embed", None)),
                       "block": init_block(pf, cfg, moe=False),
                       "ln": L.init_rmsnorm(pf, cfg.d_model)}
    if cfg.is_encoder_decoder:
        tree["encoder"] = {
            "blocks": [init_block(pf, cfg, moe=False)
                       for _ in range(cfg.encoder_layers)],
            "ln": L.init_rmsnorm(pf, cfg.d_model)}
        tree["cross"] = [{"ln": L.init_rmsnorm(pf, cfg.d_model),
                          "attn": L.init_gqa(pf, cfg)}
                         for _ in range(cfg.n_layers)]
    return tree


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device=None) -> LM:
    """Draw the model's parameters from ``generator`` (a torch.Generator
    on ``device``) in ``cfg.dtype``. ``device`` defaults to the CUDA card
    and raises without one; ``"meta"`` gives shapes without arrays."""
    return LM(cfg, _lm_tree(ParamFactory(generator, cfg.dtype,
                                         resolve_device(device)), cfg))


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in the layout of
    :meth:`LM.tree`: nested dicts, one tree per layer in a list for each
    scanned segment, a tuple of axis names (or None) at each leaf. The
    reference's ``init_lm`` returns them as its second value, each
    stacked leaf's with a leading "layers"; the port's per-layer leaf has
    no layer axis (``models.common.reference_leaves`` pairs the two)."""
    return _lm_tree(AxesFactory(), cfg)


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
                     positions: torch.Tensor):
    """x [B,S,D] (after the embedding; positions [B,S], or [3,B,S] for
    M-RoPE) → (final-normed hidden [B,S,D], the MoE auxiliary loss summed
    over the MoE layers, an f32 scalar: 0 without MoE). With grad enabled
    each block runs under :func:`remat`; a pair is its dense block's
    remat, then its MoE block's."""
    aux = torch.zeros((), device=x.device)

    def block(lp, moe: bool, window: int):
        def body(h):
            y, _, a = block_apply(lp, cfg, h, positions, moe=moe,
                                  window=window)
            return y, a
        return body

    for i, seg in enumerate(plan_segments(cfg)):
        for lp in segment_layers(params["segments"][f"seg{i}"]):
            if seg["kind"] == "rwkv":
                x = remat(lambda h, lp=lp: rwkv_block_apply(lp, cfg, h)[0],
                          x)
                continue
            if seg["kind"] == "pair":
                bodies = (block(lp["dense"], False, seg["window"]),
                          block(lp["moe"], True, seg["window"]))
            else:
                bodies = (block(lp, seg["moe"], seg["window"]),)
            for body in bodies:
                x, a = remat(body, x)
                aux = aux + a
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def with_meta_tokens(params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor):
    """hymba: the 128 meta tokens before the sequence ``x`` [B,S,D] (in
    x.dtype, the same for every row), at position 0, with the sequence's
    2-D positions shifted by 128. Returns (x [B,128+S,D], positions)."""
    B = x.shape[0]
    meta = params["meta_tokens"].to(x.dtype)[None].expand(B, -1, -1)
    x = torch.cat([meta, x], dim=1)
    if positions.dim() == 2:
        positions = torch.cat([
            torch.zeros((B, META_TOKENS), dtype=positions.dtype,
                        device=positions.device),
            positions + META_TOKENS], dim=1)
    return x, positions


def lm_hidden(params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor):
    """:func:`backbone_forward` of the sequence x [B,S,D]: for the hybrid
    family with the meta tokens before it (:func:`with_meta_tokens`) and
    their hidden states dropped, as the reference's ``lm_loss`` runs it.
    Returns (hidden [B,S,D], aux)."""
    if cfg.family != "hybrid":
        return backbone_forward(params, cfg, x, positions)
    x, positions = with_meta_tokens(params, cfg, x, positions)
    hidden, aux = backbone_forward(params, cfg, x, positions)
    return hidden[:, META_TOKENS:], aux


def encoder_forward(params, cfg: ModelConfig,
                    frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over the stub frontend's frame embeddings
    [B, T, D] (any float dtype; run in ``cfg.dtype``): the encoder blocks,
    bidirectional (``block_apply(causal=False)``: q and k rotated by the
    frame index, one flash call a block), each under :func:`remat`, then
    the encoder's RMSNorm. Returns the memory [B, T, D]."""
    B, T_ = frames.shape[:2]
    positions = torch.arange(T_, device=frames.device)[None].expand(B, T_)
    x = frames.to(cfg.dtype)
    for lp in params["encoder"]["blocks"]:
        x = remat(lambda h, lp=lp: block_apply(
            lp, cfg, h, positions, moe=False, window=-1, causal=False)[0], x)
    return L.rmsnorm(params["encoder"]["ln"], x, cfg.norm_eps)


def cross_attend(xp, cfg: ModelConfig, x: torch.Tensor,
                 mem: torch.Tensor) -> torch.Tensor:
    """One cross-attention sublayer, residual included: q from the
    RMS-normed stream x [B, S, D], k and v from the encoder memory mem
    [B, T, D], none rotated, every frame visible (one flash call,
    ``causal=False``, Sq = S against Skv = T)."""
    B, Sq = x.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Te = mem.shape[1]
    h = L.rmsnorm(xp["ln"], x, cfg.norm_eps)
    q = (h @ xp["attn"]["wq"]).reshape(B, Sq, H, hd)
    k = (mem @ xp["attn"]["wk"]).reshape(B, Te, K, hd)
    v = (mem @ xp["attn"]["wv"]).reshape(B, Te, K, hd)
    o = ops.attention(q, k, v, causal=False)
    return x + o.reshape(B, Sq, H * hd) @ xp["attn"]["wo"]


def encdec_forward(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor):
    """Whisper's forward: the encoder over ``frames`` [B, T, D], then for
    each decoder layer, in the reference's order, the whole decoder block
    (causal self-attention, then the MLP) and after it the
    cross-attention to the memory (:func:`cross_attend`), the two under
    one :func:`remat`, as the reference checkpoints its scanned body.
    Returns (final-normed decoder hidden [B, S, D], memory [B, T, D])."""
    B, Sd = tokens.shape
    mem = encoder_forward(params, cfg, frames)
    x = L.embed_apply(params["embed"], tokens)
    positions = torch.arange(Sd, device=x.device)[None].expand(B, Sd)

    def body(lp, xp):
        def run(h, m):
            y, _, _ = block_apply(lp, cfg, h, positions, moe=False,
                                  window=-1)
            return cross_attend(xp, cfg, y, m)
        return run

    for lp, xp in zip(segment_layers(params["segments"]["seg0"]),
                      params["cross"]):
        x = remat(body(lp, xp), x, mem)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps), mem


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


def mtp_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
    """deepseek-v3's multi-token prediction term (arXiv:2412.19437
    §2.2): the final-normed hidden [B,S,D], RMS-normed by ``mtp.ln``,
    beside the embedding of the next token (the targets shifted by one,
    padded with token 0), projected [2D → D] by ``mtp.proj``, through the
    dense ``mtp.block`` at positions 0..S-1 (under :func:`remat`, as the
    other blocks), then the CE of token t + 2 (``ce_loss_seqchunk`` with
    ``shift=2``), as the reference computes it."""
    B, S = hidden.shape[:2]
    nxt = torch.cat([targets[:, 1:], torch.zeros(
        (B, 1), dtype=targets.dtype, device=targets.device)], dim=1)
    h_in = torch.cat([L.rmsnorm(params["mtp"]["ln"], hidden, cfg.norm_eps),
                      L.embed_apply(params["embed"], nxt)], dim=-1)
    h_in = h_in @ params["mtp"]["proj"]
    positions = torch.arange(S, device=hidden.device)[None].expand(B, S)
    h2 = remat(lambda h: block_apply(params["mtp"]["block"], cfg, h,
                                     positions, moe=False,
                                     window=cfg.window)[0], h_in)
    return ce_loss_seqchunk(params["embed"], h2, targets,
                            cfg.tie_embeddings, shift=2)


def lm_loss(params, cfg: ModelConfig, batch: dict):
    """Next-token loss of every family. batch: tokens [B,S], or the stub
    frontend's embeds [B,S,D] (then labels [B,S]); for the
    encoder-decoder also frames [B,T,D]; optional positions ([B,S], or
    [3,B,S] for M-RoPE), labels, loss_weights. The hybrid family runs the
    sequence behind its meta tokens (:func:`lm_hidden`), the
    encoder-decoder the tokens against the encoded frames
    (:func:`encdec_forward`). Returns (ce + 0.3·mtp + 0.01·aux, metrics)
    with metrics ``ce``, ``aux`` (the MoE auxiliary loss summed over the
    MoE layers; 0 without MoE) and, with ``cfg.mtp``, ``mtp``
    (:func:`mtp_loss`; the term is 0 without it)."""
    if cfg.is_encoder_decoder:
        hidden, _ = encdec_forward(params, cfg, batch["frames"],
                                   batch["tokens"])
        aux = torch.zeros((), device=hidden.device)
    else:
        if "embeds" in batch:                     # vlm stub frontend
            x = batch["embeds"].to(cfg.dtype)
            B, Sq = x.shape[:2]
        else:
            x = L.embed_apply(params["embed"], batch["tokens"])
            B, Sq = batch["tokens"].shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(Sq, device=x.device)[None].expand(B,
                                                                        Sq)
        hidden, aux = lm_hidden(params, cfg, x, positions)
    targets = batch["labels"] if "labels" in batch else batch["tokens"]
    ce = ce_loss_seqchunk(params["embed"], hidden, targets,
                          cfg.tie_embeddings,
                          weights=batch.get("loss_weights"), shift=1)
    metrics = {"ce": ce, "aux": aux}
    loss = ce
    if cfg.mtp:
        metrics["mtp"] = mtp_loss(params, cfg, hidden, targets)
        loss = loss + 0.3 * metrics["mtp"]
    return loss + 0.01 * aux, metrics
