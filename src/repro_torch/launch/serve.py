"""Serving launcher: ``python -m repro_torch.launch.serve --arch yi-6b``.

Batched greedy decoding with the per-family cache (full-length KV cache
for dense GQA, recurrent state for RWKV6, for hymba a ring of ``window``
slots in each sliding-window layer, full-length caches in its global
layers and the Mamba state): teacher-forced ``decode_step`` over a
seeded random prompt, then greedy decoding; llama4-maverick's dense/MoE
pairs take token batches, each decode step one MoE dispatch of B tokens.
The vision-language ``qwen2-vl-7b`` runs text-only here, as in the
reference: token ids and the standard rotation of 2-D positions.
Counterpart of ``repro.launch.serve``; ``--full`` takes the published
configuration, otherwise the smoke configuration. Runs on the CUDA card
unless ``--device cpu`` is given. On the card each decode step is one
captured CUDA graph, replayed (the step reads nothing back to the host);
on the CPU it runs eagerly.

The hybrid family (hymba) decodes behind its 128 meta tokens, as its
loss runs it: ``generate`` sizes every cache at 128 + P + N slots and
writes the meta tokens first. The reference's launcher sizes the caches
at P + N and never writes them, so its decode is not the model's
(ROADMAP.md queue 3).

The encoder-decoder (whisper) takes the stub frontend's frame
embeddings: ``generate`` encodes them once, writes the cross-attention
keys and values into the cache (``decode.fill_cross_cache``) before the
step is captured, and decodes with ``decode.decode_step_encdec``, whose
graph reads those same cross tensors at every replay. ``main`` draws the
frames from a seed, as the reference's launcher does.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import registry
from ..device import resolve_device
from ..models import decode as D
from ..models import layers as L
from ..models import transformer as T


def _decode_fn(params, cfg, cache: dict, batch: int, dev: torch.device):
    """``step(x, index, position) -> logits``: one ``decode_step`` (for
    the encoder-decoder ``decode_step_encdec``, whose position is its
    index) of the inputs' embeddings x [batch,1,D] at cache slot
    ``index`` with 2-D positions ``position`` (ints), the cache (on
    ``dev``) updated in place. On a CUDA device the step is one CUDA
    graph, captured once
    against ``cache`` after a warm-up step on a copy of it (on a side
    stream), and each call copies its inputs into the graph's buffers
    and replays it; the logits it returns are the graph's output buffer,
    which the next call overwrites. Elsewhere the step runs eagerly."""
    fn = D.decode_step_encdec if cfg.is_encoder_decoder else D.decode_step
    if dev.type != "cuda":
        def eager(x, index, position):
            pos = torch.full((batch, 1), position, dtype=torch.int32,
                             device=dev)
            return fn(params, cfg, {"embeds": x, "index": index,
                                    "positions": pos}, cache)[0]
        return eager
    inputs = {"embeds": torch.zeros((batch, 1, cfg.d_model),
                                    dtype=cfg.dtype, device=dev),
              "index": torch.zeros((), dtype=torch.int64, device=dev),
              "positions": torch.zeros((batch, 1), dtype=torch.int32,
                                       device=dev)}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        scratch = _map(lambda t: t.clone(), cache)
        fn(params, cfg, inputs, scratch)
        del scratch
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = fn(params, cfg, inputs, cache)

    def replay(x, index, position):
        inputs["embeds"].copy_(x)
        inputs["index"].fill_(index)
        inputs["positions"].fill_(position)
        graph.replay()
        return logits
    replay.graph = graph
    return replay


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def generate(params, cfg, prompts: torch.Tensor, new_tokens: int, *,
             frames: torch.Tensor | None = None,
             return_logits: bool = False, on_phase=None):
    """prompts [B,P] → greedy continuation [B,new_tokens]. The prompt is
    fed token by token through ``decode_step`` (teacher forcing); the
    logits of its last token give the first new token. A hybrid model
    first writes its 128 meta tokens (``embeds`` at index -128 ... -1,
    positions -128: rotation 0, as ``lm_loss`` places them) into caches
    of 128 + P + new_tokens slots. An encoder-decoder takes ``frames``
    [B,T,D]: it encodes them once (``transformer.encoder_forward``) and
    fills the cache's cross keys and values (``decode.fill_cross_cache``)
    before the step is built, then decodes with ``decode_step_encdec``.
    On the card each step replays one captured CUDA graph
    (:func:`_decode_fn`). With ``return_logits`` also returns the logits
    of every step after the meta tokens, [B, P + new_tokens - 1, V] in
    the model's dtype. ``on_phase(name)``, if given, is called after the
    frames are encoded ("encode", encoder-decoder only), after the step
    is ready ("step"), after the meta tokens ("meta"), the prompt
    ("prompt") and the greedy steps ("greedy"): a caller records CUDA
    events there to time each part."""
    B, P = prompts.shape
    meta = T.META_TOKENS if cfg.family == "hybrid" else 0
    cache = D.cache_zeros(D.cache_spec(cfg, B, meta + P + new_tokens),
                          prompts.device)
    phase = on_phase or (lambda name: None)
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name} generates from frames [B,T,D]")
        with torch.no_grad():
            D.fill_cross_cache(params, cfg,
                               T.encoder_forward(params, cfg, frames), cache)
        phase("encode")
    step = _decode_fn(params, cfg, cache, B, prompts.device)
    phase("step")
    with torch.no_grad():
        for j in range(meta):
            x = params["meta_tokens"][j].to(cfg.dtype).expand(B, 1, -1)
            step(x, j - meta, -meta)
        phase("meta")
        generated, kept = [], []
        tok = prompts[:, :1]
        for t in range(P + new_tokens - 1):
            tok = prompts[:, t:t + 1] if t < P else tok
            logits = step(L.embed_apply(params["embed"], tok), t, t)
            if return_logits:
                kept.append(logits.clone())
            if t >= P - 1:
                tok = torch.argmax(logits, dim=-1)[:, None]
                generated.append(tok)
            if t == P - 1:
                phase("prompt")
        phase("greedy")
    out = torch.cat(generated, dim=1)
    return (out, torch.stack(kept, dim=1)) if return_logits else out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    cfg = (registry.get(args.arch) if args.full
           else registry.get_smoke(args.arch))
    dev = resolve_device(args.device)
    params = T.init_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    B, P, N = args.batch, args.prompt_len, args.new_tokens
    prompts = torch.randint(0, cfg.vocab, (B, P), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    frames = None
    if cfg.is_encoder_decoder:      # the stub frontend's frame embeddings
        frames = torch.randn((B, cfg.encoder_len, cfg.d_model), device=dev,
                             generator=torch.Generator(dev).manual_seed(2)
                             ).to(cfg.dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    gen = generate(params, cfg, prompts, N, frames=frames)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "host CPU")
    print(f"arch={cfg.name} batch={B} prompt={P} new={N} "
          f"{dt:.2f}s  {B * (P + N) / dt:.1f} tok/s ({where})")
    print("sample:", gen[0].tolist())


if __name__ == "__main__":
    main()
