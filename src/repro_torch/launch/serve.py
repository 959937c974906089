"""Serving launcher: ``python -m repro_torch.launch.serve --arch yi-6b``.

Batched greedy decoding with the per-family cache (full-length KV cache
for dense GQA, recurrent state for RWKV6): teacher-forced ``decode_step``
over a seeded random prompt, then greedy decoding; llama4-maverick's
dense/MoE pairs take token batches, each decode step one MoE dispatch
of B tokens. The vision-language
``qwen2-vl-7b`` runs text-only here, as in the reference: token ids and
the standard rotation of 2-D positions. Counterpart of
``repro.launch.serve``; ``--full`` takes the published configuration,
otherwise the smoke configuration. Runs on the CUDA card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import registry
from ..device import resolve_device
from ..models import decode as D
from ..models import transformer as T


def generate(params, cfg, prompts: torch.Tensor, new_tokens: int):
    """prompts [B,P] → greedy continuation [B,new_tokens]. The prompt is
    fed token by token through ``decode_step`` (teacher forcing); the
    logits of its last token give the first new token."""
    B, P = prompts.shape
    cache = D.cache_zeros(D.cache_spec(cfg, B, P + new_tokens),
                          prompts.device)
    generated = []
    for t in range(P + new_tokens - 1):
        inp = prompts[:, t:t + 1] if t < P else generated[-1]
        logits, cache = D.decode_step(params, cfg,
                                      {"token": inp, "index": t}, cache)
        if t >= P - 1:
            generated.append(torch.argmax(logits, dim=-1)[:, None])
    return torch.cat(generated, dim=1)


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
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    gen = generate(params, cfg, prompts, N)
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
