"""Serving example of the PyTorch port: greedy decoding with each
family's cache (a ring of ``window`` slots in hymba's sliding-window
layers, recurrent state for rwkv6, the cross-attention keys and values
of the encoded frames for whisper) at the smoke size of any ported
architecture. The twin of ``examples/serve_engine.py``; it runs on the
CUDA card (each decode step one captured CUDA graph) unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_engine.py [--arch rwkv6-3b]
        [--new-tokens 24] [--batch 2] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    cfg = registry.get_smoke(args.arch)
    dev = resolve_device(args.device)
    params = T.init_lm(cfg, torch.Generator(dev).manual_seed(0), dev)
    B, P = args.batch, 8
    prompt = torch.randint(0, cfg.vocab, (B, P), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    frames = None
    if cfg.is_encoder_decoder:      # the stub frontend's frame embeddings
        frames = torch.randn((B, cfg.encoder_len, cfg.d_model), device=dev,
                             generator=torch.Generator(dev).manual_seed(2))
    # teacher-force the prompt, then greedy-decode (generate encodes the
    # frames once into the cross cache first)
    gen = generate(params, cfg, prompt, args.new_tokens, frames=frames)
    print(f"{args.arch}: prompt {prompt.tolist()}")
    print(f"generated {gen.shape[1]} tokens/seq: {gen.tolist()}")
    return gen


if __name__ == "__main__":
    main()
