"""Training launcher: ``python -m repro_torch.launch.train --arch qwen3-14b``.
Counterpart of ``repro.launch.train``.

Trains the arch's reduced (smoke) config on synthetic tokens, or with
``--full`` the published config with Adafactor (the reference's
``choose_optimizer(1e12)``), through ``train.trainer.make_train_step``;
checkpoints go through the quorum-commit layer (``--ckpt-every``,
``--resume``). Runs on the CUDA card unless ``--device cpu`` is given;
on the card the step runs with deterministic algorithms
(``train.trainer``). The reference places the state on a host mesh
(``make_host_mesh``, ``tree_shardings``); the port has no counterpart on
one card, and sharding the train state is ROADMAP.md queue 1 item 14.
The MoE family (llama4-maverick, deepseek-v3) trains on token batches
and logs its auxiliary loss; a config with the MTP head (deepseek-v3)
logs its MTP term. The token batches (and, for the vision-language family,
the stub frontend's embeddings, 3-D positions and labels, for the
encoder-decoder the stub frontend's ``encoder_len`` frame embeddings,
as the reference's launcher makes them) come from a ``torch.Generator``
(seed 1), not the reference's ``jax.random`` key.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs import registry
from ..device import resolve_device
from ..models.common import param_count
from ..runtime.checkpoint import restore_sharded, save_sharded
from ..train.optimizer import OptConfig, choose_optimizer
from ..train.trainer import make_state, make_train_step, set_cublas_workspace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":    # before the first cuBLAS call of the process
        set_cublas_workspace()
    cfg = (registry.get(args.arch) if args.full
           else registry.get_smoke(args.arch))
    opt = OptConfig(kind="adamw" if not args.full else
                    choose_optimizer(1e12), lr=args.lr)
    state = make_state(cfg, opt, torch.Generator(dev).manual_seed(0), dev)
    print(f"arch={cfg.name} params={param_count(state['params']):,d} "
          f"opt={opt.kind}")
    step_fn = make_train_step(cfg, opt, microbatches=1,
                              global_batch=args.batch)
    if args.resume:
        try:
            state, m = restore_sharded(state, args.ckpt_dir)
            print(f"resumed from committed step {m['step']}")
        except (FileNotFoundError, IOError):
            print("no committed checkpoint; starting fresh")

    gen = torch.Generator().manual_seed(1)
    t0 = time.time()
    start = int(state["step"])
    for i in range(start, args.steps):
        batch = {"tokens": torch.randint(0, cfg.vocab,
                                         (args.batch, args.seq),
                                         generator=gen)}
        if cfg.family == "vlm":     # the stub frontend's embeddings
            batch["embeds"] = torch.randn(
                (args.batch, args.seq, cfg.d_model),
                generator=gen).to(cfg.dtype)
            batch["positions"] = torch.arange(
                args.seq, dtype=torch.int32)[None, None].expand(
                    3, args.batch, args.seq)
            batch["labels"] = batch["tokens"]
        if cfg.is_encoder_decoder:  # the stub frontend's frame embeddings
            batch["frames"] = torch.randn(
                (args.batch, cfg.encoder_len, cfg.d_model),
                generator=gen).to(cfg.dtype)
        batch = {k: v.to(dev) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if (i + 1) % 10 == 0 or i == start:
            dt = time.time() - t0
            aux = (f"aux {float(metrics['aux']):.4f} " if cfg.n_experts
                   else "") + (f"mtp {float(metrics['mtp']):.4f} "
                               if cfg.mtp else "")
            print(f"step {i + 1:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {aux}"
                  f"({dt / max(i + 1 - start, 1):.2f}s/step)")
        if (i + 1) % args.ckpt_every == 0:
            man = save_sharded(state, args.ckpt_dir, i + 1)
            print(f"  ckpt step {i + 1} committed={man['committed']}")
    print("done")


if __name__ == "__main__":
    main()
