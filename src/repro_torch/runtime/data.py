"""Exactly-once, totally-ordered data pipeline over the HT-Paxos log.
Counterpart of ``repro.runtime.data``.

Ingest frontends (the paper's clients) submit batch *metadata*; payloads
are replicated by the dissemination layer (f+1 copies before ordering —
§4.1 stability); the ordering layer fixes the global consumption order.
Every pod consumes the same batch sequence exactly once, across retries,
duplicate submissions, and pod restarts — the training-data analogue of
"agents discard duplicate messages / learners discard duplicate
proposals" (§3).

``ShardedBatchSource`` is the deterministic synthetic-data generator:
batch content is a pure function of (seed, batch index), so a restarted
pod regenerates byte-identical payloads. The content comes from a
``torch.Generator`` on the host seeded from (seed, index), the same on
every device; it differs from the reference's, which draws from a
``jax.random`` key that torch cannot reproduce. The exactly-once and
ordering semantics of ``OrderedDataFeed`` are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class ShardedBatchSource:
    """Deterministic batches: content = f(seed, index), on ``device``
    (default the CUDA card; raises without one). For the
    vision-language family (``family="vlm"``, with ``d_model``) the stub
    frontend's fields come too, as in the reference: ``embeds`` [B,S,D]
    standard normal (f32), ``positions`` [3,B,S] int32 (the token index
    in all three streams) and ``labels`` (the tokens). With
    ``encoder_len`` (and ``d_model``), for the encoder-decoder family,
    ``frames`` [B, encoder_len, D] standard normal (f32), the stub audio
    frontend's frame embeddings, as in the reference; every other family
    (the MoE family too) takes the tokens alone."""
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    device: Optional[str] = None
    d_model: int = 0          # for the stub-frontend families (vlm, audio)
    family: str = "dense"
    encoder_len: int = 0      # encoder frames (the encoder-decoder family)

    def batch(self, index: int) -> dict:
        seed = int(np.random.SeedSequence([self.seed, index])
                   .generate_state(1, np.uint64)[0])
        gen = torch.Generator().manual_seed(seed)
        B, S = self.global_batch, self.seq_len
        out = {"tokens": torch.randint(0, self.vocab, (B, S),
                                       generator=gen)}
        if self.family == "vlm":
            out["embeds"] = torch.randn((B, S, self.d_model), generator=gen)
            out["positions"] = torch.arange(S, dtype=torch.int32)[
                None, None].expand(3, B, S).contiguous()
            out["labels"] = out["tokens"]
        if self.encoder_len:
            out["frames"] = torch.randn((B, self.encoder_len, self.d_model),
                                        generator=gen)
        dev = resolve_device(self.device)
        return {k: v.to(dev) for k, v in out.items()}


class OrderedDataFeed:
    """Per-pod view of the decided batch log: exactly-once iteration.

    ``offer(batch_id)`` records a decided id in log order (driven by the
    pod's executed command stream); ``take()`` yields each id once. A
    restart replays ``offer``s from the log; consumed ids before the
    checkpoint step are skipped via ``fast_forward``."""

    def __init__(self, source: ShardedBatchSource) -> None:
        self.source = source
        self._log: list[str] = []
        self._consumed = 0
        self._seen: set = set()

    def offer(self, batch_id: str) -> None:
        if batch_id in self._seen:       # duplicate decision replay
            return
        self._seen.add(batch_id)
        self._log.append(batch_id)

    def take(self) -> Optional[tuple[str, dict]]:
        if self._consumed >= len(self._log):
            return None
        bid = self._log[self._consumed]
        self._consumed += 1
        index = int(bid.rsplit("_", 1)[-1]) if "_" in bid else \
            int("".join(c for c in bid if c.isdigit()) or 0)
        return bid, self.source.batch(index)

    def fast_forward(self, n: int) -> None:
        """Skip the first n batches (already folded into a checkpoint)."""
        self._consumed = min(n, len(self._log))

    @property
    def position(self) -> int:
        return self._consumed
