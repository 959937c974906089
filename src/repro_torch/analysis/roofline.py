"""Model FLOPs and the card's rates. Counterpart of
``repro.analysis.roofline``.

:func:`active_params` and :func:`model_flops` are the reference's: the
parameter count, the count a token uses (a routed expert leaf, one with
an "expert" logical axis, counts k/E of its size), and the useful FLOPs
of a dry-run cell (6·N_active·tokens a train step plus the causal
attention's quadratic term, 2·N_active·tokens a prefill, 2·N_active·B a
decode step plus its attention over the cache).

The rates are the H100 SXM's, the card of ``chip_smoke.py``
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
"NVIDIA H100 80GB HBM3, 700.00 W"): dense bf16 on the tensor cores and
HBM3 bandwidth. A card set below 700 W runs below them.

The rest of the reference's module reads XLA's per-device program of a
compiled cell: ``analyze`` and ``Cell`` (the compute, memory and
collective terms from the HLO's FLOPs, bytes and collective bytes),
``SUGGEST``, ``markdown_table``, ``main``, and the whole of
``repro.analysis.hlo_parse``. The port's dry run compiles nothing
(``launch.dryrun``), so they have no counterpart until the port counts
its own program's work.
"""
from __future__ import annotations

import functools

from ..configs import registry
from ..launch.sharding import tree_map
from ..models import transformer as T

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_BF16 = 989e12          # FLOP/s, dense bf16 tensor-core rate
HBM_BW = 3.35e12            # B/s, HBM3


@functools.lru_cache(maxsize=None)
def active_params(arch: str) -> tuple[float, float]:
    """(total, active) parameter counts of ``arch``'s full config, from
    the model on the meta device and its logical axes."""
    cfg = registry.get(arch)
    frac = (cfg.experts_per_token / cfg.n_experts) if cfg.n_experts \
        else 1.0
    counts: list = []
    tree_map(lambda p, a: counts.append(
        (float(p.numel()), frac if "expert" in a else 1.0)),
        T.init_lm(cfg, None, "meta"), T.param_axes(cfg))
    return (sum(n for n, _ in counts), sum(n * f for n, f in counts))


def model_flops(rec: dict) -> float:
    """Global useful FLOPs per step of a dry-run record's cell
    (``arch``, ``kind``, ``global_batch``, ``seq_len``)."""
    cfg = registry.get(rec["arch"])
    _, active = active_params(rec["arch"])
    B, S = rec["global_batch"], rec["seq_len"]
    hd, H, L = cfg.hd, cfg.n_heads, cfg.n_layers
    if rec["kind"] == "train":
        flops = 6.0 * active * B * S
        # causal attention quadratic term (fwd 2·BS²Hh, ×3 with bwd)
        if cfg.attn_kind != "none":
            flops += 3.0 * 2.0 * B * S * S * H * hd * L
        return flops
    if rec["kind"] == "prefill":
        flops = 2.0 * active * B * S
        if cfg.attn_kind != "none":
            flops += 2.0 * B * S * S * H * hd * L
        return flops
    # decode: one token, KV length S
    flops = 2.0 * active * B
    if cfg.attn_kind != "none":
        kv_len = S if cfg.window <= 0 else min(cfg.window, S)
        flops += 2.0 * 2.0 * B * kv_len * H * hd * L
    return flops
