"""Model configuration and parameter initialisation.

``ModelConfig`` is a copy of ``repro.models.common.ModelConfig`` with
torch dtypes. :class:`ParamFactory` draws parameters as the reference's
``ParamFactory`` does — normal × 0.02 (or the given ``scale``), zeros or
ones, in ``cfg.dtype`` — from a ``torch.Generator`` the caller seeds. The
two frameworks draw different numbers from one seed; tests that compare
them carry one set of weights across through ``repro_torch.convert``.

The reference builds a logical-sharding spec beside every leaf and has an
``abstract`` mode (shapes without arrays) for its dry-run; the port has no
mesh and no dry-run, so neither has a counterpart. Shapes without arrays
come from ``device="meta"``. :class:`ParamTree` holds a parameter tree as
an ``nn.Module`` that also indexes like the reference's nested dicts; its
parameters are trainable (``requires_grad``), and the serving entry
points run under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads
    # attention
    attn_kind: str = "gqa"         # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: tuple = ()     # qwen2-vl M-RoPE (t, h, w) half-dims
    window: int = -1               # sliding-window size; -1 = full attention
    global_layers: tuple = ()      # hymba: layer idx with full attention
    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0        # deepseek: first k layers are dense
    moe_interleave: int = 1        # llama4: every k-th layer is MoE
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    # ssm / hybrid
    ssm_state: int = 0
    ssm_kind: str = ""             # rwkv6 | mamba
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_len: int = 0           # stub frontend tokens (whisper: 1500)
    # extras
    mtp: bool = False              # deepseek multi-token prediction head
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # which shape cells apply (long_500k only for sub-quadratic)
    supports_long_context: bool = False
    is_encoder_decoder: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


class ParamFactory:
    """Draws parameter leaves in ``dtype`` on ``device``.

    ``leaf(shape, scale=0.02, zero=False)`` is normal·scale (drawn in f32,
    scaled in place, then cast) or zeros; ``ones(shape)`` is ones.
    ``generator`` must live on ``device``; it may be None only on the meta
    device, where nothing is drawn."""

    def __init__(self, generator: torch.Generator | None, dtype,
                 device: torch.device) -> None:
        if generator is None and device.type != "meta":
            raise ValueError("a torch.Generator is needed to draw parameters")
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def leaf(self, shape: tuple, scale: float = 0.02,
             zero: bool = False) -> torch.Tensor:
        if zero:
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        # scaled in place: one f32 draw beside the result, not two (a
        # routed expert leaf of llama4-maverick is 21.5 GB in f32)
        return x.mul_(scale).to(self.dtype)

    def ones(self, shape: tuple) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: leaves become
    trainable parameters, dicts become child trees, and ``tree["key"]``
    indexes both, so layer functions take a ParamTree or a plain dict
    alike."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def keys(self):
        return [*self._parameters, *self._modules]

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def to_dict(self) -> dict:
        """The tree as nested dicts of the parameter tensors."""
        return {k: (self[k].to_dict() if isinstance(self[k], ParamTree)
                    else self[k].data) for k in self.keys()}


def param_count(tree: nn.Module) -> int:
    """Number of parameter elements in ``tree`` (an ``LM`` or any
    module)."""
    return sum(p.numel() for p in tree.parameters())


def reference_leaves(tree, path: tuple = ()) -> list:
    """The leaves of the reference's layout of ``tree``, in the order
    ``jax.tree.flatten`` visits them (dict keys sorted), as ``(path,
    tensors, stacked)``: ``tensors`` are the port's tensors whose bytes,
    one after the other, are the reference leaf's bytes.

    ``tree`` is a mapping (a dict, a ``ParamTree``, an ``LM``, an
    ``nn.ModuleDict``: anything with ``keys()`` and ``[key]``), a list of
    per-layer trees (an ``nn.ModuleList``), which the reference stacks
    along a leading layer axis: each of its leaves is one leaf, made of
    one tensor per layer, with ``stacked`` True; or a leaf (a tensor or
    an array)."""
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        layers = [reference_leaves(layer, path) for layer in tree]
        return [(p, [layer[j][1][0] for layer in layers], True)
                for j, (p, _, _) in enumerate(layers[0])]
    if not hasattr(tree, "keys"):
        return [(path, [tree], False)]
    out = []
    for key in sorted(tree.keys()):
        out += reference_leaves(tree[key], path + (key,))
    return out
