"""Architecture registry: ``get(arch)`` → full config, ``get_smoke(arch)``
→ the reduced config of the CPU tests, ``microbatches(arch, shape)`` →
the gradient-accumulation default of a shape cell.

The port has the dense GQA architectures ``yi-6b``, ``yi-34b``,
``internlm2-1.8b`` and ``qwen3-14b`` (qk-norm), the vision-language
``qwen2-vl-7b`` (a dense GQA backbone with M-RoPE over stub embeddings),
the MoE ``llama4-maverick-400b-a17b`` (dense and MoE layers in pairs,
capacity-routed top-1), the hybrid ``hymba-1.5b`` (attention and Mamba
heads in parallel, sliding windows, meta tokens), the encoder-decoder
``whisper-small`` (a bidirectional encoder over stub frames and
cross-attention), ``deepseek-v3-671b`` (multi-head latent attention, a
dense prefix before top-8 MoE layers with a shared expert, and the MTP
head) and the RWKV6 ``rwkv6-3b``, for serving and training: every
architecture of the reference registry.
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen3-14b", "internlm2-1.8b", "yi-34b", "yi-6b", "qwen2-vl-7b",
         "llama4-maverick-400b-a17b", "hymba-1.5b", "whisper-small",
         "deepseek-v3-671b", "rwkv6-3b"]

# the reference's architectures that the port lacks: none
NOT_PORTED: dict = {}


def _mod(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(
        f"{__package__}.{arch.replace('-', '_').replace('.', '_')}")


def get(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).SMOKE


def microbatches(arch: str, shape_name: str) -> int:
    return getattr(_mod(arch), "MICROBATCHES", {}).get(shape_name, 1)
