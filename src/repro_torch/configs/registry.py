"""Architecture registry: ``get(arch)`` → full config, ``get_smoke(arch)``
→ the reduced config of the CPU tests.

The port has the serving path of two architectures, ``yi-6b`` (dense
GQA) and ``rwkv6-3b`` (RWKV6). Every other architecture of the reference
registry raises ``NotImplementedError`` naming the ROADMAP.md item that
ports it.
"""
from __future__ import annotations

import importlib

ARCHS = ["yi-6b", "rwkv6-3b"]

# the reference's other architectures → the ROADMAP.md item that ports them
NOT_PORTED = {
    "qwen3-14b": "queue 1 item 12 (dense GQA with qk-norm: config copy)",
    "internlm2-1.8b": "queue 1 item 12 (dense GQA: config copy)",
    "yi-34b": "queue 1 item 12 (dense GQA: config copy)",
    "deepseek-v3-671b": "queue 1 item 12 (MLA and MoE)",
    "llama4-maverick-400b-a17b": "queue 1 item 12 (MoE)",
    "hymba-1.5b": "queue 1 item 12 (hybrid with Mamba, ring-buffer cache)",
    "whisper-small": "queue 1 item 12 (encoder-decoder)",
    "qwen2-vl-7b": "queue 1 item 12 (M-RoPE)",
}


def _mod(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch yet: ROADMAP.md "
            f"{NOT_PORTED[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(
        f"{__package__}.{arch.replace('-', '_').replace('.', '_')}")


def get(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).SMOKE
