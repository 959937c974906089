"""Llama-4 Maverick 400B-A17B (hf:meta-llama; unverified tier).
Alternating dense/MoE layers (interleave=2), 128 routed top-1 experts
plus one shared expert. A copy of
``repro.configs.llama4_maverick_400b_a17b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=16384,               # dense layers
    vocab=202048, head_dim=128,
    n_experts=128, experts_per_token=1, n_shared_experts=1,
    moe_d_ff=8192, moe_interleave=2, capacity_factor=1.25,
    rope_theta=5e5,
)

SMOKE = CONFIG.replace(
    name="llama4-smoke", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
    head_dim=16, d_ff=256, vocab=512, n_experts=8, experts_per_token=1,
    moe_d_ff=128,
)

MICROBATCHES = {"train_4k": 16}
