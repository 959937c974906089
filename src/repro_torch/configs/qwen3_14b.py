"""Qwen3-14B (hf:Qwen/Qwen3-8B family). GQA kv=8, qk_norm. A copy of
``repro.configs.qwen3_14b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen3-smoke", n_layers=3, d_model=128, n_heads=8, n_kv_heads=4,
    head_dim=16, d_ff=256, vocab=512,
)

MICROBATCHES = {"train_4k": 4}
