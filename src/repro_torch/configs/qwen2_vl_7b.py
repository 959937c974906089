"""Qwen2-VL-7B (arXiv:2409.12191; hf). GQA kv=4 backbone + M-RoPE
(t/h/w sections); the vision frontend is a stub: callers supply patch
and text embeddings (``embeds``) and 3-D position ids. A copy of
``repro.configs.qwen2_vl_7b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen2vl-smoke", n_layers=3, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, mrope_sections=(4, 6, 6),
)

MICROBATCHES = {"train_4k": 2}
