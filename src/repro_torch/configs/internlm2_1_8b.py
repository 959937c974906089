"""InternLM2-1.8B (arXiv:2403.17297; hf). GQA kv=8. A copy of
``repro.configs.internlm2_1_8b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, head_dim=128,
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="internlm2-smoke", n_layers=3, d_model=128, n_heads=8,
    n_kv_heads=4, head_dim=16, d_ff=256, vocab=512,
)

MICROBATCHES = {"train_4k": 2}
