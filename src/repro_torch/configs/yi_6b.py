"""Yi-6B (arXiv:2403.04652; hf). Llama-arch GQA kv=4. A copy of
``repro.configs.yi_6b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
    rope_theta=5e6,
)

SMOKE = CONFIG.replace(
    name="yi6b-smoke", n_layers=3, d_model=128, n_heads=8, n_kv_heads=4,
    head_dim=16, d_ff=256, vocab=512,
)

MICROBATCHES = {"train_4k": 2}
