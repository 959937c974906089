"""Yi-34B (arXiv:2403.04652; hf). Llama-arch GQA kv=8. A copy of
``repro.configs.yi_34b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    rope_theta=5e6,
)

SMOKE = CONFIG.replace(
    name="yi34b-smoke", n_layers=3, d_model=128, n_heads=8, n_kv_heads=4,
    head_dim=16, d_ff=256, vocab=512,
)

MICROBATCHES = {"train_4k": 8}
