"""Hymba-1.5B (arXiv:2411.13676; hf). Parallel attention and Mamba heads
in every layer, sliding-window attention except three global layers,
128 meta tokens, ssm_state 16. A copy of ``repro.configs.hymba_1_5b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    window=1024, global_layers=(0, 16, 31),
    ssm_kind="mamba", ssm_state=16,
    rope_theta=1e4, supports_long_context=True,
)

SMOKE = CONFIG.replace(
    name="hymba-smoke", n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, window=32, global_layers=(0, 2, 4),
)

MICROBATCHES = {"train_4k": 4}
