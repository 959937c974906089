"""RWKV6 (Finch) 3B (arXiv:2404.05892; hf). Attention-free, data-dependent
decay; O(1) decode state. A copy of ``repro.configs.rwkv6_3b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, head_dim=64,
    attn_kind="none", ssm_kind="rwkv6", ssm_heads=40,
    supports_long_context=True,
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=512, ssm_heads=4,
)

MICROBATCHES = {"train_4k": 4}
