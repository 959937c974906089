"""DeepSeek-V3 671B (arXiv:2412.19437; hf). Multi-head latent attention
(MLA), a dense prefix of 3 layers, then MoE layers (1 shared + 256 routed
experts, top-8), and the multi-token prediction (MTP) head. A copy of
``repro.configs.deepseek_v3_671b``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,               # dense-layer ffn (first 3 layers)
    vocab=129280, head_dim=128,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    n_experts=256, experts_per_token=8, n_shared_experts=1,
    moe_d_ff=2048, n_dense_layers=3, capacity_factor=1.25,
    mtp=True, rope_theta=1e4,
)

SMOKE = CONFIG.replace(
    name="deepseek-v3-smoke", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
    q_lora_rank=64, kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
    v_head_dim=32, n_experts=8, experts_per_token=2, moe_d_ff=64,
    n_dense_layers=1,
)

MICROBATCHES = {"train_4k": 16}
