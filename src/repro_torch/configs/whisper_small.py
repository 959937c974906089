"""Whisper-small (arXiv:2212.04356; unverified tier). The encoder-decoder
backbone: 12 bidirectional encoder blocks over stub frame embeddings
(the conv audio frontend is a stub: callers supply 1,500 frame embeddings
[B, 1500, D]), 12 decoder blocks, each followed by cross-attention to
the encoder's output. A copy of ``repro.configs.whisper_small``."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    encoder_layers=12, encoder_len=1500,
    is_encoder_decoder=True, rope_theta=1e4,
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, encoder_layers=2, encoder_len=64,
)

MICROBATCHES = {"train_4k": 1}
