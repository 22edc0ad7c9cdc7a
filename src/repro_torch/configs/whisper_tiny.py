"""Whisper-tiny [arXiv:2212.04356]: enc-dec; conv frontend STUBBED — the
dry-run/smoke inputs are precomputed frame embeddings (brief: frontend stub)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, encoder_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    mlp_activation="gelu", mlp_gated=False, norm="layernorm",
    use_rope=False, frontend="audio_stub",
)
