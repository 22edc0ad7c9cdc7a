"""Qwen2-VL-2B [arXiv:2409.12191]: M-RoPE; vision frontend STUBBED — inputs
include precomputed patch embeddings prepended to the token stream."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    mlp_activation="silu", mlp_gated=True,
    mrope_sections=(16, 24, 24), rope_theta=1000000.0,
    frontend="vision_stub", num_prefix_embeds=256,
)
