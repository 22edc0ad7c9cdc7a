"""Mixtral-8x22B [arXiv:2401.04088]: 8-expert top-2 MoE, sliding-window attn."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, experts_per_token=2,
    mlp_activation="silu", mlp_gated=True,
    sliding_window=4096, rope_theta=1000000.0,
)
