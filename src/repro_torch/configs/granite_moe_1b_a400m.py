"""Granite-3.0-1B-A400M [hf:ibm-granite]: 32-expert top-8 MoE."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=32, experts_per_token=8,
    mlp_activation="silu", mlp_gated=True, rope_theta=10000.0,
)
