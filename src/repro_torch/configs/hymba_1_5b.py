"""Hymba-1.5B [arXiv:2411.13676]: parallel attention + Mamba heads per layer,
sliding-window attention (global-attention layers simplified to SWA — DESIGN.md)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    mlp_activation="silu", mlp_gated=True,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    sliding_window=2048, rope_theta=10000.0,
)
