"""StarCoder2-3B [arXiv:2402.19173]: GQA kv=2, RoPE, ungated GELU MLP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152, head_dim=128,
    mlp_activation="gelu", mlp_gated=False, norm="layernorm",
    rope_theta=100000.0,
)
