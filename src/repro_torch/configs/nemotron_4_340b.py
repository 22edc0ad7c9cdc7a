"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP (ungated)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    mlp_activation="relu2", mlp_gated=False, norm="layernorm",
    rope_theta=10000.0,
)
