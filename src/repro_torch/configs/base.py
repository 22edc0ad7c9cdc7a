"""Model configurations: the architecture configs, the input-shape cells and
the registry, as the reference's ``configs/base.py`` has them.

Every architecture is a frozen :class:`ModelConfig` with the reference's
fields and defaults; ``reduced()`` gives the tiny same-family variant the
CPU tests run.  :func:`get_config` imports ``repro_torch.configs.<arch>``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # MLP
    mlp_activation: str = "silu"  # silu | gelu | relu2
    mlp_gated: bool = True
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # attention
    sliding_window: int | None = None
    use_rope: bool = True
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE
    attention_schedule: str = "rect"  # rect | tri  (see §Perf)
    # enc-dec (whisper)
    encoder_layers: int = 0
    frontend: str | None = None  # audio_stub | vision_stub
    num_prefix_embeds: int = 0  # vlm: precomputed patch embeds prepended
    # numerics / misc
    remat_policy: str = "full"  # full | dots (save MXU outputs, skip bwd recompute)
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    logical_rules_overrides: tuple[tuple[str, str | None], ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context (sub-quadratic cache)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return self.replace(
            num_layers=2,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            sliding_window=32 if self.sliding_window else None,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,  # sums to head_dim/2
            num_prefix_embeds=8 if self.num_prefix_embeds else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "nemotron_4_340b",
    "llama3_8b",
    "deepseek_67b",
    "starcoder2_3b",
    "whisper_tiny",
    "mixtral_8x22b",
    "granite_moe_1b_a400m",
    "qwen2_vl_2b",
    "mamba2_1_3b",
    "hymba_1_5b",
]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
