"""Per-layer blocks.  The port has the dense family's pre-norm residual
block (attention sublayer, then MLP sublayer); the other families' blocks
(moe, ssm, hybrid, encdec, vlm) raise, naming ROADMAP A6."""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import common as C

__all__ = ["Block", "init_block", "apply_block", "init_block_cache"]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise C.unported(f"the {cfg.family} family's block")


class Block(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``: the reference's dense block."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        _dense_only(cfg)
        self.ln_attn = C.init_norm(cfg, device=gen.device)
        self.attn = C.init_attention(gen, cfg)
        self.ln_mlp = C.init_norm(cfg, device=gen.device)
        self.mlp = C.init_mlp(gen, cfg)


def init_block(gen: torch.Generator, cfg: ModelConfig, *, encoder: bool = False) -> Block:
    if encoder:
        raise C.unported("the encoder block (the encdec family)")
    return Block(gen, cfg)


def apply_block(
    p: Block, x, cfg: ModelConfig, *, positions, mode="train", cache=None, enc_out=None,
    kv_chunk=1024, cache_len=None, seq_positions=None, lengths=None, page_table=None,
    prior=None, raw_kv=False, rope=None,
):
    """One decoder layer.  Returns (x, new_cache, aux); ``aux`` (the MoE
    balance loss in the reference) is 0 for the dense family.  ``rope``:
    the forward's RoPE tables (``common.rope_tables``), shared by its layers."""
    _dense_only(cfg)
    h = C.apply_norm(p.ln_attn, x, cfg.norm)
    attn_out, ac = C.apply_attention_layer(
        p.attn, h, cfg, positions=positions, mode=mode,
        cache=None if cache is None else cache["attn"], kv_chunk=kv_chunk, cache_len=cache_len,
        seq_positions=seq_positions, page_table=page_table, prior=prior, raw_kv=raw_kv, rope=rope,
    )
    x = x + attn_out
    h = C.apply_norm(p.ln_mlp, x, cfg.norm)
    x = x + C.apply_mlp(p.mlp, h, cfg)
    return x, (None if ac is None else {"attn": ac}), 0.0


def init_block_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, *, enc_len: int = 0,
                     device=None) -> dict:
    """Cache of ONE layer (stacked over layers by the caller)."""
    _dense_only(cfg)
    return {"attn": C.init_attention_cache(cfg, batch, seq_len, dtype, device=device)}
