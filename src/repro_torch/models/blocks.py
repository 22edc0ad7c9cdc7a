"""Per-layer blocks, all pre-norm residual.  The port has the dense
family's block (attention sublayer, then MLP sublayer), the encdec
family's (whisper's): its decoder block adds a cross-attention sublayer
between the two, and its encoder block is the dense block run
bidirectionally; the moe family's, the MoE layer in place of the MLP; the
ssm family's (mamba2), the Mamba-2 mixer alone; and the hybrid family's
(hymba), attention and the mixer side by side on one normed input, mixed
by learned per-channel gates, then the MLP.  The vlm family's block
raises, naming ROADMAP A6."""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import common as C
from . import mamba2 as M
from . import moe as MOE

__all__ = ["Block", "init_block", "apply_block", "apply_encoder_block", "init_block_cache"]

PORTED = ("dense", "encdec", "moe", "ssm", "hybrid")


def _ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise C.unported(f"the {cfg.family} family's block")


class Block(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``: the reference's dense block,
    also whisper's encoder block (``encoder=True``); the encdec family's
    decoder block adds ``ln_cross`` and ``cross``; the moe family's has
    ``moe`` (:class:`~.moe.MoE`) in place of ``mlp``; the ssm family's is
    ``ln_ssm`` and ``ssm`` (:class:`~.mamba2.SSM`) alone; the hybrid
    family's adds ``ssm`` and the fp32 (d,) gates ``beta_attn`` and
    ``beta_ssm`` (ones) to the dense block."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, encoder: bool = False):
        super().__init__()
        _ported(cfg)
        fam = "dense" if encoder else cfg.family
        dev = gen.device
        if fam == "ssm":
            self.ln_ssm = C.init_norm(cfg, device=dev)
            self.ssm = M.init_ssm(gen, cfg)
            return
        self.ln_attn = C.init_norm(cfg, device=dev)
        self.attn = C.init_attention(gen, cfg)
        if fam == "encdec":
            self.ln_cross = C.init_norm(cfg, device=dev)
            self.cross = C.init_attention(gen, cfg)
        if fam == "hybrid":
            self.ssm = M.init_ssm(gen, cfg)
            self.beta_attn = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32, device=dev))
            self.beta_ssm = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32, device=dev))
        self.ln_mlp = C.init_norm(cfg, device=dev)
        if fam == "moe":
            self.moe = MOE.init_moe(gen, cfg)
        else:
            self.mlp = C.init_mlp(gen, cfg)


def init_block(gen: torch.Generator, cfg: ModelConfig, *, encoder: bool = False) -> Block:
    return Block(gen, cfg, encoder=encoder)


def apply_block(
    p: Block, x, cfg: ModelConfig, *, positions, mode="train", cache=None, enc_out=None,
    kv_chunk=1024, cache_len=None, seq_positions=None, lengths=None, page_table=None,
    prior=None, raw_kv=False, rope=None,
):
    """One decoder layer.  Returns (x, new_cache, aux); ``aux`` is the moe
    family's load-balance loss (:func:`~.moe.apply_moe`), 0 for the other
    families.  ``rope``: the forward's RoPE tables (``common.rope_tables``),
    shared by its layers.

    The encdec family's cross attention reads ``enc_out`` in train and
    prefill mode (a prefill's cache gains the projected ``cross_k`` /
    ``cross_v``) and the cached ``cross_k`` / ``cross_v`` in decode mode.
    The ssm and hybrid families' mixer keeps its cache under ``ssm``;
    ``lengths`` ((B,), prefill only) are the rows' true lengths in a
    right-padded bucket, which its recurrence needs (attention's causal
    mask already keeps pads out of a real row's output)."""
    _ported(cfg)
    fam = cfg.family
    ssm_cache = cache["ssm"] if cache is not None and fam in ("ssm", "hybrid") else None
    if fam == "ssm":
        h = C.apply_norm(p.ln_ssm, x, cfg.norm)
        so, sc = M.apply_ssm_layer(p.ssm, h, cfg, mode=mode, cache=ssm_cache, lengths=lengths)
        return x + so, (None if sc is None else {"ssm": sc}), 0.0
    h = C.apply_norm(p.ln_attn, x, cfg.norm)
    attn_out, ac = C.apply_attention_layer(
        p.attn, h, cfg, positions=positions, mode=mode,
        cache=None if cache is None else cache["attn"], kv_chunk=kv_chunk, cache_len=cache_len,
        seq_positions=seq_positions, page_table=page_table, prior=prior, raw_kv=raw_kv, rope=rope,
    )
    new_cache = None if ac is None else {"attn": ac}
    if fam == "hybrid":
        so, sc = M.apply_ssm_layer(p.ssm, h, cfg, mode=mode, cache=ssm_cache, lengths=lengths)
        if sc is not None:
            new_cache["ssm"] = sc
        x = x + 0.5 * (attn_out * p.beta_attn.to(x.dtype) + so * p.beta_ssm.to(x.dtype))
    else:
        x = x + attn_out
    if cfg.family == "encdec":
        h = C.apply_norm(p.ln_cross, x, cfg.norm)
        cross_out, ckv = C.apply_cross_attention_layer(
            p.cross, h, cfg, enc_out=enc_out,
            cross_kv=None if cache is None else (cache["cross_k"], cache["cross_v"]))
        x = x + cross_out
        if mode in ("prefill", "decode"):
            new_cache["cross_k"], new_cache["cross_v"] = ckv
    h = C.apply_norm(p.ln_mlp, x, cfg.norm)
    if cfg.family == "moe":
        mo, aux = MOE.apply_moe(p.moe, h, cfg)
        return x + mo, new_cache, aux
    x = x + C.apply_mlp(p.mlp, h, cfg)
    return x, new_cache, 0.0


def apply_encoder_block(p: Block, x, cfg: ModelConfig, *, kv_chunk=1024):
    """Bidirectional encoder layer (whisper): full self-attention over the
    frames, no RoPE, then the MLP."""
    b, s, _ = x.shape
    h = C.apply_norm(p.ln_attn, x, cfg.norm)
    hh, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (h @ p.attn.wq).reshape(b, s, hh, dh)
    k = (h @ p.attn.wk).reshape(b, s, kv, dh)
    v = (h @ p.attn.wv).reshape(b, s, kv, dh)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    out = C.attention(q, k, v, q_positions=pos, kv_positions=pos, causal=False, window=None,
                      kv_chunk=kv_chunk)
    x = x + out @ p.attn.wo
    h = C.apply_norm(p.ln_mlp, x, cfg.norm)
    return x + C.apply_mlp(p.mlp, h, cfg)


def init_block_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, *, enc_len: int = 0,
                     device=None) -> dict:
    """Cache of ONE layer (stacked over layers by the caller): ``attn`` but
    for the ssm family; the encdec family adds the cross K/V ``cross_k`` /
    ``cross_v`` (B, enc_len, KV, Dh), the ssm and hybrid families the
    mixer's ``ssm`` (:func:`~.mamba2.init_ssm_cache`)."""
    _ported(cfg)
    c = {}
    if cfg.family != "ssm":
        c["attn"] = C.init_attention_cache(cfg, batch, seq_len, dtype, device=device)
    if cfg.family in ("ssm", "hybrid"):
        c["ssm"] = M.init_ssm_cache(cfg, batch, dtype, device=device)
    if cfg.family == "encdec":
        kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
        c["cross_k"] = torch.zeros((batch, enc_len, kv, dh), dtype=dtype, device=device)
        c["cross_v"] = torch.zeros((batch, enc_len, kv, dh), dtype=dtype, device=device)
    return c
