"""Top-level language model: embedding → blocks → final norm → logits, for
the dense family.

Entry points, as the reference's ``models/lm.py``:

* ``init_params(key, cfg)`` — the model (:class:`LM`), drawn from a
  ``torch.Generator`` (or an int seed) on the card unless ``device="cpu"``;
* ``prefill(params, batch, cfg)`` — (caches, last-token logits);
* ``decode_step(params, caches, tokens, pos, cfg)`` — (caches, logits);
* ``init_caches`` / ``init_paged_caches`` — empty layer-stacked caches.

The reference's ``lax.scan`` over stacked blocks is a Python loop over
``LM.blocks``; caches stay layer-stacked ((L, ...) leading axis), and each
layer works on its view, so a decode step updates its caches in place.
``train_loss`` waits for the training slice (ROADMAP A15).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import device as _device
from ..configs.base import ModelConfig
from . import blocks as B
from . import common as C

__all__ = ["LM", "padded_vocab_size", "init_params", "prefill", "decode_step", "init_caches",
           "init_paged_caches"]


def padded_vocab_size(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


class LM(nn.Module):
    """``embed`` (V, d), ``blocks`` (one :class:`~.blocks.Block` per layer),
    ``ln_f``, ``unembed`` (d, V); V is the vocabulary padded to 128."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "dense":
            raise C.unported(f"the {cfg.family} family")
        dt, vp = C.dtype_of(cfg.dtype), padded_vocab_size(cfg)
        self.cfg = cfg
        self.embed = C.dense_init(gen, (vp, cfg.d_model), dt, scale=0.02)
        self.blocks = nn.ModuleList(B.init_block(gen, cfg) for _ in range(cfg.num_layers))
        self.ln_f = C.init_norm(cfg, device=gen.device)
        self.unembed = C.dense_init(gen, (cfg.d_model, vp), dt)


def init_params(key, cfg: ModelConfig, *, device=None) -> LM:
    """The model with weights drawn from ``key``: a ``torch.Generator`` (on
    the device it draws on) or an int seed for a generator on ``device``
    (the card unless ``device="cpu"``)."""
    if not isinstance(key, torch.Generator):
        key = torch.Generator(device=_device.resolve(device)).manual_seed(int(key))
    return LM(key, cfg)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _run_blocks(params: LM, x, cfg: ModelConfig, *, positions, mode, caches=None,
                kv_chunk=1024, cache_len=None, seq_positions=None, page_table=None, prior=None,
                raw_kv=False):
    """The layer loop.  ``caches`` and ``prior`` are layer-stacked; each layer
    gets its (L,)-index view, and all share one pair of RoPE tables.
    Returns (x, layer-stacked new caches or None)."""
    rope = C.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) if cfg.use_rope else None
    new = []
    for i, bp in enumerate(params.blocks):
        x, nc, _ = B.apply_block(
            bp, x, cfg, positions=positions, mode=mode,
            cache=None if caches is None else _tree_map(lambda t: t[i], caches),
            kv_chunk=kv_chunk, cache_len=cache_len, seq_positions=seq_positions,
            page_table=page_table, prior=None if prior is None else _tree_map(lambda t: t[i], prior),
            raw_kv=raw_kv, rope=rope,
        )
        new.append(nc)
    if mode == "decode":
        return x, caches  # updated in place, layer by layer
    if new[0] is None:
        return x, None
    return x, _tree_map(lambda *ts: torch.stack(ts), *new)


def _tokens(params: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device).long()


@torch.no_grad()
def prefill(params: LM, batch, cfg: ModelConfig, *, cache_len=None, kv_chunk=1024, last=None,
            prior=None, raw_kv=False):
    """Full-sequence forward building the decode cache; returns (caches,
    logits (B, 1, V) fp32 at the last token).

    ``last`` (B,) picks each row's true last token (right-padded bucketed
    prompts).  ``prior`` = layer-stacked {"k","v": (L, B, Sp, KV, Dh)} is a
    cached prompt prefix of Sp tokens: the rows of ``batch`` are the prompt
    suffix at positions Sp, Sp+1, ...  ``raw_kv=True`` returns each layer's
    fresh K/V ({"attn": {"k","v"}}) instead of dense cache rows."""
    tokens = _tokens(params, batch["tokens"])
    x = params.embed[tokens]
    b, s = tokens.shape
    seq_pos = torch.arange(s, dtype=torch.int32, device=x.device)
    if prior is not None:
        seq_pos = seq_pos + prior["k"].shape[2]
    positions = seq_pos[None].expand(b, s)
    x, caches = _run_blocks(params, x, cfg, positions=positions, mode="prefill", kv_chunk=kv_chunk,
                            cache_len=cache_len, seq_positions=seq_pos,
                            prior=prior, raw_kv=raw_kv)
    x = C.apply_norm(params.ln_f, x, cfg.norm)
    if last is None:
        sel = x[:, -1:]
    else:
        sel = x[torch.arange(b, device=x.device), _tokens(params, last)][:, None]
    return caches, C.matmul_f32(sel, params.unembed)


@torch.no_grad()
def decode_step(params: LM, caches, tokens, pos, cfg: ModelConfig, *, page_table=None):
    """One decode step.  tokens (B, 1); pos a scalar (every row at the same
    depth) or (B,) per-row positions; ``caches`` from :func:`prefill` /
    :func:`init_caches`, or :func:`init_paged_caches` with ``page_table``
    (B, NP) int32.  Updates ``caches`` in place and returns (caches, logits
    (B, 1, V) fp32)."""
    tokens = _tokens(params, tokens)
    x = params.embed[tokens]
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    x, caches = _run_blocks(params, x, cfg, positions=pos[:, None], mode="decode", caches=caches,
                            seq_positions=pos, page_table=page_table)
    x = C.apply_norm(params.ln_f, x, cfg.norm)
    return caches, C.matmul_f32(x, params.unembed)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, enc_len: int = 0, dtype=None,
                device=None) -> dict:
    """Layer-stacked dense cache {"attn": {"k","v": (L, B, S, KV, Dh), "pos":
    (L, B, S)}}, all zeros (``pos`` too, as the reference's), on the card
    unless ``device="cpu"``."""
    dtype = dtype or C.dtype_of(cfg.dtype)
    one = B.init_block_cache(cfg, batch, seq_len, dtype, enc_len=enc_len,
                             device=_device.resolve(device))
    return _tree_map(lambda a: a.new_zeros((cfg.num_layers,) + a.shape), one)


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int, page_size: int, *,
                      enc_len: int = 0, dtype=None, device=None) -> dict:
    """Layer-stacked cache whose attention K/V is a shared page pool
    {"attn": {"k_pages","v_pages": (L, num_pages, page_size, KV, Dh)}}."""
    if cfg.sliding_window is not None:
        raise ValueError("paged KV cache does not support sliding-window archs")
    if cfg.family != "dense":
        raise C.unported(f"the {cfg.family} family")
    dtype = dtype or C.dtype_of(cfg.dtype)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    dev = _device.resolve(device)
    return {"attn": {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
                     "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}}
