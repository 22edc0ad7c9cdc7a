"""Shared model components of the dense, encdec and moe families: norms,
RoPE, GQA attention (one chunk, or chunked with an online softmax; causal
and sliding-window masks), the attention sublayer in its prefill, decode
(a ring buffer of ``window`` slots for sliding-window configs) and
paged-decode modes, the encoder-decoder cross-attention sublayer, and the
MLP.

The reference's ``models/common.py`` keeps weights in a dict pytree; here
each sublayer is an ``nn.Module`` whose weights keep the reference's
(in, out) layout, so ``x @ p.wq`` is the reference's product.  Compute
follows the reference's precision: activations in the config's dtype,
norms, RoPE angles, scores and softmax sums in fp32.

Not ported yet, and raising ``NotImplementedError`` where they would run:
M-RoPE (the vlm family, ROADMAP A6), the ``tri`` schedule (ROADMAP A6)
and ``ebv_attention_sharded``, which needs a device mesh (ROADMAP A7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig

MASK_VALUE = -1e30

__all__ = [
    "MASK_VALUE", "Norm", "Attention", "MLP", "dense_init", "dtype_of", "matmul_f32", "init_norm",
    "apply_norm", "rope_frequencies", "rope_tables", "apply_rope", "init_attention", "attention",
    "single_chunk_attention", "ebv_attention_sharded", "apply_attention_layer",
    "apply_cross_attention_layer", "init_attention_cache", "init_mlp", "apply_mlp",
]


def unported(what: str, item: str = "A6") -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16``: a config's dtype name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two bf16 (or fp16) card tensors, fp32 out; its backward
    rounds the fp32 cotangent to the operands' dtype and returns gradients
    in it, each product accumulated in fp32 (no fp32 copy of the weight)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(b.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = g @ b.t()
        if ctx.needs_input_grad[1]:
            gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32: the reference's
    ``preferred_element_type=jnp.float32``.  On the card a bf16 operand
    pair goes to ``torch.mm(..., out_dtype=torch.float32)``, so the weight
    is read in bf16; elsewhere both are upcast (exactly) first.
    Differentiable either way."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda and b.ndim == 2 and a.dtype == b.dtype:
        return _MatmulF32.apply(a, b)
    return a.float() @ b.float()


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, scale=None) -> nn.Parameter:
    """Fan-in scaled normal init, drawn in fp32 on the generator's device
    and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
    return nn.Parameter(w.to(dtype))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
class Norm(nn.Module):
    """RMS or layer norm scale (fp32), ``{"scale": (dim,)}`` in the reference."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))


def init_norm(cfg: ModelConfig, dim=None, *, device=None) -> Norm:
    return Norm(dim or cfg.d_model, device=device)


def apply_norm(p: Norm, x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + 1e-6) * p.scale
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the RoPE angles ``positions * inv_freq`` in fp32, each
    (B, S, 1, Dh/2): one pair serves q and k of every layer of a forward."""
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * inv  # (B, S, Dh/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, mrope_sections=None, *,
               tables=None):
    """x: (B, S, H, Dh); positions: (B, S), or ``tables`` from
    :func:`rope_tables` computed once for them.  Angles in fp32."""
    if mrope_sections is not None:
        raise unported("M-RoPE (the vlm family)")
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA)
# --------------------------------------------------------------------------
class Attention(nn.Module):
    """``wq`` (d, H·Dh), ``wk``/``wv`` (d, KV·Dh), ``wo`` (H·Dh, d)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        dt = dtype_of(cfg.dtype)
        self.wq = dense_init(gen, (d, h * dh), dt)
        self.wk = dense_init(gen, (d, kv * dh), dt)
        self.wv = dense_init(gen, (d, kv * dh), dt)
        self.wo = dense_init(gen, (h * dh, d), dt, scale=(h * dh) ** -0.5)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Attention:
    return Attention(gen, cfg)


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """qg (B, KV, rep, Sq, Dh), k (B, Sk, KV, Dh) → fp32 (B, KV, rep, Sq, Sk),
    times ``scale`` in fp32."""
    b, kvh, rep, sq, dh = qg.shape
    s = qg.float().reshape(b, kvh, rep * sq, dh) @ k.float().permute(0, 2, 3, 1)
    return s.reshape(b, kvh, rep, sq, -1) * scale


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B, KV, rep, Sq, Sk) fp32 rounded to v's dtype, times v (B, Sk, KV,
    Dh), summed in fp32 and rounded to v's dtype: the reference's
    ``einsum(p.astype(v.dtype), v)``."""
    b, kvh, rep, sq, sk = p.shape
    pr = p.to(v.dtype).float().reshape(b, kvh, rep * sq, sk)
    out = pr @ v.float().permute(0, 2, 1, 3)
    return out.reshape(b, kvh, rep, sq, -1).to(v.dtype)


def single_chunk_attention(qg, k, v, mask) -> torch.Tensor:
    """The single-chunk masked softmax of the reference's ``attention``:
    qg (B, KV, rep, Sq, Dh), k/v (B, Sk, KV, Dh), ``mask`` broadcastable to
    (B, KV, rep, Sq, Sk).  Masked scores are ``MASK_VALUE``, whose
    ``exp(MASK - m)`` is exactly 0.  Returns (B, KV, rep, Sq, Dh) in v's dtype.

    Rounding order: fp32 scores times ``Dh**-0.5``; fp32 ``p = exp(s - m)``
    with ``m >= -1e25``; ``p`` rounded to v's dtype and ``p·v`` summed in
    fp32 and rounded to v's dtype; ``l = max(sum p, 1e-30)`` rounded to v's
    dtype, and the division in v's dtype."""
    s = torch.where(mask, _scores(qg, k, qg.shape[-1] ** -0.5), MASK_VALUE)
    m = s.amax(-1).clamp_min(-1e25)
    p = torch.exp(s - m[..., None])
    out = _pv(p, v)
    return out / p.sum(-1).clamp_min(1e-30)[..., None].to(out.dtype)


def attention(q, k, v, *, q_positions, kv_positions, causal: bool, window: int | None,
              kv_chunk: int = 1024, schedule: str = "rect"):
    """Chunked GQA attention (the ``rect`` schedule).

    q: (B, Sq, H, Dh); k/v: (B, Sk, KV, Dh); positions are absolute token
    indices (1-D, shared by the batch) for causal and sliding-window
    masking (a query sees keys with ``q_pos - k_pos < window``); a kv
    position < 0 marks an empty slot.  One chunk runs the plain masked
    softmax; several run the online softmax over ``kv_chunk``-wide chunks.
    Returns (B, Sq, H·Dh) in q's dtype."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, sq, kvh, rep, dh).permute(0, 2, 3, 1, 4)  # (B, KV, rep, Sq, Dh)
    kv_chunk = min(kv_chunk, sk)
    num_chunks = -(-sk // kv_chunk)
    if schedule == "tri" and causal and sq == sk and num_chunks > 1:
        raise unported("the tri attention schedule")

    def mask_of(kpos):
        mask = kpos[None, :] >= 0
        if causal:
            mask = mask & (kpos[None, :] <= q_positions[:, None])
        if window is not None:
            mask = mask & (q_positions[:, None] - kpos[None, :] < window)
        return mask  # (Sq, Ck)

    if num_chunks == 1:
        out = single_chunk_attention(qg, k, v, mask_of(kv_positions))
    else:
        pad = num_chunks * kv_chunk - sk
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            kv_positions = F.pad(kv_positions, (0, pad), value=-1)
        m = torch.full((b, kvh, rep, sq), float("-inf"), device=q.device)
        l = torch.zeros((b, kvh, rep, sq), device=q.device)
        acc = torch.zeros((b, kvh, rep, sq, dh), device=q.device)
        for c in range(num_chunks):
            cs = slice(c * kv_chunk, (c + 1) * kv_chunk)
            s = torch.where(mask_of(kv_positions[cs]), _scores(qg, k[:, cs], dh ** -0.5), MASK_VALUE)
            m_new = torch.maximum(m, s.amax(-1)).clamp_min(-1e25)  # guard fully-masked rows
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _pv(p, v[:, cs])
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * dh).to(q.dtype)


def ebv_attention_sharded(*args, **kwargs):
    """The reference's sequence-parallel EbV-scheduled attention; it needs a
    device mesh."""
    raise unported("ebv_attention_sharded (a device mesh)", "A7")


def apply_attention_layer(
    p: Attention, x, cfg: ModelConfig, *, positions, mode="train", cache=None,
    cache_len=None, kv_chunk=1024, seq_positions=None, page_table=None, prior=None,
    raw_kv=False, rope=None,
):
    """Attention sublayer: qkv projections → RoPE → (cache update) →
    attention → out projection.  Returns (out, new_cache).

    Modes, as the reference's:

    * ``prefill`` — full-sequence causal attention; returns a dense cache of
      ``cache_len`` slots ({"k","v": (B, Sc, KV, Dh), "pos": (B, Sc) int32,
      −1 = empty}), or with ``raw_kv=True`` the fresh {"k","v"} verbatim
      (for the paged engine to scatter into pool pages).  ``prior`` =
      {"k","v": (B, Sp, KV, Dh)} is a cached prompt prefix: the fresh rows
      (positions already offset by Sp) attend over (prior ++ fresh).
    * ``decode`` against a dense cache: one token per row at the per-row
      positions ``seq_positions`` (B,), written to slot ``pos`` (clamped to
      the last slot, as the reference's ``dynamic_update_slice``), or for a
      sliding-window config to the ring slot ``pos % Sc``; the cache is
      updated in place.
    * ``decode`` against a paged cache {"k_pages","v_pages": (P, page, KV,
      Dh)} with ``page_table`` (B, NP) int32: the row's K/V is written into
      its page in place, and the attention runs through
      :func:`repro_torch.kernels.paged_attn.paged_decode_attention`.

    ``rope`` takes :func:`rope_tables` of ``positions`` where the caller
    computed them once for every layer.
    """
    if cfg.mrope_sections is not None:
        raise unported("M-RoPE (the vlm family)")
    window = cfg.sliding_window
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq).reshape(b, s, h, dh)
    k = (x @ p.wk).reshape(b, s, kv, dh)
    v = (x @ p.wv).reshape(b, s, kv, dh)
    tpos = seq_positions if seq_positions is not None else positions
    if cfg.use_rope:
        rope = rope if rope is not None else rope_tables(positions, dh, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, tables=rope)
        k = apply_rope(k, positions, cfg.rope_theta, tables=rope)

    if mode in ("train", "prefill"):
        pos1d = tpos[0] if tpos.ndim > 1 else tpos
        if prior is not None:
            pk, pv = prior["k"].to(k.dtype), prior["v"].to(v.dtype)
            kvpos = torch.cat([torch.arange(pk.shape[1], dtype=torch.int32, device=x.device),
                               pos1d.to(torch.int32)])
            out = attention(q, torch.cat([pk, k], 1), torch.cat([pv, v], 1), q_positions=pos1d,
                            kv_positions=kvpos, causal=True, window=window, kv_chunk=kv_chunk)
        else:
            # "ebv" runs sharded only under a mesh, which the port has not;
            # without one the reference runs "rect" as well
            sched = cfg.attention_schedule
            out = attention(q, k, v, q_positions=pos1d, kv_positions=pos1d, causal=True,
                            window=window, kv_chunk=kv_chunk,
                            schedule="rect" if sched == "ebv" else sched)
        new_cache = None
        if mode == "prefill":
            new_cache = {"k": k, "v": v} if raw_kv else _build_cache(cfg, k, v, pos1d, cache_len or s)
    elif mode == "decode" and "k_pages" in cache:
        from ..kernels.paged_attn import paged_decode_attention

        kp, vp = cache["k_pages"], cache["v_pages"]
        page, np_ = kp.shape[1], page_table.shape[1]
        cur = (tpos[0] if tpos.ndim > 1 else tpos).to(torch.int32).expand(b)
        pidx = (cur // page).clamp(0, np_ - 1)
        # idle rows point at page 0 (scrap); a −1 hole goes there too, so
        # stale writes from retired slots never touch a live page
        pi = page_table.gather(1, pidx[:, None].long())[:, 0].clamp_min(0).long()
        off = (cur % page).long()
        kp[pi, off] = k[:, 0].to(kp.dtype)
        vp[pi, off] = v[:, 0].to(vp.dtype)
        out = paged_decode_attention(q[:, 0], kp, vp, page_table, cur + 1)[:, None]
        new_cache = cache
    elif mode == "decode":
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        sc = ck.shape[1]
        cur = (tpos[0] if tpos.ndim > 1 else tpos).to(torch.int32).expand(b)
        # the ring slot under a window; else the reference's dynamic_update_slice clamps
        slot = (cur % sc if window is not None else cur.clamp(max=sc - 1)).long()
        rows = torch.arange(b, device=x.device)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        cpos[rows, slot] = cur
        mask = (cpos >= 0) & (cpos <= cur[:, None])  # (B, Sc): per-row causal mask
        if window is not None:
            mask = mask & (cur[:, None] - cpos < window)
        qg = q.reshape(b, 1, kv, h // kv, dh).permute(0, 2, 3, 1, 4)
        out = single_chunk_attention(qg, ck, cv, mask[:, None, None, None, :])
        out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h * dh).to(q.dtype)
        new_cache = cache
    else:
        raise ValueError(mode)
    return out @ p.wo, new_cache


def _build_cache(cfg: ModelConfig, k, v, pos1d, cache_len: int) -> dict:
    """Prefill → decode cache layout, ``pos`` per sequence ((B, Sc)): decode
    advances rows independently under continuous batching.  A sliding-window
    config keeps a ring of ``w = min(window, cache_len)`` slots, position p
    in slot ``p % w``: the last ``w`` positions rolled by ``(s - w) % w``,
    or a shorter prefill padded to ``w`` with position −1."""
    b, s = k.shape[0], k.shape[1]
    if cfg.sliding_window is not None:
        w = min(cfg.sliding_window, cache_len)
        if s >= w:
            shift = (s - w) % w
            ck, cv = k[:, s - w:].roll(shift, 1), v[:, s - w:].roll(shift, 1)
            cpos = pos1d[s - w:].to(torch.int32).roll(shift)
            return {"k": ck, "v": cv, "pos": cpos[None].repeat(b, 1)}
        cache_len = w
    pad = cache_len - s
    ck = F.pad(k, (0, 0, 0, 0, 0, pad))
    cv = F.pad(v, (0, 0, 0, 0, 0, pad))
    cpos = F.pad(pos1d.to(torch.int32), (0, pad), value=-1)
    return {"k": ck, "v": cv, "pos": cpos[None].repeat(b, 1)}


def apply_cross_attention_layer(p: Attention, x, cfg: ModelConfig, *, enc_out=None, cross_kv=None):
    """Encoder-decoder cross attention (no RoPE, not causal): the decoder's
    queries over the encoder's K/V.  Either ``enc_out`` (B, Se, d) (train
    and prefill: K/V projected here) or ``cross_kv`` = (k, v), each
    (B, Se, KV, Dh), from the cache (decode).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq).reshape(b, s, h, dh)
    if cross_kv is None:
        se = enc_out.shape[1]
        k = (enc_out @ p.wk).reshape(b, se, kv, dh)
        v = (enc_out @ p.wv).reshape(b, se, kv, dh)
    else:
        k, v = cross_kv
    zeros = lambda n: torch.zeros((n,), dtype=torch.int32, device=x.device)
    out = attention(q, k, v, q_positions=zeros(s), kv_positions=zeros(k.shape[1]), causal=False,
                    window=None, kv_chunk=k.shape[1])
    return out @ p.wo, (k, v)


def init_attention_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, *, device=None) -> dict:
    """An empty dense cache of ``seq_len`` slots, ``min(seq_len, window)``
    (the ring) for a sliding-window config."""
    sc = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, sc, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, sc, kv, dh), dtype=dtype, device=device),
        "pos": torch.full((batch, sc), -1, dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
class MLP(nn.Module):
    """``wg``/``wu`` (d, d_ff) (``wu`` alone when not gated), ``wd`` (d_ff, d)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = dtype_of(cfg.dtype)
        if cfg.mlp_gated:
            self.wg = dense_init(gen, (d, f), dt)
        self.wu = dense_init(gen, (d, f), dt)
        self.wd = dense_init(gen, (f, d), dt, scale=f ** -0.5)


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> MLP:
    return MLP(gen, cfg)


def _activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def apply_mlp(p: MLP, x, cfg: ModelConfig):
    if cfg.mlp_gated:
        h = _activation(x @ p.wg, cfg.mlp_activation) * (x @ p.wu)
    else:
        h = _activation(x @ p.wu, cfg.mlp_activation)
    return h @ p.wd
