"""Mixture-of-Experts layer, the moe family's feed-forward sublayer: top-k
routing with capacity-bounded dispatch, as the reference's
``models/moe.py``.

Dispatch is the reference's sort-free slot assignment: a choice's rank
within its expert is a cumulative count over the one-hot routing matrix,
in token order and then top-k column order (choice 0 of every token, then
choice 1, ...), and a choice ranked at or past the expert's capacity
``cap = max(int(cf · T · k / E), 1)`` is dropped.  The kept rows go into an
(E·cap, d) buffer, each expert's rows through its gated MLP (one batched
product a weight), and back, weighted by the renormalized top-k
probabilities.  Capacity counts every row of the call, so the rows of a
call share it.

Departures from the reference, by design (ROADMAP §C): the top-k is a
stable descending sort (``jax.lax.top_k`` puts the lower expert first on a
tie, ``torch.topk`` need not); and the dispatch writes each kept row to its
slot, every kept slot being distinct, where the reference adds zero rows
for the dropped choices too (its slot ``E·cap − 1``): the same buffer
without atomics.  The router's product is the reference's bf16 operands
summed in fp32: both operands are upcast (exactly) and multiplied in
fp32, TF32 off.

Without a device mesh :func:`apply_moe` runs :func:`_moe_grouped`; the
reference's ``shard_map`` island needs a mesh (ROADMAP A7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import _activation, dense_init, dtype_of, unported

__all__ = ["MoE", "init_moe", "route", "replay_choices", "dispatch_slots", "apply_moe", "GROUP_TOKENS"]

#: tokens a group of :func:`_moe_grouped` (the reference's ``group_tokens``)
GROUP_TOKENS = 16384


class MoE(nn.Module):
    """``router`` (d, E) fp32; ``wg``, ``wu`` (E, d, d_ff) (``wu`` alone when
    not gated) and ``wd`` (E, d_ff, d) in the config's dtype."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        dt = dtype_of(cfg.dtype)
        self.router = dense_init(gen, (d, e), torch.float32)
        if cfg.mlp_gated:
            self.wg = dense_init(gen, (e, d, f), dt, scale=d ** -0.5)
        self.wu = dense_init(gen, (e, d, f), dt, scale=d ** -0.5)
        self.wd = dense_init(gen, (e, f, d), dt, scale=f ** -0.5)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> MoE:
    return MoE(gen, cfg)


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """The router on tokens ``xt`` (T, d): (probs (T, E) fp32, top_p (T, k)
    fp32 renormalized to sum 1, top_e (T, k) int64), the k largest
    probabilities of each token in descending order, the lower expert
    first on a tie."""
    logits = xt.float() @ p.router.to(xt.dtype).float()  # bf16 operands, fp32 sums
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_p, top_e = vals[:, :k], idx[:, :k]
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def replay_choices(probs: torch.Tensor, own: torch.Tensor, want: torch.Tensor):
    """The router's output with the choices ``want`` (T, k) in place of its
    own ``own``: (top_p of ``want`` renormalized to sum 1, the count of
    choices that differ, the largest gap between the probabilities of a
    differing pair)."""
    gap = float((probs.gather(1, own) - probs.gather(1, want)).abs().max())
    top_p = probs.gather(1, want)
    return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), int((own != want).sum()), gap


def capacity(t: int, cfg: ModelConfig) -> int:
    """An expert's buffer rows for a call of ``t`` rows."""
    return max(int(cfg.moe_capacity_factor * t * cfg.experts_per_token / cfg.num_experts), 1)


def dispatch_slots(top_e: torch.Tensor, cfg: ModelConfig, *, valid_count: int | None = None):
    """Each choice's buffer slot: (slot (k, T) int64, valid (k, T) bool),
    choice j of token t at ``[j, t]``.  A choice's rank within its expert
    counts the earlier choices of that expert in token order, choice 0 of
    every token before choice 1; a valid choice (rank below ``cap``; with
    ``valid_count`` R given, a row below R and, where R < T, a rank below
    ``max(int(cf · R · k // E), 1)``) goes to ``expert · cap + rank``, a
    dropped one to ``E · cap − 1``."""
    t, k = top_e.shape
    e, cap = cfg.num_experts, capacity(t, cfg)
    cap_eff = cap
    if valid_count is not None and valid_count != t:
        cap_eff = max(int(cfg.moe_capacity_factor * valid_count * k // e), 1)
    flat = top_e.t().reshape(-1)  # (k·T,), choice-major
    # the one-hot routing matrix expert-major, (E, k·T), so each expert's
    # count is a scan along contiguous memory
    onehot = (torch.arange(e, device=top_e.device)[:, None] == flat).to(torch.int32)
    row_valid = None
    if valid_count is not None:
        row_valid = (torch.arange(t, device=top_e.device) < valid_count).repeat(k)
        onehot = onehot * row_valid
    rank = (onehot.cumsum(1, dtype=torch.int32) - onehot).gather(0, flat[None])[0]
    valid = rank < cap_eff
    if row_valid is not None:
        valid = valid & row_valid
    slot = torch.where(valid, flat * cap + rank, e * cap - 1)
    return slot.reshape(k, t), valid.reshape(k, t)


def _moe_local(p: MoE, xt: torch.Tensor, cfg: ModelConfig, valid_count: int | None = None):
    """The layer on tokens ``xt`` (T, d): (out (T, d), aux).

    ``valid_count`` (None: every row real) marks the leading real rows of a
    zero-padded group: pad rows take no rank and no part in the aux loss,
    and the capacity scales to the real rows, ``max(int(cf · R · k // E), 1)``,
    while the buffer keeps the full group's ``cap`` rows."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs, top_p, top_e = route(p, xt, cfg)
    cap = capacity(t, cfg)
    # the aux load-balance loss (Switch): E · Σ_e fraction_e · mean-prob_e
    if valid_count is None:
        frac = torch.zeros(e, device=xt.device).index_add_(
            0, top_e.reshape(-1), torch.ones(t * k, device=xt.device)) / (t * k)
        aux = e * (frac * probs.mean(0)).sum()
    else:
        r = max(valid_count, 1)
        row_valid = torch.arange(t, device=xt.device) < valid_count
        frac = torch.zeros(e, device=xt.device).index_add_(
            0, top_e.reshape(-1), row_valid.float().repeat_interleave(k)) / (r * k)
        aux = e * (frac * ((probs * row_valid[:, None]).sum(0) / r)).sum()
    slot, valid = dispatch_slots(top_e, cfg, valid_count=valid_count)

    # the kept choices to their slots; the dropped ones to a scrap row past the buffer
    to = torch.where(valid, slot, e * cap).reshape(-1)
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_put_((to,), xt.repeat(k, 1))
    eb = buf[:e * cap].view(e, cap, d)
    if cfg.mlp_gated:
        h = _activation(torch.bmm(eb, p.wg), cfg.mlp_activation) * torch.bmm(eb, p.wu)
    else:
        h = _activation(torch.bmm(eb, p.wu), cfg.mlp_activation)
    out_buf = torch.bmm(h, p.wd).reshape(e * cap, d)

    # the combine: choice j's weighted row added in j's order, in the activation dtype
    gathered = out_buf.index_select(0, slot.reshape(-1)).view(k, t, d)
    prod = gathered * (top_p.t() * valid).to(xt.dtype)[..., None]  # (k, T, d)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + prod[j]
    return out, aux


def _moe_grouped(p: MoE, xt: torch.Tensor, cfg: ModelConfig, *, group_tokens: int = GROUP_TOKENS):
    """:func:`_moe_local` over groups of ``group_tokens`` tokens, so the slot
    buffer stays the size of a group; capacity is per group.  A zero-padded
    tail group carries its real rows' count, and every group then carries
    one.  The aux loss is the groups' mean."""
    t, d = xt.shape
    if t <= group_tokens:
        return _moe_local(p, xt, cfg)
    g = -(-t // group_tokens)
    pad = g * group_tokens - t
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    outs, auxs = [], []
    for i in range(g):
        count = None if not pad else (group_tokens - pad if i == g - 1 else group_tokens)
        out, aux = _moe_local(p, xt[i * group_tokens:(i + 1) * group_tokens], cfg, valid_count=count)
        outs.append(out)
        auxs.append(aux)
    return torch.cat(outs)[:t], torch.stack(auxs).mean()


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, *, mesh=None):
    """x (B, S, d) → (out (B, S, d), aux): the layer over the B·S tokens of
    the call, grouped (:func:`_moe_grouped`).  ``mesh`` (the reference's
    shard_map island over a device mesh) raises."""
    if mesh is not None:
        raise unported("the MoE layer's shard_map island (a device mesh)", "A7")
    b, s, d = x.shape
    out, aux = _moe_grouped(p, x.reshape(b * s, d), cfg)
    return out.reshape(b, s, d), aux
