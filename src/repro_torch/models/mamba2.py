"""Mamba-2 (SSD, state-space duality) mixer, the ssm family's sublayer and
half of the hybrid family's, as the reference's ``models/mamba2.py``.

Training and prefill run the chunkwise-parallel SSD algorithm: within a
chunk a masked, decay-weighted product like attention's, across chunks a
scan of the (B, H, P, N) state (here a Python loop over the chunks, the
reference's ``lax.scan``).  Decode is the O(1) recurrent update of that
state.  One B/C group (G = 1).  The projections are split per output
segment (``z``, ``x``, ``B``, ``C``, ``dt``), each with its own depthwise
causal conv, as the reference's are.

Precision follows the reference step by step: the projections and the
conv's taps in the config's dtype (bf16 products and partial sums), the
conv's SiLU, ``dt``, the decays and the state in fp32; the intra-chunk
scores ``C·B`` and the chunk states are fp32 sums of upcast operands
(``common.matmul_f32``'s rule), the decay-weighted scores are rounded to
the input dtype before they multiply ``x·dt``, and ``dt`` is rounded to
the input dtype before the scan while ``a = dt·A`` stays fp32.

One departure, by design (ROADMAP §C, "Reference bugs the port does not
copy"): the intra-chunk decay is ``exp(where(tri, ldecay, -inf))`` where
the reference takes ``where(tri, exp(ldecay), 0)``.  Above the diagonal
``ldecay`` is a positive sum of ``|dt·A|`` that passes 88 inside a
256-step chunk at full width, so the reference's ``exp`` overflows there;
its forward selects 0, but its backward multiplies a zero cotangent by
inf and every gradient it reaches is NaN.  Here the forward is the same,
and the gradients are the reference's wherever those are finite.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import apply_norm, dense_init, dtype_of

__all__ = ["SSM", "init_ssm", "ssd_chunked", "apply_ssm_layer", "init_ssm_cache"]


def _dims(cfg: ModelConfig):
    return cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv


class SSM(nn.Module):
    """``z_proj``, ``x_proj`` (d, d_inner), ``b_proj``, ``c_proj`` (d, N),
    ``dt_proj`` (d, H), the conv taps ``conv_x`` (cw, d_inner), ``conv_b``,
    ``conv_c`` (cw, N) and ``out_proj`` (d_inner, d) in the config's dtype;
    ``a_log``, ``d_skip``, ``dt_bias`` (H,) and ``norm_scale`` (d_inner,)
    fp32.  Drawn under the reference's laws: fan-in scaled normals, conv
    taps N(0, 1) rounded to the dtype times 0.1, ``a_log = log(1..H)``,
    ``d_skip`` and ``norm_scale`` ones, and ``dt_bias`` the inverse softplus
    of a log-uniform draw in [1e-3, 1e-1]."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        di, n, h, _, cw = _dims(cfg)
        dt = dtype_of(cfg.dtype)
        dev = gen.device
        self.z_proj = dense_init(gen, (d, di), dt)
        self.x_proj = dense_init(gen, (d, di), dt)
        self.b_proj = dense_init(gen, (d, n), dt)
        self.c_proj = dense_init(gen, (d, n), dt)
        self.dt_proj = dense_init(gen, (d, h), dt)

        def conv(ch):
            w = torch.randn((cw, ch), generator=gen, device=dev, dtype=torch.float32)
            return nn.Parameter(w.to(dt) * 0.1)

        self.conv_x, self.conv_b, self.conv_c = conv(di), conv(n), conv(n)
        self.a_log = nn.Parameter(torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)))
        self.d_skip = nn.Parameter(torch.ones(h, dtype=torch.float32, device=dev))
        u = torch.rand(h, generator=gen, device=dev, dtype=torch.float32)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        self.dt_bias = nn.Parameter(dt0 + torch.log(-torch.expm1(-dt0)))
        self.norm_scale = nn.Parameter(torch.ones(di, dtype=torch.float32, device=dev))
        self.out_proj = dense_init(gen, (di, d), dt, scale=di ** -0.5)


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> SSM:
    return SSM(gen, cfg)


def _gated_norm(p, y, z):
    """RMS norm (scale ``norm_scale``) of ``y * silu(z)``, the gate in fp32
    rounded to y's dtype before the product."""
    return apply_norm(SimpleNamespace(scale=p.norm_scale), y * F.silu(z.float()).to(y.dtype), "rmsnorm")


def _causal_conv(xbc, w):
    """Depthwise causal conv along S: ``xbc`` (B, S, C), ``w`` (cw, C); the
    taps summed in the reference's order, each product and partial sum in
    the input dtype; SiLU in fp32, rounded back."""
    cw, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, cw - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out.float()).to(xbc.dtype)


def ssd_chunked(x, dt, a, bmat, cmat, *, chunk: int):
    """Chunkwise-parallel SSD.

    x: (B, S, H, P); dt (x's dtype), a = dt·A (fp32, negative): (B, S, H);
    bmat, cmat: (B, S, N).  Returns y (B, S, H, P) in x's dtype and the
    final state (B, H, P, N) fp32.  A sequence that is not a multiple of
    the chunk length ``min(chunk, S)`` is padded with zeros, which is exact:
    a = 0 keeps the state and B·x = 0 adds nothing."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    s_pad = -(-s // q) * q
    if s_pad != s:
        x, dt, a, bmat, cmat = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, s_pad - s))
                                for t in (x, dt, a, bmat, cmat))
    c = s_pad // q
    xc = (x * dt[..., None]).reshape(b, c, q, h, p)
    ac = a.reshape(b, c, q, h)
    bc = bmat.reshape(b, c, q, n).float()
    cc = cmat.reshape(b, c, q, n).float()

    acum = torch.cumsum(ac, dim=2)  # (B, C, Q, H) the within-chunk log-decay
    asum = acum[:, :, -1]  # (B, C, H)

    # intra-chunk: the masked decay-weighted scores, head-major (B, C, H, Q, K)
    # so that the elementwise passes and the product run on contiguous rows
    # (the departure: exp of -inf above the diagonal)
    cb = cc @ bc.transpose(-1, -2)  # (B, C, Q, K) fp32
    acum_h = acum.transpose(2, 3)  # (B, C, H, Q)
    ldecay = acum_h[..., :, None] - acum_h[..., None, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(torch.where(tri, ldecay, float("-inf")))
    att = (lmat * cb[:, :, None]).to(x.dtype).float()  # rounded as the reference's astype(x.dtype)
    y_intra = att @ xc.float().permute(0, 1, 3, 2, 4)  # (B, C, H, Q, P)
    y_intra = y_intra.permute(0, 1, 3, 2, 4).to(x.dtype)

    # chunk states, then the inter-chunk scan
    decay_to_end = torch.exp(asum[:, :, None, :] - acum)  # (B, C, Q, H)
    w = (xc.float() * decay_to_end[..., None]).reshape(b, c, q, h * p)
    states = (w.transpose(-1, -2) @ bc).reshape(b, c, h, p, n)  # (B, C, H, P, N)
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for i in range(c):
        hprevs.append(hprev)
        hprev = hprev * torch.exp(asum[:, i])[:, :, None, None] + states[:, i]
    hprevs = torch.stack(hprevs, 1)  # (B, C, H, P, N): the state entering each chunk

    y_inter = cc @ hprevs.reshape(b, c, h * p, n).transpose(-1, -2)  # (B, C, Q, H·P)
    y_inter = y_inter.reshape(b, c, q, h, p) * torch.exp(acum)[..., None]
    y = y_intra + y_inter.to(x.dtype)
    return y.reshape(b, s_pad, h, p)[:, :s], hprev


def _tails(r, cw: int, lengths):
    """The cw − 1 pre-conv inputs ending at each row's last token (at
    ``lengths`` (B,) where given), rows shorter than the window left-filled
    with zeros, as :func:`init_ssm_cache` starts them."""
    b, s = r.shape[0], r.shape[1]
    if lengths is None:
        if s >= cw - 1:
            return r[:, s - (cw - 1):]
        return F.pad(r, (0, 0, cw - 1 - s, 0))
    idx = lengths[:, None] - (cw - 1) + torch.arange(cw - 1, device=r.device)[None, :]  # (B, cw-1)
    take = r[torch.arange(b, device=r.device)[:, None], idx.clamp_min(0)]
    return torch.where((idx >= 0)[:, :, None], take, torch.zeros((), dtype=r.dtype, device=r.device))


def apply_ssm_layer(p: SSM, xin, cfg: ModelConfig, *, mode="train", cache=None, lengths=None):
    """The Mamba-2 mixer sublayer.  Returns (out, cache).

    ``cache`` = {"conv_x", "conv_b", "conv_c": the raw pre-conv tails
    (B, cw − 1, ·), "state": (B, H, P, N) fp32}.  ``train`` returns None;
    ``prefill`` builds a cache; ``decode`` (one token a row) runs the conv
    over the cached window and the recurrent state update, and updates
    ``cache`` in place.

    ``lengths`` ((B,) int, prefill only): each row's true prompt length in
    a right-padded bucket.  A pad's ``dt`` is forced to 0 after the
    softplus (decay 1, input 0: the state passes through unchanged), and
    the conv tails are gathered at each row's true end, so the cache is
    that of the unpadded prompt up to the round-off of a chunk length that
    follows the padded length."""
    b, s, _ = xin.shape
    di, n, h, hd, cw = _dims(cfg)
    z = xin @ p.z_proj
    xr = xin @ p.x_proj
    br = xin @ p.b_proj
    cr = xin @ p.c_proj
    dtr = xin @ p.dt_proj
    a_neg = -torch.exp(p.a_log)  # (H,)

    if mode in ("train", "prefill"):
        x = _causal_conv(xr, p.conv_x).reshape(b, s, h, hd)
        bmat = _causal_conv(br, p.conv_b)
        cmat = _causal_conv(cr, p.conv_c)
        dt = F.softplus(dtr.float() + p.dt_bias)  # (B, S, H)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=xin.device).long()
            valid = torch.arange(s, device=xin.device)[None, :] < lengths[:, None]
            dt = torch.where(valid[:, :, None], dt, 0.0)
        y, hfinal = ssd_chunked(x, dt.to(xin.dtype), dt * a_neg, bmat, cmat, chunk=cfg.ssm_chunk)
        y = (y + x * p.d_skip[:, None].to(x.dtype)).reshape(b, s, di)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv_x": _tails(xr, cw, lengths), "conv_b": _tails(br, cw, lengths),
                         "conv_c": _tails(cr, cw, lengths), "state": hfinal}
    elif mode == "decode":
        def conv_step(r_new, key, w):
            window = torch.cat([cache[key], r_new], dim=1)  # (B, cw, C)
            out = (window.float() * w.float()).sum(1)  # exact products, fp32 sums
            cache[key].copy_(window[:, 1:])
            return F.silu(out).to(r_new.dtype)

        xo = conv_step(xr, "conv_x", p.conv_x)
        bo = conv_step(br, "conv_b", p.conv_b)
        co = conv_step(cr, "conv_c", p.conv_c)
        x = xo.reshape(b, h, hd)
        dt = F.softplus(dtr.float() + p.dt_bias)[:, 0]  # (B, H)
        xdt = (x * dt[..., None].to(x.dtype)).float()  # (B, H, P)
        state = cache["state"]
        state.mul_(torch.exp(dt * a_neg)[:, :, None, None])
        state.add_(xdt[..., None] * bo.float()[:, None, None, :])
        y = (state @ co.float()[:, None, :, None])[..., 0]  # (B, H, P) fp32
        y = (y.to(xin.dtype) + x * p.d_skip[:, None].to(x.dtype)).reshape(b, 1, di)
        new_cache = cache
    else:
        raise ValueError(mode)
    y = _gated_norm(p, y, z)
    return y @ p.out_proj, new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, device=None) -> dict:
    """An empty SSM cache of ``batch`` rows: zero conv tails in ``dtype``
    and a zero fp32 state."""
    di, n, h, hd, cw = _dims(cfg)
    return {
        "conv_x": torch.zeros((batch, cw - 1, di), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, cw - 1, n), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, cw - 1, n), dtype=dtype, device=device),
        "state": torch.zeros((batch, h, hd, n), dtype=torch.float32, device=device),
    }
