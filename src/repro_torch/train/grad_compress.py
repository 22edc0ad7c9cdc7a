"""Gradient compression for cross-pod data parallelism: int8 quantization
with error feedback.  Between pods (the slow link) the summand is
quantized to int8 with a per-leaf fp32 scale, reduced and dequantized; the
quantization residual is carried to the next step (error feedback).

A tree is a tensor or a nested dict, list or tuple of them.  The
quantizer and its feedback are bit for bit the reference's; the reduction
across pods (``compressed_psum``) needs a device mesh (ROADMAP A7).
"""
from __future__ import annotations

import torch

from ..models.common import unported

__all__ = ["quantize", "dequantize", "compress_with_feedback", "init_error", "compressed_psum",
           "compression_ratio"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def quantize(x: torch.Tensor, *, bits: int = 8):
    """Symmetric per-tensor int8 quantization: (q, fp32 scale)."""
    x32 = x.to(torch.float32)
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(x32.abs().max(), min=1e-12) / qmax
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads, error):
    """(grads + error) → (quantized tree, scales, new error)."""

    def one(g, e):
        target = g.to(torch.float32) + e
        q, s = quantize(target)
        return q, s, target - dequantize(q, s)

    out = _map(one, grads, error)  # a tree of (q, scale, error) triples
    return tuple(_map(lambda _, o, i=i: o[i], grads, out) for i in range(3))


def init_error(params):
    """A zero fp32 error tree shaped like ``params``."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_psum(grads, error, *, mesh, axis: str = "pod"):
    """The reference's cross-``axis`` mean with int8 transport: it needs a
    device mesh."""
    raise unported("compressed_psum (a device mesh)", "A7")


def compression_ratio(params) -> float:
    """Wire-bytes ratio of int8 plus one fp32 scale a leaf against fp32."""
    leaves = _leaves(params)
    total = sum(p.numel() for p in leaves)
    return (total * 1 + 4 * len(leaves)) / (total * 4)
