"""The ``Factorization`` artifact: packed factors plus solve-ready
enrichments computed once at factor time.

* ``packed``      — the packed LU: dense ``(n, n)`` (unit-lower L strictly
                    below the diagonal, U on and above it) or row-aligned
                    band ``(n, 2bw+1)``;
* ``linv``/``uinv`` — the **pre-inverted diagonal blocks** ``(S, B, B)``:
                    the unit-lower and upper in-block triangles of every
                    diagonal block, inverted at factor time, so every
                    diagonal step of the solve is one product against a
                    stored inverse (block inversion as in Chen, Liu & Yang,
                    "Parallel Triangular Solvers on GPU", arXiv 1606.00541);
* ``tlo``/``tup`` — the **pre-coupled transfer blocks** ``(S, C, bw)``
                    ``L^{-1}_i F_i^{above}`` / ``U^{-1}_i F_i^{below}``
                    (banded only): the skewed band's coupling columns
                    (:func:`repro_torch.core.banded.band_to_skewed`),
                    already multiplied through the inverses, so the
                    solve's only sequential dependence is a ``bw``-row
                    tail/head recurrence (SPIKE-style reduced system, Li,
                    Serban & Negrut, arXiv 1509.07919);
* ``health``      — the embedded screening record;
* ``tier``/``fingerprint`` — accuracy-tier and cache-identity metadata.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .banded import band_block_size, band_to_skewed, pad_band_identity
from .blocked import pad_identity_tail
from .health import FactorHealth

__all__ = [
    "Factorization",
    "dense_block_inverses",
    "banded_block_inverses",
    "banded_skewed_layout",
    "inverted_dense_sweeps",
    "inverted_band_sweeps",
    "dense_inverted_solve",
    "banded_inverted_solve",
    "equalized_rhs_tile",
    "factorize_dense",
    "factorize_banded",
    "dense_artifact",
    "banded_artifact",
    "packed_of",
]


def _packed_block_inverses(diags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``L^{-1}`` / ``U^{-1}`` of a ``(..., S, B, B)`` stack of packed
    diagonal blocks by batched triangular solves against the identity (each
    solve reads only its own triangle, so the packed layout needs no
    unpacking)."""
    b = diags.shape[-1]
    eye = torch.eye(b, dtype=diags.dtype, device=diags.device).expand(diags.shape)
    linv = torch.linalg.solve_triangular(diags, eye, upper=False, unitriangular=True)
    uinv = torch.linalg.solve_triangular(diags, eye, upper=True)
    # row-major once here, so that no kernel call copies them again
    return linv.contiguous(), uinv.contiguous()


def dense_block_inverses(lu: torch.Tensor, *, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(S, B, B)`` ``L^{-1}`` / ``U^{-1}`` stacks of the identity-padded
    packed LU's diagonal blocks (``(..., S, B, B)`` for a ``(..., n, n)``
    stack of factors), by batched triangular solves against the identity
    (each solve reads only its own triangle, so the packed layout needs no
    unpacking).  Runs once, at factor time."""
    n = lu.shape[-1]
    b = min(block, n)
    s = -(-n // b)
    lup = pad_identity_tail(lu, s * b)
    return _packed_block_inverses(torch.stack(
        [lup[..., i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(s)], dim=-3))


def banded_skewed_layout(lu_band: torch.Tensor, *, bw: int, block: int | None = None):
    """Solve-layout skewed band ``G`` ``(..., S·C, C+2bw)`` of the packed
    band factors ``(..., n, 2bw+1)``, plus its ``(C, S)`` blocking.  Derived
    once, at factor time."""
    n = lu_band.shape[-2]
    c = band_block_size(n, bw, block)
    s = -(-n // c)
    g = band_to_skewed(pad_band_identity(lu_band, bw, s * c), bw, c)
    return g, c, s


def banded_block_inverses(g: torch.Tensor, *, bw: int, block: int):
    """Banded solve enrichment from the skewed band ``G``: the in-window
    ``(S, C, C)`` ``L^{-1}`` / ``U^{-1}`` stacks plus the pre-coupled
    transfer blocks ``tlo[i] = L^{-1}_i F_i[:, :bw]`` (coupling to the
    block above) and ``tup[i] = U^{-1}_i F_i[:, bw+C:]`` (to the block
    below), each ``(S, C, bw)``; a stack of skewed bands gives stacks of
    these."""
    c = block
    s = g.shape[-2] // c
    f = g.reshape(*g.shape[:-2], s, c, c + 2 * bw)
    linv, uinv = _packed_block_inverses(f[..., bw:bw + c])
    return linv, uinv, linv @ f[..., :bw], uinv @ f[..., bw + c:]


def inverted_dense_sweeps(lup: torch.Tensor, linv: torch.Tensor, uinv: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Blocked forward then backward substitution on the identity-padded
    packed LU ``lup`` ``(S·B, S·B)``, where every diagonal step is one
    product against the pre-inverted block and the rows past it are retired
    by one rank-B product.  ``x`` ``(S·B, m)`` is updated in place and
    returned."""
    s, b = linv.shape[0], linv.shape[1]
    for i in range(s):
        lo, hi = i * b, (i + 1) * b
        x[lo:hi] = linv[i] @ x[lo:hi]
        if hi < s * b:
            x[hi:] -= lup[hi:, lo:hi] @ x[lo:hi]
    for i in range(s - 1, -1, -1):
        lo, hi = i * b, (i + 1) * b
        x[lo:hi] = uinv[i] @ x[lo:hi]
        if lo:
            x[:lo] -= lup[:lo, lo:hi] @ x[lo:hi]
    return x


def _affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All states ``y_i = a_i @ y_{i-1} + b_i`` (``y_{-1} = 0``) of a
    ``(S, k, k)`` / ``(S, k, m)`` stack, by a sequential loop over ``S``
    (PyTorch has no associative scan; the reference composes the affine
    maps in ``O(log S)`` levels, so the two round differently)."""
    out = torch.empty_like(b)
    out[0] = b[0]
    for i in range(1, b.shape[0]):
        out[i] = a[i] @ out[i - 1] + b[i]
    return out


def inverted_band_sweeps(linv: torch.Tensor, uinv: torch.Tensor, tlo: torch.Tensor,
                         tup: torch.Tensor, xb: torch.Tensor, *, bw: int) -> torch.Tensor:
    """Two-phase banded substitution on pre-inverted factors; ``xb`` is the
    RHS as solve blocks ``(S, C, m)``.

    Forward ``L y = x``: ``y_i = L^{-1}_i x_i − tlo_i · ytail_{i-1}``, where
    ``ytail`` is the last ``bw`` rows of the previous block: one batched
    product ``z = linv @ xb``, the ``(bw, m)`` tail recurrence
    ``ytail_i = ztail_i − tlo^{tail}_i ytail_{i-1}``, a second batched
    product.  The backward sweep mirrors it on the first ``bw`` rows."""
    s, c = linv.shape[0], linv.shape[1]
    z = linv @ xb
    if s == 1:  # no block couples to another (C < bw happens only here)
        return uinv @ z
    zero = torch.zeros((1, bw, xb.shape[-1]), dtype=xb.dtype, device=xb.device)
    ytail = _affine_scan(-tlo[:, c - bw:, :], z[:, c - bw:, :])
    y = z - tlo @ torch.cat([zero, ytail[:-1]])
    w = uinv @ y
    xhead = _affine_scan(-tup[:, :bw, :].flip(0), w[:, :bw, :].flip(0)).flip(0)
    return w - tup @ torch.cat([xhead[1:], zero])


def dense_inverted_solve(lu: torch.Tensor, linv: torch.Tensor, uinv: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`repro_torch.kernels.trsm.solve_inverted`:
    computes in (at least) fp32 and casts back to the RHS dtype."""
    squeeze = b.ndim == 1
    bm = b[:, None] if squeeze else b
    compute = torch.promote_types(torch.float32, torch.promote_types(lu.dtype, bm.dtype))
    n, m = bm.shape
    s, bb = linv.shape[0], linv.shape[1]
    lup = pad_identity_tail(lu.to(compute), s * bb)
    x = torch.zeros((s * bb, m), dtype=compute, device=bm.device)
    x[:n] = bm
    x = inverted_dense_sweeps(lup, linv.to(compute), uinv.to(compute), x)
    x = x[:n].to(bm.dtype)
    return x[:, 0] if squeeze else x


def banded_inverted_solve(linv: torch.Tensor, uinv: torch.Tensor, tlo: torch.Tensor,
                          tup: torch.Tensor, b: torch.Tensor, *, n: int, bw: int) -> torch.Tensor:
    """Plain PyTorch version of
    :func:`repro_torch.kernels.banded.banded_solve_inverted`: computes in
    the inverses' dtype and casts back to the RHS dtype."""
    s, c = linv.shape[0], linv.shape[1]
    squeeze = b.ndim == 1
    bm = b[:, None] if squeeze else b
    m = bm.shape[1]
    xb = torch.zeros((s * c, m), dtype=linv.dtype, device=bm.device)
    xb[:n] = bm
    x = inverted_band_sweeps(linv, uinv, tlo, tup, xb.reshape(s, c, m), bw=bw)
    x = x.reshape(s * c, m)[:n].to(bm.dtype)
    return x[:, 0] if squeeze else x


def equalized_rhs_tile(m: int, rhs_tile: int) -> int:
    """Equalized RHS tile width: split the ``m`` columns into
    ``ceil(m / rhs_tile)`` *equal-width* tiles rounded up to a multiple of 8
    — the paper's equalization applied to the solve grid."""
    tiles = max(1, -(-m // rhs_tile))
    rt = -(-m // tiles)
    if rt > 8:
        rt = -(-rt // 8) * 8
    return rt


@dataclasses.dataclass(frozen=True, eq=False)
class Factorization:
    """Packed factors + solve-ready enrichments (see module docstring).

    ``structure`` is "dense" or "banded"; ``bw`` the band half-width (0
    for dense); ``block`` the enrichment's solve-block size (for a band,
    the skewed layout's ``C``); ``tier`` the accuracy tier the factors were
    produced under; ``fingerprint`` the matrix identity for a serving
    cache."""

    packed: Any
    linv: Any = None
    uinv: Any = None
    tlo: Any = None
    tup: Any = None
    health: FactorHealth | None = None
    structure: str = "dense"
    bw: int = 0
    block: int = 0
    tier: float = 0.0
    fingerprint: str | None = None

    @property
    def shape(self):
        return self.packed.shape

    @property
    def ndim(self):
        return self.packed.ndim

    @property
    def dtype(self):
        return self.packed.dtype

    @property
    def n(self) -> int:
        return self.packed.shape[-2]

    @property
    def batched(self) -> bool:
        return self.packed.ndim > 2

    @property
    def enriched(self) -> bool:
        return self.linv is not None


def packed_of(x):
    """Artifact-or-tensor → the packed factor tensor."""
    return x.packed if isinstance(x, Factorization) else x


def factorize_dense(packed: torch.Tensor, *, block: int = 256, tier: float = 0.0,
                    health: FactorHealth | None = None, fingerprint: str | None = None,
                    enrich: bool = True) -> Factorization:
    """Wrap packed dense LU factors ``(..., n, n)`` into an artifact,
    pre-inverting the diagonal blocks of every system (in the ≥ fp32
    compute dtype the solves promote to) unless ``enrich=False``."""
    if isinstance(packed, Factorization):
        return packed
    b = min(block, packed.shape[-1])
    linv = uinv = None
    if enrich:
        compute = torch.promote_types(torch.float32, packed.dtype)
        linv, uinv = dense_block_inverses(packed.to(compute), block=b)
    return Factorization(packed=packed, linv=linv, uinv=uinv, health=health,
                         structure="dense", bw=0, block=b, tier=tier,
                         fingerprint=fingerprint)


def factorize_banded(packed: torch.Tensor, *, bw: int, block: int | None = None,
                     tier: float = 0.0, health: FactorHealth | None = None,
                     fingerprint: str | None = None, enrich: bool = True) -> Factorization:
    """Wrap packed band LU factors ``(..., n, 2bw+1)`` into an artifact,
    deriving the skewed solve layout and pre-inverting the in-window
    diagonal blocks of every system (in the ≥ fp32 compute dtype) unless
    ``enrich=False``."""
    if isinstance(packed, Factorization):
        return packed
    c = band_block_size(packed.shape[-2], bw, block)
    linv = uinv = tlo = tup = None
    if enrich:
        compute = torch.promote_types(torch.float32, packed.dtype)
        g, _, _ = banded_skewed_layout(packed.to(compute), bw=bw, block=c)
        linv, uinv, tlo, tup = banded_block_inverses(g, bw=bw, block=c)
    return Factorization(packed=packed, linv=linv, uinv=uinv, tlo=tlo, tup=tup,
                         health=health, structure="banded", bw=bw, block=c, tier=tier,
                         fingerprint=fingerprint)


def dense_artifact(x, *, block: int = 256) -> Factorization:
    """Artifact-or-tensor → *enriched* dense artifact (raw operands are
    wrapped and inverted on the fly)."""
    if isinstance(x, Factorization):
        if x.enriched:
            return x
        return factorize_dense(x.packed, block=x.block or block, tier=x.tier,
                               health=x.health, fingerprint=x.fingerprint)
    return factorize_dense(x, block=block)


def banded_artifact(x, *, bw: int, block: int | None = None) -> Factorization:
    """Artifact-or-tensor → *enriched* banded artifact (raw operands are
    wrapped and inverted on the fly)."""
    if isinstance(x, Factorization):
        if x.enriched:
            return x
        return factorize_banded(x.packed, bw=x.bw or bw, block=x.block or block, tier=x.tier,
                                health=x.health, fingerprint=x.fingerprint)
    return factorize_banded(x, bw=bw, block=block)
