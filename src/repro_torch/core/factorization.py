"""The ``Factorization`` artifact: packed factors plus solve-ready
enrichments computed once at factor time (dense half).

* ``packed``      — the packed LU ``(n, n)``: unit-lower L strictly below
                    the diagonal, U on and above it;
* ``linv``/``uinv`` — the **pre-inverted diagonal blocks** ``(S, B, B)``:
                    the unit-lower and upper in-block triangles of every
                    diagonal block, inverted at factor time, so every
                    diagonal step of the solve is one product against a
                    stored inverse (block inversion as in Chen, Liu & Yang,
                    "Parallel Triangular Solvers on GPU", arXiv 1606.00541);
* ``health``      — the embedded screening record;
* ``tier``/``fingerprint`` — accuracy-tier and cache-identity metadata.

The banded half (skewed layout, transfer blocks) arrives with the banded
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .blocked import pad_identity_tail
from .health import FactorHealth

__all__ = [
    "Factorization",
    "dense_block_inverses",
    "inverted_dense_sweeps",
    "dense_inverted_solve",
    "equalized_rhs_tile",
    "factorize_dense",
    "dense_artifact",
    "packed_of",
]


def dense_block_inverses(lu: torch.Tensor, *, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(S, B, B)`` ``L^{-1}`` / ``U^{-1}`` stacks of the identity-padded
    packed LU's diagonal blocks, by batched triangular solves against the
    identity (each solve reads only its own triangle, so the packed layout
    needs no unpacking).  Runs once, at factor time."""
    n = lu.shape[-1]
    b = min(block, n)
    s = -(-n // b)
    lup = pad_identity_tail(lu, s * b)
    diags = torch.stack([lup[i * b:(i + 1) * b, i * b:(i + 1) * b] for i in range(s)])
    eye = torch.eye(b, dtype=lu.dtype, device=lu.device).expand(s, b, b)
    linv = torch.linalg.solve_triangular(diags, eye, upper=False, unitriangular=True)
    uinv = torch.linalg.solve_triangular(diags, eye, upper=True)
    return linv, uinv


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

    ``structure`` is "dense" in this slice; ``block`` is the enrichment's
    solve-block size; ``tier`` the accuracy tier the factors were produced
    under; ``fingerprint`` the matrix identity for a serving cache."""

    packed: Any
    linv: Any = None
    uinv: Any = None
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
    def enriched(self) -> bool:
        return self.linv is not None


def packed_of(x):
    """Artifact-or-tensor → the packed factor tensor."""
    return x.packed if isinstance(x, Factorization) else x


def factorize_dense(packed: torch.Tensor, *, block: int = 256, tier: float = 0.0,
                    health: FactorHealth | None = None, fingerprint: str | None = None,
                    enrich: bool = True) -> Factorization:
    """Wrap packed dense LU factors ``(n, n)`` into an artifact,
    pre-inverting the diagonal blocks (in the ≥ fp32 compute dtype the
    solves promote to) unless ``enrich=False``."""
    if isinstance(packed, Factorization):
        return packed
    if packed.ndim != 2:
        raise NotImplementedError("batched factorizations arrive with the batched slice (ROADMAP queue A, item 9)")
    b = min(block, packed.shape[-1])
    linv = uinv = None
    if enrich:
        compute = torch.promote_types(torch.float32, packed.dtype)
        linv, uinv = dense_block_inverses(packed.to(compute), block=b)
    return Factorization(packed=packed, linv=linv, uinv=uinv, health=health,
                         structure="dense", bw=0, block=b, tier=tier,
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
