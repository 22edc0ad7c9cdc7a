"""Randomized low-rank LU solves (after Shabat, Shmueli & Averbuch,
arXiv 1310.7202), restructured for the no-pivot contract.

The cheap tier of the accuracy axis: sketch the range with a Gaussian
projection and factor only the sketch.  Un-pivoted elimination of a raw
Gaussian sketch has erratic element growth, so the elimination moves to
the sketch's SPD Gram matrix, where no-pivot LU is growth-free: a
CholeskyQR whose triangular factor comes from the no-pivot LU (``lu_impl``,
the fused kernel on the card):

    G    ~  N(0, 1)                 (n, k+p)  Gaussian test matrix
    Y    =  A @ G                   (n, k+p)  range sketch
    M    =  YᵀY + ridge·I           (k+p)²    SPD Gram matrix
    LDLᵀ =  no-pivot-LU(M)
    Q    =  (Y L⁻ᵀ D^(-1/2))[:, :k] orthonormal range basis
    B    =  Qᵀ A                    (k, n)

so ``A ≈ l @ u`` with ``l = Q`` and ``u = B``.  Solves use ``l⁺ = lᵀ``:
min-norm least squares through the k×k SPD system ``(u uᵀ) w = lᵀ b``,
``x = uᵀ w``.

The Gaussian sketch comes from an explicit ``torch.Generator`` (seed 0 on
the operand's device when none is given), or is passed in as ``sketch=``
(the tests pass the matrix the reference draws).  The two frameworks'
generators give different numbers from one seed.

**Operand class / residual guarantee**: operands of numerical rank ≤ k
with range-consistent RHS, relative residual within
``repro_torch.solvers.backends.RAND_LU_RESIDUAL_BOUND``.
:func:`randomized_linear_solve` polishes through
:func:`repro_torch.core.refine.iterative_refinement` against the full
operand.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .blocked import fused_blocked_lu
from .refine import iterative_refinement
from .solve import lu_solve, unit_lower_solve_packed

__all__ = ["RankKFactors", "randomized_lu", "randomized_solve", "randomized_linear_solve",
           "GRAM_RIDGE"]

# Relative Tikhonov shift on the sketch Gram matrix: keeps the trailing
# pivots of a numerically rank-deficient sketch positive without perturbing
# the leading spectrum above fp32 Gram round-off.
GRAM_RIDGE = 1e-6


class RankKFactors(NamedTuple):
    """Rank-k factorization ``A ≈ l @ u``: ``l`` (n, k) orthonormal range
    basis (so ``l⁺ = lᵀ``), ``u`` (k, n) its coefficient rows ``lᵀ A``."""

    l: torch.Tensor
    u: torch.Tensor

    @property
    def rank(self) -> int:
        return self.l.shape[-1]


def _spd_solve(m: torch.Tensor, rhs: torch.Tensor, lu_impl: Callable) -> torch.Tensor:
    """k×k SPD system through the no-pivot LU (growth-free class)."""
    return lu_solve(lu_impl(m), rhs)


def _f32_product(x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (x.to(torch.float32) @ y.to(torch.float32)).to(dtype)


def randomized_lu(a: torch.Tensor, *, rank: int, oversample: int = 8,
                  generator: torch.Generator | None = None, sketch: torch.Tensor | None = None,
                  lu_impl: Callable[[torch.Tensor], torch.Tensor] | None = None) -> RankKFactors:
    """Rank-``rank`` randomized factorization of ``a`` ((n, n)).

    ``sketch`` is the (n, k+p) Gaussian test matrix; without one it is drawn
    from ``generator``.  ``lu_impl`` factors the (k+p, k+p) SPD Gram matrix
    (default the plain :func:`repro_torch.core.blocked.fused_blocked_lu`;
    the registry's backend passes the fused kernel).  The basis is
    truncated back to ``rank`` columns."""
    n = a.shape[-1]
    k = min(int(rank), n)
    p = min(int(oversample), n - k)
    if lu_impl is None:
        lu_impl = fused_blocked_lu
    if sketch is None:
        if generator is None:
            generator = torch.Generator(device=a.device).manual_seed(0)
        g = torch.randn((n, k + p), generator=generator, dtype=torch.float32,
                        device=generator.device).to(device=a.device, dtype=a.dtype)
    else:
        if tuple(sketch.shape) != (n, k + p):
            raise ValueError(f"sketch must be ({n}, {k + p}), got {tuple(sketch.shape)}")
        g = sketch.to(device=a.device, dtype=a.dtype)
    y = _f32_product(a, g, a.dtype)
    gram = _f32_product(y.T, y, a.dtype)
    ridge = GRAM_RIDGE * torch.trace(gram) / (k + p)
    ldl = lu_impl(gram + ridge * torch.eye(k + p, dtype=a.dtype, device=a.device))
    # the packed no-pivot LU of an SPD M is its LDLᵀ: unit-lower L below,
    # D·Lᵀ above, the pivots D on the diagonal
    d = torch.diagonal(ldl)
    wt = unit_lower_solve_packed(ldl, y.T)  # solves L Wᵀ = Yᵀ
    q = (wt.T * torch.rsqrt(d)[None, :])[:, :k]
    return RankKFactors(l=q, u=_f32_product(q.T, a, a.dtype))


def randomized_solve(factors: RankKFactors, b: torch.Tensor) -> torch.Tensor:
    """Min-norm least-squares solve against rank-k factors (vector or
    matrix RHS): ``x = uᵀ (u uᵀ)⁻¹ lᵀ b``."""
    l, u = factors.l, factors.u
    k = u.shape[0]
    w = _spd_solve(_f32_product(u, u.T, u.dtype), l.T @ b,
                   lambda m: fused_blocked_lu(m, block=min(256, k)))
    return u.T @ w


def randomized_linear_solve(a: torch.Tensor, b: torch.Tensor, *, rank: int, oversample: int = 8,
                            generator: torch.Generator | None = None,
                            sketch: torch.Tensor | None = None,
                            lu_impl: Callable[[torch.Tensor], torch.Tensor] | None = None,
                            tolerance: float = 1e-3, max_refine_iters: int = 4) -> torch.Tensor:
    """Factor + solve in one call (the ``linear_solve`` slot's adapter),
    polished by fp32 iterative refinement against the full operand until
    ``tolerance``."""
    factors = randomized_lu(a, rank=rank, oversample=oversample, generator=generator,
                            sketch=sketch, lu_impl=lu_impl)
    x, _info = iterative_refinement(a, b, randomized_solve(factors, b),
                                    lambda r: randomized_solve(factors, r),
                                    tolerance=tolerance, max_iters=max_refine_iters)
    return x
