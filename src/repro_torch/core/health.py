"""Post-factorization health screening for the no-pivot EbV contract.

Every factorization here is un-pivoted LU, so a zero or tiny pivot silently
produces Inf/NaN factors, and un-pivoted elimination of an off-class
operand shows *element growth* (max|U| far above max|A|) long before it
overflows.  The screening record holds:

* **min |pivot|** — compared relative to ``max|A|`` so the check is
  scale-invariant;
* **element growth** — ``max|U| / max|A|``;
* **finiteness** — any Inf/NaN anywhere in the packed factors.

Dense factors and row-aligned band factors (``bw > 0``) are screened
alike; a band's residual is computed on the band, never densified.  A
stack of factors (leading batch axes) reduces to the worst system's
record, and a stack's residual is its worst system's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = [
    "HealthThresholds",
    "DEFAULT_THRESHOLDS",
    "FactorHealth",
    "factor_health",
    "relative_residual",
    "banded_matvec",
]

_TINY = 1e-30  # denominator floor: an all-zero operand is its own problem


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """Verdict bounds for a :class:`FactorHealth` record.

    ``min_pivot_ratio``  smallest acceptable ``min|pivot| / max|A|``.
    ``max_growth``       largest acceptable ``max|U| / max|A|``.
    ``require_finite``   whether any Inf/NaN in the factors fails the verdict.
    """

    min_pivot_ratio: float = 1e-10
    max_growth: float = 1e6
    require_finite: bool = True


DEFAULT_THRESHOLDS = HealthThresholds()


class FactorHealth(NamedTuple):
    """Screening record for one factorization; every field is a scalar
    tensor on the factor's device.  A stack of factors reduces to the worst
    system: one bad system taints the whole record."""

    min_pivot: torch.Tensor  # min |pivot|
    growth: torch.Tensor     # max|U| / max|A|
    finite: torch.Tensor     # bool: every packed factor entry finite
    ref_max: torch.Tensor    # max|A| of the operand

    def ok(self, thresholds: HealthThresholds | None = None) -> torch.Tensor:
        """Device-side verdict (bool scalar).  NaN fields compare False, so
        a poisoned record can never pass."""
        t = thresholds or DEFAULT_THRESHOLDS
        good = (self.min_pivot >= t.min_pivot_ratio * self.ref_max) & (self.growth <= t.max_growth)
        if t.require_finite:
            good = good & self.finite
        return good

    def verdict(self, thresholds: HealthThresholds | None = None) -> bool:
        """Host verdict."""
        return bool(self.ok(thresholds))

    def report(self, thresholds: HealthThresholds | None = None) -> str:
        """One-line reason string for logs and failure records."""
        t = thresholds or DEFAULT_THRESHOLDS
        mp, gr, fin, rm = (float(self.min_pivot), float(self.growth),
                           bool(self.finite), float(self.ref_max))
        parts = []
        if t.require_finite and not fin:
            parts.append("non-finite factor entries")
        if not mp >= t.min_pivot_ratio * rm:  # NaN-safe
            parts.append(f"min|pivot|={mp:.3e} < {t.min_pivot_ratio:g}*max|A|={t.min_pivot_ratio * rm:.3e}")
        if not gr <= t.max_growth:
            parts.append(f"growth={gr:.3e} > {t.max_growth:g}")
        return "; ".join(parts) if parts else f"healthy (min|pivot|={mp:.3e}, growth={gr:.3e})"


def _dense_health(packed: torch.Tensor, ref_max: torch.Tensor) -> FactorHealth:
    umax = torch.triu(packed.abs()).max()
    return FactorHealth(
        min_pivot=torch.diagonal(packed, dim1=-2, dim2=-1).abs().min(),
        growth=umax / torch.clamp(ref_max, min=_TINY),
        finite=torch.isfinite(packed).all(),
        ref_max=ref_max,
    )


def _banded_health(packed: torch.Tensor, ref_max: torch.Tensor, bw: int) -> FactorHealth:
    # row-aligned band: column bw holds the pivots, columns bw..2bw the U
    # part, columns 0..bw-1 the L multipliers
    return FactorHealth(
        min_pivot=packed[..., bw].abs().min(),
        growth=packed[..., bw:].abs().max() / torch.clamp(ref_max, min=_TINY),
        finite=torch.isfinite(packed).all(),
        ref_max=ref_max,
    )


def factor_health(factors, *, ref_max, bw: int = 0) -> FactorHealth:
    """Screening record for a packed dense ``(..., n, n)`` factor, a packed
    row-aligned band ``(..., n, 2bw+1)`` (``bw > 0``), a
    :class:`~repro_torch.core.factorization.Factorization`,
    :class:`~repro_torch.core.pivoted.PivotedFactors` or
    :class:`~repro_torch.core.randomized.RankKFactors`; leading batch axes
    reduce to the worst system.  ``ref_max`` is ``max|A|`` of the operand
    that was factored."""
    from .pivoted import PivotedFactors
    from .randomized import RankKFactors

    factors = getattr(factors, "packed", factors)
    if isinstance(factors, RankKFactors):
        # no square pivot sequence: the analogue of a vanished pivot is a
        # collapsed coefficient row of u (its basis column spans nothing)
        l, u = factors
        ref_max = torch.as_tensor(ref_max, dtype=torch.float32, device=u.device)
        amax = torch.maximum(l.abs().max(), u.abs().max()).to(torch.float32)
        return FactorHealth(min_pivot=u.abs().max(dim=-1).values.min().to(torch.float32),
                            growth=amax / torch.clamp(ref_max, min=_TINY),
                            finite=torch.isfinite(l).all() & torch.isfinite(u).all(),
                            ref_max=ref_max)
    if isinstance(factors, PivotedFactors):
        factors = factors.lu
    ref_max = torch.as_tensor(ref_max, dtype=torch.float32, device=factors.device)
    if bw:
        return _banded_health(factors, ref_max, bw)
    return _dense_health(factors, ref_max)


def banded_matvec(arow: torch.Tensor, x: torch.Tensor, *, bw: int) -> torch.Tensor:
    """``A @ x`` on the row-aligned band (``arow[i, t] = A[i, i-bw+t]``)
    without densifying: O(n·bw) work and memory.  ``arow`` is
    ``(..., n, 2bw+1)`` and ``x`` ``(..., n)`` or ``(..., n, m)``."""
    n = arow.shape[-2]
    squeeze = x.ndim == arow.ndim - 1
    xm = x[..., None] if squeeze else x
    xp = torch.nn.functional.pad(xm, (0, 0, bw, bw))  # (..., n + 2bw, m)
    y = torch.zeros_like(xm)
    for t in range(2 * bw + 1):
        y = y + arow[..., t:t + 1] * xp[..., t:t + n, :]
    return y[..., 0] if squeeze else y


def relative_residual(a, b, x, *, bw: int = 0) -> torch.Tensor:
    """Frobenius relative residual ``|Ax - b| / |b|`` of a dense ``(n, n)``
    or row-aligned band operand (``bw > 0``).  For a stack of systems
    (``a`` ``(..., n, n)`` or ``(..., n, 2bw+1)``, ``b`` and ``x``
    ``(..., n)`` or ``(..., n, m)``) it is the worst system's."""
    a32, b32, x32 = (t.to(torch.float32) for t in (a, b, x))
    if b32.ndim == a32.ndim - 1:  # a vector (per system)
        b32, x32 = b32[..., None], x32[..., None]
    ax = banded_matvec(a32, x32, bw=bw) if bw else a32 @ x32
    dims = (-2, -1)
    res = torch.linalg.norm(b32 - ax, dim=dims) / torch.clamp(torch.linalg.norm(b32, dim=dims),
                                                               min=_TINY)
    return res.max()
