"""Post-factorization health screening for the no-pivot EbV contract.

Every factorization here is un-pivoted LU, so a zero or tiny pivot silently
produces Inf/NaN factors, and un-pivoted elimination of an off-class
operand shows *element growth* (max|U| far above max|A|) long before it
overflows.  The screening record holds:

* **min |pivot|** — compared relative to ``max|A|`` so the check is
  scale-invariant;
* **element growth** — ``max|U| / max|A|``;
* **finiteness** — any Inf/NaN anywhere in the packed factors.

This is the dense half of the reference module; the banded record arrives
with the banded slice.
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
    tensor on the factor's device."""

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


def factor_health(factors, *, ref_max, bw: int = 0) -> FactorHealth:
    """Screening record for a packed dense ``(n, n)`` factor, a
    :class:`~repro_torch.core.factorization.Factorization` or
    :class:`~repro_torch.core.pivoted.PivotedFactors`.  ``ref_max`` is
    ``max|A|`` of the operand that was factored."""
    from .pivoted import PivotedFactors

    if bw:
        raise NotImplementedError("banded health records arrive with the banded slice (ROADMAP queue A, item 8)")
    factors = getattr(factors, "packed", factors)
    if isinstance(factors, PivotedFactors):
        factors = factors.lu
    ref_max = torch.as_tensor(ref_max, dtype=torch.float32, device=factors.device)
    return _dense_health(factors, ref_max)


def relative_residual(a, b, x, *, bw: int = 0) -> torch.Tensor:
    """Frobenius relative residual ``|Ax - b| / |b|`` of a dense system."""
    if bw:
        raise NotImplementedError("banded residuals arrive with the banded slice (ROADMAP queue A, item 8)")
    a32, b32, x32 = (t.to(torch.float32) for t in (a, b, x))
    return torch.linalg.norm(b32 - a32 @ x32) / torch.clamp(torch.linalg.norm(b32), min=_TINY)
