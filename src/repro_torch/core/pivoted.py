"""Partial-pivoting dense LU — the last-resort fallback tier.

The EbV contract is *no pivoting*, and every fast path honours it.  An
operand with a vanishing leading pivot is outside the no-pivot class; the
registry's escalation funnel reaches this module after the no-pivot
backends fail their health screen.  Classical row-partial-pivoting LU with
one rank-1 update per step, registered at the lowest dense priority so it
never wins a default selection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .solve import lu_solve

__all__ = ["PivotedFactors", "pivoted_lu", "pivoted_solve", "pivoted_linear_solve"]


class PivotedFactors(NamedTuple):
    """Row-pivoted factorization ``P A = L U``: ``lu`` is the packed (n, n)
    L\\U of the permuted operand, ``perm`` the int64 row permutation
    (``(P A)[i] = A[perm[i]]``)."""

    lu: torch.Tensor
    perm: torch.Tensor


def pivoted_lu(a: torch.Tensor) -> PivotedFactors:
    """Row-partial-pivoting LU of a dense (n, n) operand: each step swaps
    the max-|value| row of the active column into pivot position before the
    rank-1 elimination."""
    m = a.clone()
    n = m.shape[-1]
    perm = torch.arange(n, device=m.device)
    for k in range(n):
        p = k + int(torch.argmax(m[k:, k].abs()))
        if p != k:
            m[[k, p]] = m[[p, k]]
            perm[[k, p]] = perm[[p, k]]
        m[k + 1:, k] /= m[k, k]
        m[k + 1:, k + 1:] -= m[k + 1:, k:k + 1] * m[k:k + 1, k + 1:]
    return PivotedFactors(lu=m, perm=perm)


def pivoted_solve(factors: PivotedFactors, b: torch.Tensor) -> torch.Tensor:
    """Apply the row permutation to the RHS, then the packed sweeps."""
    return lu_solve(factors.lu, b[factors.perm])


def pivoted_linear_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return pivoted_solve(pivoted_lu(a), b)
