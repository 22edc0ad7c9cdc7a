"""Triangular solves and the public ``linear_solve`` API.

The substitution phases follow the paper's vectorized (column-oriented)
form: once pivot ``k`` resolves, one axpy retires its contribution from
every remaining row — the solve-phase analogue of the bi-vectorized
elimination step.
"""
from __future__ import annotations

import torch

from . import ebv as _ebv
from .nonfinite import nan_above_last, nan_below_first

__all__ = [
    "forward_substitution",
    "backward_substitution",
    "unit_lower_solve_packed",
    "lu_solve",
    "linear_solve",
    "stack_rhs",
    "split_rhs",
    "lu_solve_stacked",
    "linear_solve_many",
]


def forward_substitution(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L y = b`` with the packed factor's implicit unit diagonal.
    Column-oriented: once ``y[k]`` is final, one axpy eliminates it from
    every later row; a non-finite ``y[k]`` turns NaN the rows at or above
    it, as the reference's masked axpy does (:mod:`.nonfinite`)."""
    squeeze = b.ndim == 1
    y = (b[:, None] if squeeze else b).clone()
    n = lu.shape[-1]
    for k in range(n - 1):
        y[k + 1:] -= lu[k + 1:, k:k + 1] * y[k:k + 1]
    y = nan_above_last(y, n - 1)
    return y[:, 0] if squeeze else y


def backward_substitution(lu: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``U x = y`` (the diagonal of U lives on the packed diagonal);
    a non-finite ``x[k]`` turns NaN the rows at or below it, as the
    reference's masked axpy does."""
    squeeze = y.ndim == 1
    x = (y[:, None] if squeeze else y).clone()
    for k in range(lu.shape[-1] - 1, -1, -1):
        x[k] /= lu[k, k]
        x[:k] -= lu[:k, k:k + 1] * x[k:k + 1]
    x = nan_below_first(x)
    return x[:, 0] if squeeze else x


def unit_lower_solve_packed(l_packed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution against the strictly-lower part of a packed
    square block (unit diagonal implicit)."""
    return forward_substitution(l_packed, b)


def lu_solve(lu, b: torch.Tensor) -> torch.Tensor:
    """Both substitution phases against a packed EbV factorization."""
    lu = getattr(lu, "packed", lu)  # accept Factorization artifacts
    return backward_substitution(lu, forward_substitution(lu, b))


# ---------------------------------------------------------------------------
# stacked-RHS paths — the factor-once/solve-many serving shape: requests
# against the SAME matrix coalesce into one wide substitution
# ---------------------------------------------------------------------------
def stack_rhs(bs) -> tuple[torch.Tensor, list[int], list[bool]]:
    """hstack a sequence of (n,) / (n, m_i) RHS into one (n, Σm_i) tensor.
    Returns (stacked, widths, squeezes) for :func:`split_rhs`."""
    cols, widths, squeezes = [], [], []
    for b in bs:
        squeeze = b.ndim == 1
        bm = b[:, None] if squeeze else b
        cols.append(bm)
        widths.append(bm.shape[1])
        squeezes.append(squeeze)
    return torch.cat(cols, dim=1), widths, squeezes


def split_rhs(x: torch.Tensor, widths: list[int], squeezes: list[bool]) -> list[torch.Tensor]:
    """Inverse of :func:`stack_rhs` on the solved columns."""
    out, c0 = [], 0
    for w, squeeze in zip(widths, squeezes):
        blk = x[:, c0:c0 + w]
        out.append(blk[:, 0] if squeeze else blk)
        c0 += w
    return out


def lu_solve_stacked(lu, bs) -> list[torch.Tensor]:
    """Solve one packed factorization against many RHS in ONE wide
    substitution pass; returns per-request results."""
    stacked, widths, squeezes = stack_rhs(bs)
    return split_rhs(lu_solve(lu, stacked), widths, squeezes)


def _factor(a: torch.Tensor, method: str, block: int) -> torch.Tensor:
    if method == "ebv":
        return _ebv.ebv_lu(a)
    if method == "ebv_blocked":
        from . import blocked as _blocked

        return _blocked.blocked_lu(a, block=block)
    raise ValueError(f"unknown method {method!r}")


def linear_solve_many(a: torch.Tensor, bs, *, method: str = "ebv_blocked",
                      block: int = 256) -> list[torch.Tensor]:
    """Factor ``a`` ONCE, then solve every RHS in ``bs`` through the stacked
    path (same ``method`` vocabulary as :func:`linear_solve`)."""
    if method in ("auto", "torch"):
        stacked, widths, squeezes = stack_rhs(bs)
        return split_rhs(linear_solve(a, stacked, method=method, block=block),
                         widths, squeezes)
    return lu_solve_stacked(_factor(a, method, block), bs)


def linear_solve(a: torch.Tensor, b: torch.Tensor, *, method: str = "ebv_blocked",
                 block: int = 256) -> torch.Tensor:
    """Solve ``A x = b`` for diagonally-dominant ``A`` (paper contract, no
    pivoting).

    methods:
      * ``"ebv"``          — paper-faithful unblocked bi-vectorized LU.
      * ``"ebv_blocked"``  — blocked (rank-k) EbV LU.
      * ``"torch"``        — ``torch.linalg.solve`` (cross-check baseline).
      * ``"auto"``         — the ``repro_torch.solvers`` registry (lands on
                             the CUDA kernels for tensors on the card).
    """
    if method == "auto":
        from repro_torch.kernels import ops as _kops  # deferred: kernels imports core

        return _kops.linear_solve(a, b, block=block)
    if method == "torch":
        return torch.linalg.solve(a, b)
    return lu_solve(_factor(a, method, block), b)
