"""Batched EbV solvers — the throughput path of the EbV-preconditioned
optimizer (many small independent systems, one per parameter factor).

The reference maps its single-system functions over the batch with
``jax.vmap``; here the batch is a leading dimension written out: every
elimination or substitution step runs on all systems at once, with the
same scalar operations per system as :func:`repro_torch.core.ebv.ebv_lu`
and :func:`repro_torch.core.solve.lu_solve`.  :func:`batched_ebv_lu` and
:func:`batched_lu_solve` are the plain versions of the CUDA kernels in
:mod:`repro_torch.kernels.batched_lu`.
"""
from __future__ import annotations

import torch

from . import blocked as _blocked
from .nonfinite import lu_spread, nan_above_last, nan_below_first

__all__ = [
    "batched_ebv_lu",
    "batched_lu_solve",
    "batched_linear_solve",
    "batched_linear_solve_many",
]


def batched_ebv_lu(a: torch.Tensor) -> torch.Tensor:
    """Unblocked EbV LU (no pivoting) of every ``(n, n)`` system of a
    ``(..., n, n)`` stack: per step the column below the pivot is divided
    by the pivot and one rank-1 update retires it; non-finite entries
    spread NaN as the reference's masked steps do
    (:func:`~repro_torch.core.nonfinite.lu_spread`).  Returns the packed
    factors in a new tensor."""
    a = a.clone()
    for k in range(a.shape[-1] - 1):
        a[..., k + 1:, k] /= a[..., k, k:k + 1]
        a[..., k + 1:, k + 1:] -= a[..., k + 1:, k:k + 1] * a[..., k:k + 1, k + 1:]
    return lu_spread(a)


def batched_lu_solve(lu, b: torch.Tensor) -> torch.Tensor:
    """Forward and backward substitution for every system of a packed
    ``(..., n, n)`` stack; ``b`` is ``(..., n)`` (a vector per system) or
    ``(..., n, m)``.  Column-oriented like :func:`repro_torch.core.solve.lu_solve`:
    once ``y[k]`` is final, one axpy eliminates it from every later row;
    backward, ``x[k]`` is divided by the pivot, then eliminated from every
    earlier row.  Non-finite values spread NaN as the reference's masked
    axpys do (:mod:`repro_torch.core.nonfinite`)."""
    lu = getattr(lu, "packed", lu)  # accept Factorization artifacts
    squeeze = b.ndim == lu.ndim - 1
    x = (b[..., None] if squeeze else b).clone()
    n = lu.shape[-1]
    for k in range(n - 1):
        x[..., k + 1:, :] -= lu[..., k + 1:, k:k + 1] * x[..., k:k + 1, :]
    x = nan_above_last(x, n - 1)
    for k in range(n - 1, -1, -1):
        x[..., k:k + 1, :] /= lu[..., k:k + 1, k:k + 1]
        x[..., :k, :] -= lu[..., :k, k:k + 1] * x[..., k:k + 1, :]
    x = nan_below_first(x)
    return x[..., 0] if squeeze else x


def batched_linear_solve(a: torch.Tensor, b: torch.Tensor, *, method: str = "ebv",
                         block: int = 128) -> torch.Tensor:
    """Solve a batch of diagonally dominant systems ``a[i] x[i] = b[i]``;
    ``b`` is ``(B, n)`` or ``(B, n, m)``.

    ``method="auto"`` routes through the ``repro_torch.solvers`` registry,
    which lands on the batched CUDA kernels for fp32 stacks on the card;
    ``"ebv"`` (unblocked) and ``"ebv_blocked"`` factor here, ``"torch"``
    is ``torch.linalg.solve`` (the cross-check baseline)."""
    if method == "auto":
        from repro_torch.kernels import ops as _kops  # deferred: kernels imports core

        squeeze = b.ndim == a.ndim - 1
        x = _kops.linear_solve(a, b[..., None] if squeeze else b, block=block)
        return x[..., 0] if squeeze else x
    if method == "ebv":
        lu = batched_ebv_lu(a)
    elif method == "ebv_blocked":
        lu = torch.stack([_blocked.blocked_lu(m, block=block) for m in a])
    elif method == "torch":
        return torch.linalg.solve(a, b)
    else:
        raise ValueError(f"unknown method {method!r}")
    return batched_lu_solve(lu, b)


def batched_linear_solve_many(a: torch.Tensor, bs, *, method: str = "ebv",
                              block: int = 128) -> list[torch.Tensor]:
    """Factor the ``(B, n, n)`` stack once and solve every RHS in ``bs``
    (each ``(B, n)`` or ``(B, n, m_i)``) in one wide batched substitution,
    then split the columns back per request."""
    cols, widths, squeezes = [], [], []
    for b in bs:
        squeeze = b.ndim == a.ndim - 1
        bm = b[..., None] if squeeze else b
        cols.append(bm)
        widths.append(bm.shape[-1])
        squeezes.append(squeeze)
    x = batched_linear_solve(a, torch.cat(cols, dim=-1), method=method, block=block)
    out, c0 = [], 0
    for w, squeeze in zip(widths, squeezes):
        blk = x[..., c0:c0 + w]
        out.append(blk[..., 0] if squeeze else blk)
        c0 += w
    return out
