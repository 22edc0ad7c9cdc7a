"""fp32 iterative refinement over a lower-precision factorization.

The mixed-precision tier: factor once from a bf16-rounded operand, then
recover fp32 accuracy by refining the solution against the
*full-precision* operand:

    r_i = b - A x_i            (fp32 residual against the exact A)
    d_i = solve(LU_bf16, r_i)  (cheap correction through the bf16 factors)
    x_{i+1} = x_i + d_i

For the diagonally dominant operands of the paper's contract the iteration
contracts by roughly the bf16 unit roundoff (~2^-8) per sweep.  The loop
runs on the host (the reference's ``lax.while_loop``) with one
synchronisation per sweep to read the residual norm, capped at
``max_iters``; the sweeps taken and the residual reached are kept for
:func:`last_refinement`.  A stack of systems refines each system until it
meets the tolerance (the reference's vmapped loop) and reports its worst
member.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["RefineInfo", "iterative_refinement", "last_refinement", "DEFAULT_MAX_ITERS"]

DEFAULT_MAX_ITERS = 12


class RefineInfo(NamedTuple):
    iterations: int  # refinement sweeps taken (0 = x0 sufficed); a stack's worst member
    residual: float  # final relative residual |Ax-b|/|b|; a stack's worst member


# the refinement this process ran last
_LAST: dict = {"iterations": None, "residual": None}


def last_refinement() -> dict:
    """``{"iterations": int | None, "residual": float | None}`` of the most
    recent refinement (None before any ran)."""
    return dict(_LAST)


def _note(iterations: torch.Tensor, residual: torch.Tensor) -> RefineInfo:
    # a stack reports its worst member, the binding number for a budget
    info = RefineInfo(iterations=int(iterations.max()), residual=float(residual.max()))
    _LAST["iterations"], _LAST["residual"] = info.iterations, info.residual
    return info


def iterative_refinement(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                         solve_fn: Callable[[torch.Tensor], torch.Tensor], *, tolerance: float,
                         max_iters: int = DEFAULT_MAX_ITERS) -> tuple[torch.Tensor, RefineInfo]:
    """Refine ``x0`` toward ``solve(a, b)`` until the relative residual
    drops to ``tolerance`` or ``max_iters`` sweeps elapse.

    ``solve_fn`` maps a residual (shaped like ``b``) to a correction
    through the approximate factors; ``a`` and ``b`` are taken in fp32, so
    the residual is measured against the exact operand.  ``a`` is
    ``(..., n, n)`` and ``b`` ``(..., n)`` or ``(..., n, m)``; the residual
    norm is Frobenius over all columns of a system.  Returns the fp32
    solution and its :class:`RefineInfo`."""
    a32 = a.to(torch.float32)
    vec = b.ndim == a.ndim - 1
    b32 = b.to(torch.float32)
    bm = b32[..., None] if vec else b32
    x = (x0[..., None] if vec else x0).to(torch.float32)

    def norm(t):
        return torch.linalg.norm(t, dim=(-2, -1))

    bnorm = torch.clamp(norm(bm), min=1e-30)
    r = bm - a32 @ x
    rn = norm(r)
    iters = torch.zeros_like(rn, dtype=torch.int32)
    for _ in range(max_iters):
        active = rn > tolerance * bnorm
        if not bool(active.any()):  # the sweep's one synchronisation
            break
        d = solve_fn(r[..., 0] if vec else r).to(torch.float32)
        x = torch.where(active[..., None, None], x + (d[..., None] if vec else d), x)
        iters = iters + active.to(torch.int32)
        r = bm - a32 @ x
        rn = norm(r)
    info = _note(iters, rn / bnorm)
    return (x[..., 0] if vec else x), info
