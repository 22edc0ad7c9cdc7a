"""Public solver ops — a thin layer over ``repro_torch.solvers``.

Every call builds a :class:`~repro_torch.solvers.Problem` from its tensor
arguments and routes through the registry: capability filter → measured
autotune cache → static priorities.  ``impl=`` forces a backend.

``lu``: ``"cuda_fused"`` (the default for fp32), ``"torch"`` (its plain
version, the static winner for other dtypes), ``"pivoted"`` (the partial
pivoting last resort).

``lu_solve``: ``"cuda_vmem"`` (the default for n ≤ 2048), ``"cuda_tiled"``
(above), ``"cuda_inverted"`` / ``"torch_inverted"`` (enriched
``Factorization`` operands), ``"torch"``.

``banded_lu`` (row-aligned band ``(n, 2bw+1)``): ``"cuda_blocked"`` /
``"cuda_tiled"`` (the static split is
:func:`repro_torch.solvers.backends.banded_static_impl`), ``"torch"``,
``"torch_scalar"``.

``banded_solve``: ``"cuda"`` (the default for fp32), ``"cuda_inverted"`` /
``"torch_inverted"`` (enriched operands), ``"torch"``, ``"torch_scalar"``.

Ops run where their tensors lie: on the card the ``cuda_*`` backends
launch their kernels, on the CPU they run their plain versions.  Anything
outside the ported slices (batched operands, ``mesh=``, a dense
``tolerance > 0``, ``rank=``) raises ``NotImplementedError`` naming the
slice that brings it.
"""
from __future__ import annotations

import torch

from .. import solvers as _sol
from ..core import health as _chealth
from ..core.factorization import factorize_banded, factorize_dense, packed_of
from ..core.pivoted import PivotedFactors
from ..device import device_name
from ..solvers.problem import dtype_name

__all__ = ["lu", "lu_solve", "linear_solve", "banded_lu", "banded_solve", "banded_linear_solve"]

_BATCHED = "batched operands arrive with the batched slice (ROADMAP queue A, item 9)"
_MESH = "mesh= arrives with the multi-device slice (ROADMAP queue A, item 12)"
_TIERS = "tolerance > 0 and rank= arrive with the accuracy tiers slice (ROADMAP queue A, item 10)"


def _require_slice(a, *, mesh=None, tolerance: float = 0.0, rank=None) -> None:
    if a.ndim != 2:
        raise NotImplementedError(_BATCHED)
    if mesh is not None:
        raise NotImplementedError(_MESH)
    if tolerance > 0 or rank is not None:
        raise NotImplementedError(_TIERS)


def _screen(health):
    """``None``/``False`` → no screening, ``True`` → default thresholds, a
    :class:`HealthThresholds` → itself."""
    if health is None or health is False:
        return None
    return _chealth.DEFAULT_THRESHOLDS if health is True else health


def _health_validator(thresholds, ref_max, bw: int = 0):
    """Dispatch validator screening each candidate's factors — an unhealthy
    result rejects the backend and feeds the escalation funnel."""

    def validate(problem, backend, result):
        rec = _chealth.factor_health(result, ref_max=ref_max, bw=bw)
        if not rec.verdict(thresholds):
            return f"unhealthy factor from {backend.name}: {rec.report(thresholds)}", rec
        return None

    return validate


def lu(a: torch.Tensor, *, impl: str | None = None, block: int = 256, tolerance: float = 0.0,
       rank: int | None = None, mesh=None, health=None, enrich: bool = False):
    """Packed EbV LU factorization (no pivoting — paper contract).

    Returns a :class:`~repro_torch.core.factorization.Factorization`
    wrapping the packed factor (or :class:`PivotedFactors` when the pivoted
    last resort ran); ``enrich=True`` also pre-inverts the diagonal solve
    blocks for the ``cuda_inverted`` solve.

    ``health=True`` (or a :class:`HealthThresholds`) screens the factors
    and returns ``(factors, FactorHealth)``: a backend whose factors fail
    the screen is demoted and the registry escalates down the capable
    candidates, ending at ``pivoted``, and raises
    :class:`~repro_torch.solvers.SolveFailure` when every candidate fails."""
    _require_slice(a, mesh=mesh, tolerance=tolerance, rank=rank)
    thresholds = _screen(health)
    ref_max = a.abs().max() if thresholds is not None else None
    validate = _health_validator(thresholds, ref_max) if thresholds is not None else None
    problem = _sol.Problem.from_arrays("factor", a, tolerance=tolerance)
    out = _sol.dispatch(problem, a, impl=impl, validate=validate, block=block)
    rec = None if thresholds is None else _chealth.factor_health(out, ref_max=ref_max)
    if not isinstance(out, PivotedFactors):
        out = factorize_dense(out, block=block, tier=tolerance, health=rec, enrich=enrich)
    return out if thresholds is None else (out, rec)


def lu_solve(lu_packed, b: torch.Tensor, *, impl: str | None = None, block: int = 256,
             rhs_tile: int = 256, tolerance: float = 0.0) -> torch.Tensor:
    """Forward + backward substitution on packed factors (a tensor, a
    ``Factorization`` or ``PivotedFactors``)."""
    if isinstance(lu_packed, PivotedFactors):
        # row-permuted factors: only the pivoted backend applies the
        # permutation, so the dispatch is forced
        _require_slice(lu_packed.lu, tolerance=tolerance)
        problem = _sol.Problem(
            op="solve", structure="dense", n=int(lu_packed.lu.shape[0]),
            dtype=dtype_name(lu_packed.lu.dtype),
            rhs=1 if b.ndim == 1 else int(b.shape[-1]), device=device_name(lu_packed.lu),
        )
        return _sol.dispatch(problem, lu_packed, b, impl="pivoted")
    _require_slice(lu_packed, tolerance=tolerance)
    problem = _sol.Problem.from_arrays("solve", lu_packed, b, tolerance=tolerance)
    return _sol.dispatch(problem, lu_packed, b, impl=impl, block=block, rhs_tile=rhs_tile)


def linear_solve(a: torch.Tensor, b: torch.Tensor, *, impl: str | None = None,
                 solve_impl: str | None = None, block: int = 256, rhs_tile: int = 256,
                 enrich: bool = False, tolerance: float = 0.0, rank: int | None = None,
                 mesh=None, verify_residual: bool = False) -> torch.Tensor:
    """Factor + solve.  ``impl`` routes both phases: the factor gets it
    verbatim, the solve runs ``"torch"`` when the factor does and is
    auto-selected otherwise; ``solve_impl`` sets the solve phase explicitly.

    ``verify_residual=True`` measures ``|Ax-b|/|b|`` against
    ``VERIFY_RESIDUAL_DEFAULT_BOUND``; a miss falls over to the
    partial-pivoting backend once before raising
    :class:`~repro_torch.solvers.SolveFailure`."""
    _require_slice(a, mesh=mesh, tolerance=tolerance, rank=rank)
    if solve_impl is None and impl == "torch":
        solve_impl = "torch"
    x = lu_solve(lu(a, impl=impl, block=block, enrich=enrich), b,
                 impl=solve_impl, block=block, rhs_tile=rhs_tile)
    if verify_residual:
        return _verify_composed(a, b, x)
    return x


def _verify_composed(a, b, x, *, bw: int = 0, tolerance: float = 0.0):
    """Post-hoc residual gate of the composed factor+solve path.  A dense
    miss escalates once to the partial-pivoting last resort before raising
    :class:`SolveFailure`; a band has no pivoted last resort and raises at
    once."""
    bound = tolerance if tolerance > 0 else _sol.VERIFY_RESIDUAL_DEFAULT_BOUND
    rel = float(_chealth.relative_residual(a, b, x, bw=bw))
    if rel <= bound:  # NaN compares False and falls through to escalation
        return x
    problem = _sol.Problem.from_arrays("linear_solve", a, b, bw=bw, tolerance=tolerance,
                                       verify_residual=True)
    reason = f"residual {rel:.3e} > bound {bound:.1e} from composed exact solve"
    chain = [{"backend": "composed", "reason": reason}]
    if bw:
        _sol.registry._notify_escalation(problem, "composed", None, reason)
    else:
        _sol.registry._notify_escalation(problem, "composed", "pivoted", reason)
        xp = lu_solve(lu(a, impl="pivoted"), b)
        relp = float(_chealth.relative_residual(a, b, xp))
        if relp <= bound:
            return xp
        chain.append({"backend": "pivoted", "reason": f"residual {relp:.3e} > bound {bound:.1e}"})
        _sol.registry._notify_escalation(problem, "pivoted", None, chain[-1]["reason"])
    raise _sol.SolveFailure(
        f"verified linear solve failed for {problem}: "
        + " -> ".join(f"{c['backend']} ({c['reason']})" for c in chain),
        problem=problem, chain=chain,
    )


# ---------------------------------------------------------------------------
# banded (row-aligned band, see repro_torch.core.banded)
# ---------------------------------------------------------------------------
def _require_band(arow, *, mesh=None) -> None:
    if packed_of(arow).ndim != 2:
        raise NotImplementedError(_BATCHED)
    if mesh is not None:
        raise NotImplementedError(_MESH)


def banded_lu(arow: torch.Tensor, *, bw: int, impl: str | None = None, block: int | None = None,
              tolerance: float = 0.0, health=None, enrich: bool = False, mesh=None):
    """Packed band LU on the row-aligned band ``(n, 2bw+1)`` (no pivoting).

    Returns a banded :class:`~repro_torch.core.factorization.Factorization`;
    ``enrich=True`` also pre-inverts the ``(C, C)`` diagonal blocks and
    pre-couples the off-band strips, for the ``cuda_inverted`` solve.
    ``tolerance`` only keys selection and the cache: no approximate banded
    tier exists.

    ``health=True`` (or a :class:`HealthThresholds`) screens the factors
    and returns ``(factors, FactorHealth)``: an unhealthy factor escalates
    through the remaining band backends (on the card only after a failed
    screen or an injected fault) and, the band having no pivoted last
    resort, ends in :class:`~repro_torch.solvers.SolveFailure`."""
    _require_band(arow, mesh=mesh)
    thresholds = _screen(health)
    ref_max = arow.abs().max() if thresholds is not None else None
    validate = _health_validator(thresholds, ref_max, bw=bw) if thresholds is not None else None
    problem = _sol.Problem.from_arrays("factor", arow, bw=bw, tolerance=tolerance)
    out = _sol.dispatch(problem, arow, impl=impl, validate=validate, bw=bw, block=block)
    rec = None if thresholds is None else _chealth.factor_health(out, ref_max=ref_max, bw=bw)
    out = factorize_banded(out, bw=bw, block=block, tier=tolerance, health=rec, enrich=enrich)
    return out if thresholds is None else (out, rec)


def banded_solve(lu_band, b: torch.Tensor, *, bw: int, impl: str | None = None,
                 block: int | None = None, rhs_tile: int = 256, tolerance: float = 0.0,
                 mesh=None) -> torch.Tensor:
    """Forward + backward substitution on packed band factors (a tensor or
    a banded ``Factorization``); ``b`` is ``(n,)`` or ``(n, m)``."""
    _require_band(lu_band, mesh=mesh)
    problem = _sol.Problem.from_arrays("solve", lu_band, b, bw=bw, tolerance=tolerance)
    return _sol.dispatch(problem, lu_band, b, impl=impl, bw=bw, block=block, rhs_tile=rhs_tile)


def banded_linear_solve(arow: torch.Tensor, b: torch.Tensor, *, bw: int, impl: str | None = None,
                        solve_impl: str | None = None, block: int | None = None,
                        rhs_tile: int = 256, tolerance: float = 0.0,
                        verify_residual: bool = False, mesh=None) -> torch.Tensor:
    """Band factor + solve.  ``impl`` routes the factor; the solve runs the
    same plain path when the factor runs ``"torch"`` / ``"torch_scalar"``
    and is auto-selected otherwise; ``solve_impl`` sets the solve phase
    explicitly.  ``verify_residual=True`` measures ``|Ax-b|/|b|`` on the
    band against ``VERIFY_RESIDUAL_DEFAULT_BOUND`` (or ``tolerance``) and
    raises :class:`~repro_torch.solvers.SolveFailure` on a miss."""
    _require_band(arow, mesh=mesh)
    if solve_impl is None and impl in ("torch", "torch_scalar"):
        solve_impl = impl
    f = banded_lu(arow, bw=bw, impl=impl, block=block, tolerance=tolerance)
    x = banded_solve(f, b, bw=bw, impl=solve_impl, block=block, rhs_tile=rhs_tile,
                     tolerance=tolerance)
    if verify_residual:
        return _verify_composed(arow, b, x, bw=bw, tolerance=tolerance)
    return x
