"""Public solver ops — a thin layer over ``repro_torch.solvers``.

Every call builds a :class:`~repro_torch.solvers.Problem` from its tensor
arguments and routes through the registry: capability filter → measured
autotune cache → static priorities.  ``impl=`` forces a backend.

``lu``: ``"cuda_fused"`` (the default for fp32), ``"torch"`` (its plain
version, the static winner for other dtypes), ``"cuda_vmem"`` (the
paper-faithful unblocked factor, n ≤ 4096), ``"cuda_blocked"`` (the legacy
multi-launch panel / fused-step driver), ``"pivoted"`` (the partial
pivoting last resort), ``"rand_lu"`` (the randomized rank-k tier, also
chosen by ``rank=``).

``lu_solve``: ``"cuda_vmem"`` (the default for n ≤ 2048), ``"cuda_tiled"``
(above), ``"cuda_inverted"`` / ``"torch_inverted"`` (enriched
``Factorization`` operands), ``"torch"``.

``banded_lu`` (row-aligned band ``(n, 2bw+1)``): ``"cuda_blocked"`` /
``"cuda_tiled"`` (the static split is
:func:`repro_torch.solvers.backends.banded_static_impl`), ``"torch"``,
``"cuda_scalar"`` (the legacy scalar-sequential factor), ``"torch_scalar"``.

``banded_solve``: ``"cuda"`` (the default for fp32), ``"cuda_inverted"`` /
``"torch_inverted"`` (enriched operands), ``"torch"``, ``"torch_scalar"``.

Batching: a leading batch axis on the matrix operand (``(B, n, n)``, a
stack of bands ``(B, n, 2bw+1)``) routes to the batched slots — the
batched CUDA kernels (:mod:`repro_torch.kernels.batched_lu`,
``batched_banded_*_vmem``), one launch per stack.  Further leading axes
fold into the one batch axis and unfold after.  A forced ``impl`` maps to
its batched counterpart: ``cuda_inverted`` keeps its name, a ``torch*``
name becomes ``torch`` and any other name ``cuda_vmem``.  The reference
also reroutes ``jax.vmap`` over these ops to the batched kernels
(``_with_batch_rule``, a ``custom_vmap``); PyTorch has no counterpart for
a ctypes kernel (``torch.vmap`` would need a batching rule per kernel), so
here the leading axis is the batched entry, and mapping an op over a
batch in Python runs one unbatched dispatch per system.

Accuracy tiers: ``tolerance`` (the largest acceptable relative residual)
keys selection and the autotune cache; ``linear_solve(tolerance > 0)``
first consults the ``linear_solve`` slot, whose approximate backends
(``bf16_ir``, ``bf16_ir_torch``, ``rand_lu``) the registry admits when the
tolerance covers their residual bound, and composes the exact factor and
solve when none is admitted.  ``rank=`` forces the randomized rank-k tier:
``lu`` then returns :class:`~repro_torch.core.randomized.RankKFactors`,
which ``lu_solve`` recognises.  Its Gaussian sketch comes from
``generator=`` (a ``torch.Generator``; seed 0 when None) or is given as
``sketch=``.

Ops run where their tensors lie: on the card the ``cuda_*`` backends
launch their kernels, on the CPU they run their plain versions.
``mesh=`` raises ``NotImplementedError`` naming the multi-device slice.
"""
from __future__ import annotations

import torch

from .. import solvers as _sol
from ..core import health as _chealth
from ..core.factorization import factorize_banded, factorize_dense, packed_of
from ..core.pivoted import PivotedFactors
from ..core.randomized import RankKFactors
from ..device import device_name
from ..solvers.problem import dtype_name

__all__ = ["lu", "lu_solve", "linear_solve", "banded_lu", "banded_solve", "banded_linear_solve"]

_MESH = "mesh= arrives with the multi-device slice (ROADMAP A7)"

# linear_solve slot backends that fuse factor and solve (the approximate
# tiers need the full operand)
_FUSED_LINEAR_IMPLS = ("bf16_ir", "bf16_ir_torch", "rand_lu")


def _require_local(mesh=None) -> None:
    if mesh is not None:
        raise NotImplementedError(_MESH)


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


def _batched_impl(op: str, structure: str, impl: str | None) -> str | None:
    """The batched slot a forced unbatched ``impl`` name maps to, after
    checking the name against the unbatched slot (an unknown or unported
    name raises there)."""
    if impl is None:
        return None
    _sol.get_backend(op, structure, impl)
    if impl == "cuda_inverted":  # has a batched slot of its own
        return impl
    return "torch" if impl.startswith("torch") else "cuda_vmem"


def _as_artifact(packed, *, structure: str, bw: int = 0, block=None, tier: float = 0.0,
                 health_rec=None, enrich: bool = False):
    """Wrap a packed factor into the ``Factorization`` artifact; pivoted
    and rank-k factors and deep-batched stacks (more than one leading axis)
    stay raw, as in the reference."""
    if isinstance(packed, (PivotedFactors, RankKFactors)) or packed.ndim > 3:
        return packed
    if structure == "dense":
        return factorize_dense(packed, block=block or 256, tier=tier, health=health_rec,
                               enrich=enrich)
    return factorize_banded(packed, bw=bw, block=block, tier=tier, health=health_rec,
                            enrich=enrich)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """A stack with any number of leading axes as ``(B, *tail)``."""
    return x.reshape(-1, *x.shape[-2:])


def _fold_rhs(lead, b: torch.Tensor) -> torch.Tensor:
    return b.reshape(-1, *b.shape[len(lead):])


def lu(a: torch.Tensor, *, impl: str | None = None, block: int = 256, col_tile: int = 256,
       tolerance: float = 0.0, rank: int | None = None, oversample: int = 8,
       generator: torch.Generator | None = None, sketch: torch.Tensor | None = None, mesh=None,
       health=None, enrich: bool = False):
    """Packed EbV LU factorization (no pivoting — paper contract).

    Returns a :class:`~repro_torch.core.factorization.Factorization`
    wrapping the packed factor (or :class:`PivotedFactors` when the pivoted
    last resort ran, :class:`RankKFactors` for ``rank=``); ``enrich=True``
    also pre-inverts the diagonal solve blocks for the ``cuda_inverted``
    solve.  ``block`` and ``col_tile`` shape the blocked factors (the
    legacy ``cuda_blocked`` driver takes both).  ``tolerance`` keys
    selection and becomes the artifact's tier.

    ``health=True`` (or a :class:`HealthThresholds`) screens the factors
    and returns ``(factors, FactorHealth)``: a backend whose factors fail
    the screen is demoted and the registry escalates down the capable
    candidates, ending at ``pivoted``, and raises
    :class:`~repro_torch.solvers.SolveFailure` when every candidate fails.

    A leading batch axis (``(B, n, n)``; more axes fold into one) runs the
    batched slots; the health record of a stack is its worst system's."""
    _require_local(mesh)
    thresholds = _screen(health)
    ref_max = a.abs().max() if thresholds is not None else None
    validate = _health_validator(thresholds, ref_max) if thresholds is not None else None
    if a.ndim >= 3:
        if rank is not None:
            raise ValueError("rank= (the randomized tier) supports 2-D operands only")
        a3 = _fold(a)
        problem = _sol.Problem.from_arrays("factor", a3, tolerance=tolerance)
        out = _sol.dispatch(problem, a3, impl=_batched_impl("factor", "dense", impl),
                            validate=validate, block=block).reshape(a.shape)
    else:
        if rank is not None and impl is None:
            impl = "rand_lu"  # an explicit rank is a request for the rank-k tier
        problem = _sol.Problem.from_arrays("factor", a, tolerance=tolerance)
        out = _sol.dispatch(problem, a, impl=impl, validate=validate, block=block,
                            col_tile=col_tile, rank=rank, oversample=oversample,
                            generator=generator, sketch=sketch)
    rec = None if thresholds is None else _chealth.factor_health(out, ref_max=ref_max)
    out = _as_artifact(out, structure="dense", block=block, tier=tolerance, health_rec=rec,
                       enrich=enrich)
    return out if thresholds is None else (out, rec)


def _lu_solve_batched(lu_packed, b, *, impl, block, tolerance):
    squeeze = b.ndim == 2  # (B, n): a vector per system
    bm = b[..., None] if squeeze else b
    problem = _sol.Problem.from_arrays("solve", lu_packed, bm, tolerance=tolerance)
    x = _sol.dispatch(problem, lu_packed, bm, impl=_batched_impl("solve", "dense", impl),
                      block=block)
    return x[..., 0] if squeeze else x


def lu_solve(lu_packed, b: torch.Tensor, *, impl: str | None = None, block: int = 256,
             rhs_tile: int = 256, tolerance: float = 0.0) -> torch.Tensor:
    """Forward + backward substitution on packed factors (a tensor, a
    ``Factorization`` or ``PivotedFactors``).  A stack of factors
    ``(..., n, n)`` takes ``b`` ``(..., n)`` or ``(..., n, m)`` and runs the
    batched slots.  Rank-k factors run the ``rand_lu`` solve."""
    if isinstance(lu_packed, (PivotedFactors, RankKFactors)):
        # row-permuted or rank-k factors: only the pivoted / rand_lu backend
        # consumes them, so the dispatch is forced
        rank_k = isinstance(lu_packed, RankKFactors)
        ref = lu_packed.l if rank_k else lu_packed.lu
        problem = _sol.Problem(
            op="solve", structure="dense", n=int(ref.shape[0]), dtype=dtype_name(ref.dtype),
            rhs=1 if b.ndim == 1 else int(b.shape[-1]), tolerance=float(tolerance),
            device=device_name(ref),
        )
        return _sol.dispatch(problem, lu_packed, b, impl="rand_lu" if rank_k else "pivoted")
    if lu_packed.ndim > 3:  # fold the extra leading axes, like lu()
        lead = lu_packed.shape[:-2]
        x = _lu_solve_batched(_fold(packed_of(lu_packed)), _fold_rhs(lead, b), impl=impl,
                              block=block, tolerance=tolerance)
        return x.reshape(*lead, *x.shape[1:])
    if lu_packed.ndim == 3:
        return _lu_solve_batched(lu_packed, b, impl=impl, block=block, tolerance=tolerance)
    problem = _sol.Problem.from_arrays("solve", lu_packed, b, tolerance=tolerance)
    return _sol.dispatch(problem, lu_packed, b, impl=impl, block=block, rhs_tile=rhs_tile)


def linear_solve(a: torch.Tensor, b: torch.Tensor, *, impl: str | None = None,
                 solve_impl: str | None = None, block: int = 256, col_tile: int = 256,
                 rhs_tile: int = 256, enrich: bool = False, tolerance: float = 0.0,
                 rank: int | None = None, oversample: int = 8,
                 generator: torch.Generator | None = None, sketch: torch.Tensor | None = None,
                 mesh=None, verify_residual: bool = False) -> torch.Tensor:
    """Factor + solve.  ``impl`` routes both phases: the factor gets it
    verbatim, the solve runs ``"torch"`` when the factor does and is
    auto-selected otherwise; ``solve_impl`` sets the solve phase explicitly.

    ``tolerance > 0`` first consults the ``linear_solve`` slot, where the
    tolerance gate admits the approximate tiers whose residual bound it
    covers (``bf16_ir`` — a bf16 factor refined in fp32 — from 1e-6 on; a
    stack runs the batched ``bf16_ir``); with none admitted the exact
    factor and solve are composed as before.  ``rank=`` (or
    ``impl="rand_lu"``) forces the randomized rank-k tier.

    ``verify_residual=True`` measures ``|Ax-b|/|b|`` against ``tolerance``
    when set, else ``VERIFY_RESIDUAL_DEFAULT_BOUND``: a tier's miss feeds
    the escalation funnel, and the composed path falls over to the
    partial-pivoting backend once before raising
    :class:`~repro_torch.solvers.SolveFailure` (a stack, which has no
    batched pivoted backend, raises at once)."""
    _require_local(mesh)
    if rank is not None and impl is None:
        impl = "rand_lu"
    if impl in _FUSED_LINEAR_IMPLS or (impl is None and tolerance > 0):
        bm = b[..., None] if b.ndim == a.ndim - 1 else b
        problem = _sol.Problem.from_arrays("linear_solve", a, bm, tolerance=tolerance,
                                           verify_residual=verify_residual)
        if impl is not None or _sol.candidates(problem):
            x = _sol.dispatch(problem, a, bm, impl=impl, block=block, rank=rank,
                              oversample=oversample, generator=generator, sketch=sketch)
            return x[..., 0] if bm is not b else x
        # tolerance tighter than every tier's guarantee: compose the exact
        # factor and solve (the tolerance still keys their selection)
    if solve_impl is None and impl == "torch":
        solve_impl = "torch"
    x = lu_solve(lu(a, impl=impl, block=block, col_tile=col_tile, enrich=enrich,
                    tolerance=tolerance), b,
                 impl=solve_impl, block=block, rhs_tile=rhs_tile, tolerance=tolerance)
    if verify_residual:
        return _verify_composed(a, b, x, tolerance=tolerance)
    return x


def _verify_composed(a, b, x, *, bw: int = 0, tolerance: float = 0.0):
    """Post-hoc residual gate of the composed factor+solve path (a stack is
    held to its worst system's residual).  A dense miss escalates once to
    the partial-pivoting last resort before raising :class:`SolveFailure`;
    a band or a stack has no pivoted last resort and raises at once."""
    bound = tolerance if tolerance > 0 else _sol.VERIFY_RESIDUAL_DEFAULT_BOUND
    rel = float(_chealth.relative_residual(a, b, x, bw=bw))
    if rel <= bound:  # NaN compares False and falls through to escalation
        return x
    a3, b3 = (_fold(a), _fold_rhs(a.shape[:-2], b)) if a.ndim > 3 else (a, b)
    problem = _sol.Problem.from_arrays("linear_solve", a3, b3, bw=bw, tolerance=tolerance,
                                       verify_residual=True)
    reason = f"residual {rel:.3e} > bound {bound:.1e} from composed exact solve"
    chain = [{"backend": "composed", "reason": reason}]
    if bw or a.ndim > 2:
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
    resort, ends in :class:`~repro_torch.solvers.SolveFailure`.

    A stack of bands ``(B, n, 2bw+1)`` (more leading axes fold into one)
    runs the batched slots."""
    _require_local(mesh)
    thresholds = _screen(health)
    ref_max = arow.abs().max() if thresholds is not None else None
    validate = _health_validator(thresholds, ref_max, bw=bw) if thresholds is not None else None
    if arow.ndim >= 3:
        a3 = _fold(arow)
        problem = _sol.Problem.from_arrays("factor", a3, bw=bw, tolerance=tolerance)
        out = _sol.dispatch(problem, a3, impl=_batched_impl("factor", "banded", impl),
                            validate=validate, bw=bw, block=block).reshape(arow.shape)
    else:
        problem = _sol.Problem.from_arrays("factor", arow, bw=bw, tolerance=tolerance)
        out = _sol.dispatch(problem, arow, impl=impl, validate=validate, bw=bw, block=block)
    rec = None if thresholds is None else _chealth.factor_health(out, ref_max=ref_max, bw=bw)
    out = _as_artifact(out, structure="banded", bw=bw, block=block, tier=tolerance,
                       health_rec=rec, enrich=enrich)
    return out if thresholds is None else (out, rec)


def banded_solve(lu_band, b: torch.Tensor, *, bw: int, impl: str | None = None,
                 block: int | None = None, rhs_tile: int = 256, tolerance: float = 0.0,
                 mesh=None) -> torch.Tensor:
    """Forward + backward substitution on packed band factors (a tensor or
    a banded ``Factorization``); ``b`` is ``(n,)`` or ``(n, m)``, or for a
    stack of factors ``(..., n, 2bw+1)`` ``(..., n)`` or ``(..., n, m)``."""
    _require_local(mesh)
    if lu_band.ndim > 3:  # fold the extra leading axes, like banded_lu()
        lead = lu_band.shape[:-2]
        x = banded_solve(_fold(packed_of(lu_band)), _fold_rhs(lead, b), bw=bw, impl=impl,
                         block=block, tolerance=tolerance)
        return x.reshape(*lead, *x.shape[1:])
    if lu_band.ndim == 3:
        impl = _batched_impl("solve", "banded", impl)
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
    _require_local(mesh)
    if solve_impl is None and impl in ("torch", "torch_scalar"):
        solve_impl = impl
    f = banded_lu(arow, bw=bw, impl=impl, block=block, tolerance=tolerance)
    x = banded_solve(f, b, bw=bw, impl=solve_impl, block=block, rhs_tile=rhs_tile,
                     tolerance=tolerance)
    if verify_residual:
        return _verify_composed(arow, b, x, bw=bw, tolerance=tolerance)
    return x
