"""Backend registrations of the dense slice.

The reference's ``pallas_*`` backends are the ``cuda_*`` backends here and
its pure-jnp ``xla*`` mirrors are ``torch*``; ``pivoted`` keeps its name.
The static priorities are the reference's, so selection picks the
counterpart of the reference's slot for the same :class:`Problem`.  They
do not depend on the device: on the CPU the ``cuda_*`` wrappers run their
plain versions, which keeps the CPU tests on the dispatch the card takes.
"""
from __future__ import annotations

from ..core import blocked as _blocked
from ..core import factorization as _fz
from ..core import pivoted as _pivoted
from ..core import solve as _solve
from ..core.factorization import packed_of as _packed
from ..kernels import ebv_lu as _k
from ..kernels import trsm as _trsm
from .problem import Problem
from .registry import NOT_PORTED, Backend, register

__all__ = ["SOLVE_VMEM_MAX_N"]

# Static split between the two default solves, kept at the reference's
# value so selection matches it.  On the card the packed LU at n = 2048 is
# 16 MB, which stays in the 50 MB L2 that solve_vmem reads it from.
SOLVE_VMEM_MAX_N = 2048


def _is_f32(p: Problem) -> bool:
    return p.dtype == "float32"


def _local(p: Problem) -> bool:
    return p.devices == 1


def _inverted_call(lu, b, *, block, rhs_tile):
    art = _fz.dense_artifact(lu, block=block or 256)
    return _trsm.solve_inverted(art.packed, art.linv, art.uinv, b, rhs_tile=rhs_tile)


def _inverted_plain_call(lu, b, *, block):
    art = _fz.dense_artifact(lu, block=block or 256)
    return _fz.dense_inverted_solve(art.packed, art.linv, art.uinv, b)


# ---------------------------------------------------------------------------
# dense factor
# ---------------------------------------------------------------------------
register(Backend(
    name="cuda_fused", op="factor", structure="dense",
    call=lambda p, a, *, block=256, **_: _k.lu_fused(a, block=block),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 3.0,
))
register(Backend(
    name="torch", op="factor", structure="dense",
    call=lambda p, a, *, block=256, **_: _blocked.fused_blocked_lu(a, block=block),
    supports=_local,
    priority=lambda p: 2.0,  # static winner for non-fp32 (cuda_fused is fp32-only)
))
register(Backend(
    name="pivoted", op="factor", structure="dense",
    # last resort for operands outside the no-pivot class: the escalation
    # funnel reaches it after the no-pivot backends fail their health
    # screen; lowest priority so it never wins a default selection
    call=lambda p, a, **_: _pivoted.pivoted_lu(a),
    supports=_local,
    priority=lambda p: 0.05,
    autotune=False,  # different factor layout (PivotedFactors, not packed)
))

# ---------------------------------------------------------------------------
# dense solve
# ---------------------------------------------------------------------------
register(Backend(
    name="cuda_vmem", op="solve", structure="dense",
    call=lambda p, lu, b, *, rhs_tile=256, **_: _trsm.solve_vmem(_packed(lu), b, rhs_tile=rhs_tile),
    supports=_local,
    priority=lambda p: 3.0 if p.n <= SOLVE_VMEM_MAX_N else 0.0,
))
register(Backend(
    name="cuda_tiled", op="solve", structure="dense",
    call=lambda p, lu, b, *, block=256, **_: _trsm.solve_tiled(_packed(lu), b, block=block),
    supports=_local,
    priority=lambda p: 1.0,
))
register(Backend(
    name="cuda_inverted", op="solve", structure="dense",
    # substitution against the factor-time pre-inverted diagonal blocks; the
    # `enriched` capability keeps auto-selection from steering a raw operand
    # into an enrich-on-the-fly dispatch
    call=lambda p, lu, b, *, block=None, rhs_tile=512, **_:
        _inverted_call(lu, b, block=block, rhs_tile=rhs_tile),
    supports=lambda p: _local(p) and p.enriched,
    priority=lambda p: 0.75,  # below the defaults: reach it measured or forced
    autotune=False,  # not value-identical to the strip-recurrence solves
))
register(Backend(
    name="torch_inverted", op="solve", structure="dense",
    call=lambda p, lu, b, *, block=None, **_: _inverted_plain_call(lu, b, block=block),
    supports=lambda p: _local(p) and p.enriched,
    priority=lambda p: 0.1,
    autotune=False,
))
register(Backend(
    name="torch", op="solve", structure="dense",
    call=lambda p, lu, b, **_: _solve.lu_solve(_packed(lu), b),
    supports=_local,
    priority=lambda p: 0.5,
))
register(Backend(
    name="pivoted", op="solve", structure="dense",
    # consumes PivotedFactors; never auto-selected — ops.lu_solve forces it
    # when handed pivoted factors
    call=lambda p, factors, b, **_: _pivoted.pivoted_solve(factors, b),
    supports=lambda p: False,
    priority=lambda p: 0.0,
    autotune=False,
))

# ---------------------------------------------------------------------------
# backends of the reference that later slices bring
# ---------------------------------------------------------------------------
_QUEUE_B = "its kernel is still to port (ROADMAP queue B)"
_TIERS = "the accuracy tiers slice (ROADMAP queue A, item 10)"
_MULTI = "the multi-device slice (ROADMAP queue A, item 12)"
NOT_PORTED.update({
    ("factor", "dense", "cuda_vmem"): f"ebv_lu.py:lu_vmem (B17): {_QUEUE_B}",
    ("factor", "dense", "cuda_blocked"): f"the multi-launch driver (B14-B16): {_QUEUE_B}",
    ("factor", "dense", "distributed"): _MULTI,
    ("factor", "dense", "rand_lu"): _TIERS,
    ("linear_solve", "dense", "bf16_ir"): _TIERS,
    ("linear_solve", "dense", "bf16_ir_torch"): _TIERS,
    ("linear_solve", "dense", "rand_lu"): _TIERS,
    ("linear_solve", "dense", "distributed"): _MULTI,
})
