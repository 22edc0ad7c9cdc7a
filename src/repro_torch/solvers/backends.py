"""Backend registrations: the dense and banded slots.

The reference's ``pallas_*`` backends are the ``cuda_*`` backends here and
its pure-jnp ``xla*`` mirrors are ``torch*``; ``pivoted`` keeps its name.
The static priorities are the reference's, so selection picks the
counterpart of the reference's slot for the same :class:`Problem`.  They
do not depend on the device: on the CPU the ``cuda_*`` wrappers run their
plain versions, which keeps the CPU tests on the dispatch the card takes.
"""
from __future__ import annotations

import torch

from ..core import banded as _banded
from ..core import blocked as _blocked
from ..core import factorization as _fz
from ..core import pivoted as _pivoted
from ..core import solve as _solve
from ..core.factorization import packed_of as _packed
from ..kernels import banded as _kbanded
from ..kernels import ebv_lu as _k
from ..kernels import trsm as _trsm
from .problem import Problem
from .registry import NOT_PORTED, Backend, register

__all__ = ["SOLVE_VMEM_MAX_N", "BANDED_TILED_MIN_BW", "banded_static_impl"]

# Static split between the two default solves, kept at the reference's
# value so selection matches it.  On the card the packed LU at n = 2048 is
# 16 MB, which stays in the 50 MB L2 that solve_vmem reads it from.
SOLVE_VMEM_MAX_N = 2048


# Narrowest band the static rule sends to cuda_tiled.  The reference splits
# at 6 MiB of skewed band, sized for TPU VMEM.  On the H100 both factors walk
# the same pivot chain and differ in how they stage the band: cuda_blocked
# in one launch through a ring of rows, cuda_tiled in one launch per block
# step.  chip_smoke.py's crossover (PERF.md; n = 4000, 16384, 65536
# each): cuda_blocked is 10-13 % faster at bw = 5 and 1-5 % at bw = 8;
# cuda_tiled is 2-4 % faster at bw = 12 and 16 for n >= 16384, while at
# n = 4000 the two trade places by up to 3 % from run to run; at bw = 256
# neither stages the band in shared memory and they time alike, and the
# reference's choice for such bands, pallas_tiled, stands.
BANDED_TILED_MIN_BW = 12


def banded_static_impl(bw: int) -> str:
    """The band factor static selection picks: ``cuda_blocked`` below
    :data:`BANDED_TILED_MIN_BW`, ``cuda_tiled`` from it on (the order n
    did not move the measured crossover)."""
    return "cuda_tiled" if bw >= BANDED_TILED_MIN_BW else "cuda_blocked"


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

def _banded_inverted_call(lub, b, *, bw, block):
    art = _fz.banded_artifact(lub, bw=bw, block=block)
    return _kbanded.banded_solve_inverted(art.linv, art.uinv, art.tlo, art.tup, b,
                                          n=art.n, bw=art.bw)


def _banded_inverted_plain_call(lub, b, *, bw, block):
    art = _fz.banded_artifact(lub, bw=bw, block=block)
    return _fz.banded_inverted_solve(art.linv, art.uinv, art.tlo, art.tup, b, n=art.n, bw=art.bw)


def _banded_scalar_solve(lub, b, *, bw):
    # the scalar sweep takes one vector: a stack runs column by column
    if b.ndim == 2:
        return torch.stack([_banded.banded_solve(_packed(lub), b[:, j], bw=bw)
                            for j in range(b.shape[1])], dim=1)
    return _banded.banded_solve(_packed(lub), b, bw=bw)


# ---------------------------------------------------------------------------
# banded factor
# ---------------------------------------------------------------------------
register(Backend(
    name="cuda_blocked", op="factor", structure="banded",
    call=lambda p, arow, *, bw, block=None, **_: _kbanded.banded_lu_blocked(arow, bw=bw, block=block),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 3.0 if banded_static_impl(p.bw) == "cuda_blocked" else 0.0,
))
register(Backend(
    name="cuda_tiled", op="factor", structure="banded",
    call=lambda p, arow, *, bw, block=None, **_: _kbanded.banded_lu_tiled(arow, bw=bw, block=block),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 1.0,
))
register(Backend(
    name="torch", op="factor", structure="banded",
    call=lambda p, arow, *, bw, block=None, **_: _banded.banded_lu_blocked(arow, bw=bw, block=block),
    supports=_local,
    priority=lambda p: 0.5,
))
register(Backend(
    name="torch_scalar", op="factor", structure="banded",
    call=lambda p, arow, *, bw, **_: _banded.banded_lu(arow, bw=bw),
    supports=_local,
    priority=lambda p: 0.1,
    autotune=False,  # the scalar loop: forced-impl only
))

# ---------------------------------------------------------------------------
# banded solve
# ---------------------------------------------------------------------------
register(Backend(
    name="cuda", op="solve", structure="banded",
    call=lambda p, lub, b, *, bw, block=None, rhs_tile=256, **_:
        _kbanded.banded_solve_kernelized(_packed(lub), b, bw=bw, block=block, rhs_tile=rhs_tile),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 2.0,
))
register(Backend(
    name="cuda_inverted", op="solve", structure="banded",
    # two-phase substitution against the factor-time inverses and transfer
    # blocks; statically below the blocked solve, reached measured or forced
    call=lambda p, lub, b, *, bw, block=None, **_: _banded_inverted_call(lub, b, bw=bw, block=block),
    supports=lambda p: _is_f32(p) and _local(p) and p.enriched,
    priority=lambda p: 1.5,
))
register(Backend(
    name="torch_inverted", op="solve", structure="banded",
    call=lambda p, lub, b, *, bw, block=None, **_:
        _banded_inverted_plain_call(lub, b, bw=bw, block=block),
    supports=lambda p: _local(p) and p.enriched,
    priority=lambda p: 0.1,
    autotune=False,
))
register(Backend(
    name="torch", op="solve", structure="banded",
    call=lambda p, lub, b, *, bw, block=None, **_:
        _banded.banded_solve_blocked(_packed(lub), b, bw=bw, block=block),
    supports=_local,
    priority=lambda p: 1.0,
))
register(Backend(
    name="torch_scalar", op="solve", structure="banded",
    call=lambda p, lub, b, *, bw, **_: _banded_scalar_solve(lub, b, bw=bw),
    # the sweep is vector-only: never steered a stacked RHS
    supports=lambda p: _local(p) and p.rhs <= 1,
    priority=lambda p: 0.5,
))

# ---------------------------------------------------------------------------
# backends of the reference that later slices bring
# ---------------------------------------------------------------------------
_QUEUE_B = "its kernel is still to port (ROADMAP queue B)"
_TIERS = "the accuracy tiers slice (ROADMAP queue A, item 10)"
_MULTI = "the multi-device slice (ROADMAP queue A, item 12)"
_BATCHED = "the batched slice (ROADMAP queue A, item 9)"
NOT_PORTED.update({
    ("factor", "banded", "cuda_scalar"): f"banded.py:banded_lu_kernelized (B18): {_QUEUE_B}",
    ("factor", "batched_banded", "cuda_vmem"): _BATCHED,
    ("factor", "batched_banded", "torch"): _BATCHED,
    ("solve", "batched_banded", "cuda_vmem"): _BATCHED,
    ("solve", "batched_banded", "cuda_inverted"): _BATCHED,
    ("solve", "batched_banded", "torch"): _BATCHED,
    ("factor", "banded", "spike"): _MULTI,
    ("factor", "banded", "replicated"): _MULTI,
    ("solve", "banded", "spike"): _MULTI,
    ("linear_solve", "banded", "spike"): _MULTI,
    ("linear_solve", "banded", "replicated"): _MULTI,
    ("factor", "dense", "cuda_vmem"): f"ebv_lu.py:lu_vmem (B17): {_QUEUE_B}",
    ("factor", "dense", "cuda_blocked"): f"the multi-launch driver (B14-B16): {_QUEUE_B}",
    ("factor", "dense", "distributed"): _MULTI,
    ("factor", "dense", "rand_lu"): _TIERS,
    ("linear_solve", "dense", "bf16_ir"): _TIERS,
    ("linear_solve", "dense", "bf16_ir_torch"): _TIERS,
    ("linear_solve", "dense", "rand_lu"): _TIERS,
    ("linear_solve", "dense", "distributed"): _MULTI,
})
