"""Backend registrations: the dense, banded and batched slots.

The reference's ``pallas_*`` backends are the ``cuda_*`` backends here and
its pure-jnp ``xla*`` mirrors are ``torch*``; ``pivoted`` keeps its name.
The static priorities are the reference's, so selection picks the
counterpart of the reference's slot for the same :class:`Problem`.  They
do not depend on the device: on the CPU the ``cuda_*`` wrappers run their
plain versions, which keeps the CPU tests on the dispatch the card takes.

The batched slots keep the reference's priorities but not its capability
caps, which were sized for TPU VMEM (``BATCHED_VMEM_MAX_N = 1024``, an
RHS of at most ``4n`` columns, the 6 MiB skewed-band budget): on the card
each kernel's own design sets them (see the notes above the batched
registrations).

The approximate tiers (``bf16_ir``, ``bf16_ir_torch``, ``rand_lu``) declare
a ``residual_bound``, so the registry admits them only to a problem whose
``tolerance`` covers it.
"""
from __future__ import annotations

import torch

from ..core import banded as _banded
from ..core import batched as _batched
from ..core import blocked as _blocked
from ..core import factorization as _fz
from ..core import pivoted as _pivoted
from ..core import randomized as _rand
from ..core import refine as _refine
from ..core import solve as _solve
from ..core.factorization import packed_of as _packed
from ..kernels import banded as _kbanded
from ..kernels import batched_lu as _kbatched
from ..kernels import ebv_lu as _k
from ..kernels import trsm as _trsm
from .problem import Problem
from .registry import NOT_PORTED, Backend, register

__all__ = ["SOLVE_VMEM_MAX_N", "BANDED_TILED_MIN_BW", "LU_VMEM_MAX_N", "BF16_IR_RESIDUAL_FLOOR",
           "RAND_LU_RESIDUAL_BOUND", "IR_MAX_ITERS", "banded_static_impl", "blocked_launches"]

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
# reference's choice for such bands, pallas_tiled, stands.  Since
# cuda_blocked walks bands up to bw = 31 on one warp (csrc/band_walk.cu),
# launch/time_kernels.py's narrow sweep records it faster than the slab
# steps at bw = 16 and 31 too (PERF.md); the split has not moved yet.
BANDED_TILED_MIN_BW = 12


# Largest order the unblocked cuda_vmem factor takes: the reference's VMEM
# cap, kept although the port's kernel walks device memory and has no such
# budget, so that the escalation funnel offers the same backends in the
# same order as the reference's at every n, and because the unblocked walk
# moves the whole trailing block once per pivot (~8n^3/3 bytes).
LU_VMEM_MAX_N = 4096

# The accuracy tiers' residual guarantees (the reference's values): the
# bf16-factor + fp32-refinement tier reaches 1e-6 on diagonally dominant
# fp32 operands in a few sweeps; the randomized rank-k tier guarantees 1e-3
# for operands of numerical rank <= k with range-consistent RHS.
BF16_IR_RESIDUAL_FLOOR = 1e-6
RAND_LU_RESIDUAL_BOUND = 1e-3
# refinement-sweep cap; the count taken surfaces in core.refine.last_refinement()
IR_MAX_ITERS = _refine.DEFAULT_MAX_ITERS


def banded_static_impl(bw: int) -> str:
    """The band factor static selection picks: ``cuda_blocked`` below
    :data:`BANDED_TILED_MIN_BW`, ``cuda_tiled`` from it on (the order n
    did not move the measured crossover)."""
    return "cuda_tiled" if bw >= BANDED_TILED_MIN_BW else "cuda_blocked"


def _is_f32(p: Problem) -> bool:
    return p.dtype == "float32"


def _f32_or_bf16(p: Problem) -> bool:
    return p.dtype in ("float32", "bfloat16")


def _local(p: Problem) -> bool:
    return p.devices == 1


def _inverted_call(lu, b, *, block, rhs_tile):
    art = _fz.dense_artifact(lu, block=block or 256)
    return _trsm.solve_inverted(art.packed, art.linv, art.uinv, b, rhs_tile=rhs_tile)


def _inverted_plain_call(lu, b, *, block):
    art = _fz.dense_artifact(lu, block=block or 256)
    return _fz.dense_inverted_solve(art.packed, art.linv, art.uinv, b)


def blocked_launches(n: int, block: int = 256) -> int:
    """Kernel launches of :func:`_cuda_blocked_lu` for an (n, n) matrix: a
    panel per block column and, for each block column but the last, a
    fused step of two launches (the U12 solve and the trailing product)."""
    s = -(-n // min(block, n))
    return s + 2 * (s - 1)


def _cuda_blocked_lu(a: torch.Tensor, *, block: int, col_tile: int) -> torch.Tensor:
    """The reference's legacy multi-launch blocked driver: one panel kernel
    and one fused bi-vector step per block column (2S-1 calls for S block
    columns, :func:`blocked_launches` device launches) on a copy of ``a``."""
    n = a.shape[-1]
    block = min(block, n)
    a = a.clone()
    for k0 in range(0, n, block):
        b = min(block, n - k0)
        pan = _k.panel(a[k0:, k0:k0 + b])
        a[k0:, k0:k0 + b] = pan
        w = n - k0 - b
        if w > 0:
            ct = min(col_tile, w)
            if w % ct:
                # pad the trailing width to the next tile multiple (tiles
                # capped at 128 columns); zero columns are inert through the
                # solve and the rank-b update
                ct = min(col_tile, 128)
                pad = -(-w // ct) * ct - w
                top = torch.nn.functional.pad(a[k0:k0 + b, k0 + b:], (0, pad))
                trail = torch.nn.functional.pad(a[k0 + b:, k0 + b:], (0, pad))
                u12, new_trail = _k.fused_step(pan, top, trail, col_tile=ct)
                u12, new_trail = u12[:, :w], new_trail[:, :w]
            else:
                u12, new_trail = _k.fused_step(pan, a[k0:k0 + b, k0 + b:], a[k0 + b:, k0 + b:],
                                               col_tile=ct)
            a[k0:k0 + b, k0 + b:] = u12
            a[k0 + b:, k0 + b:] = new_trail
    return a


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
    name="cuda_vmem", op="factor", structure="dense",
    call=lambda p, a, **_: _k.lu_vmem(a),
    supports=lambda p: _is_f32(p) and _local(p) and p.n <= LU_VMEM_MAX_N,
    priority=lambda p: 1.0,
    autotune=False,  # not value-identical to the fused / torch factors
))
register(Backend(
    name="cuda_blocked", op="factor", structure="dense",
    call=lambda p, a, *, block=256, col_tile=256, **_:
        _cuda_blocked_lu(a, block=block, col_tile=col_tile),
    # the reference's driver takes any dtype; the port's kernels take fp32
    # and bf16
    supports=lambda p: _f32_or_bf16(p) and _local(p),
    priority=lambda p: 0.0,
    autotune=False,  # dominated multi-launch legacy driver (forced or escalated to)
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
    name="cuda_scalar", op="factor", structure="banded",
    call=lambda p, arow, *, bw, **_: _kbanded.banded_lu_kernelized(arow, bw=bw),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 0.2,
    autotune=False,  # the legacy scalar-sequential kernel: forced-impl only
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
# batched (the optimizer's many small systems, a CFD ensemble's bands)
#
# The reference caps its VMEM grid kernels at n <= 1024, an RHS of at most
# 4n columns and 6 MiB of skewed band per system.  On the card:
# * the batched factor (B9) walks a system in shared memory up to n = 240
#   and in device memory above, and the band factor (B11) streams any band
#   through its ring or walks device memory: neither has a size cap;
# * the batched solve (B10) holds one (n, <=32)-column RHS tile in shared
#   memory and walks the RHS tile by tile, so the RHS width has no cap and
#   n has the one of a single column's tile (n <= 58080); the band solve
#   (B12) keeps no operand whole on chip and has no cap.  Neither solve caps
#   the batch: each folds the system into its grid's x axis.
# Where the reference overflows to its vmapped mirror (n > 1024, rhs > 4n,
# a skewed band over 6 MiB) the port stays on its kernels.
# ---------------------------------------------------------------------------
def _batched_torch_lu(a, *, block):
    # the reference's vmapped fused_blocked_lu: one plain factor per system
    return torch.stack([_blocked.fused_blocked_lu(m, block=block) for m in a])


def _batched_inverted_call(lu, b, *, block):
    # the reference's vmapped inverted-diagonal sweeps, system by system
    art = _fz.dense_artifact(lu, block=block or 256)
    return torch.stack([_fz.dense_inverted_solve(p, li, ui, r)
                        for p, li, ui, r in zip(art.packed, art.linv, art.uinv, b)])


def _batched_banded_inverted_call(lub, b, *, bw, block):
    art = _fz.banded_artifact(lub, bw=bw, block=block)
    return torch.stack([_fz.banded_inverted_solve(li, ui, lo, up, r, n=art.n, bw=art.bw)
                        for li, ui, lo, up, r in zip(art.linv, art.uinv, art.tlo, art.tup, b)])


register(Backend(
    name="cuda_vmem", op="factor", structure="batched_dense",
    call=lambda p, a, **_: _kbatched.batched_lu_vmem(a),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 2.0,
))
register(Backend(
    name="torch", op="factor", structure="batched_dense",
    call=lambda p, a, *, block=256, **_: _batched_torch_lu(a, block=block),
    supports=_local,
    priority=lambda p: 1.0,
))
register(Backend(
    name="cuda_vmem", op="solve", structure="batched_dense",
    call=lambda p, lu, b, **_: _kbatched.batched_lu_solve_vmem(_packed(lu), b),
    supports=lambda p: _is_f32(p) and _local(p) and _kbatched.batched_solve_fits(p.n),
    priority=lambda p: 2.0,
))
register(Backend(
    name="torch", op="solve", structure="batched_dense",
    call=lambda p, lu, b, **_: _batched.batched_lu_solve(_packed(lu), b),
    supports=_local,
    priority=lambda p: 1.0,
))
register(Backend(
    name="cuda_inverted", op="solve", structure="batched_dense",
    # the batched inverted-diagonal sweeps, reached by name (ops maps
    # cuda_inverted to it) or measured; as in the reference, the batch runs
    # the plain products system by system
    call=lambda p, lu, b, *, block=None, **_: _batched_inverted_call(lu, b, block=block),
    supports=lambda p: _local(p) and p.enriched,
    priority=lambda p: 0.75,
    autotune=False,
))
register(Backend(
    name="cuda_vmem", op="factor", structure="batched_banded",
    call=lambda p, arow, *, bw, block=None, **_:
        _kbanded.batched_banded_lu_vmem(arow, bw=bw, block=block),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 2.0,
))
register(Backend(
    name="torch", op="factor", structure="batched_banded",
    call=lambda p, arow, *, bw, block=None, **_: _banded.banded_lu_blocked(arow, bw=bw, block=block),
    supports=_local,
    priority=lambda p: 1.0,
))
register(Backend(
    name="cuda_vmem", op="solve", structure="batched_banded",
    call=lambda p, lub, b, *, bw, block=None, rhs_tile=256, **_:
        _kbanded.batched_banded_solve_vmem(_packed(lub), b, bw=bw, block=block, rhs_tile=rhs_tile),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 2.0,
))
register(Backend(
    name="torch", op="solve", structure="batched_banded",
    call=lambda p, lub, b, *, bw, block=None, **_:
        _banded.banded_solve_blocked(_packed(lub), b, bw=bw, block=block),
    supports=_local,
    priority=lambda p: 1.0,
))
register(Backend(
    name="cuda_inverted", op="solve", structure="batched_banded",
    # the batched two-phase inverted band solve (the plain sweeps system by
    # system, as the reference's vmapped mirror)
    call=lambda p, lub, b, *, bw, block=None, **_:
        _batched_banded_inverted_call(lub, b, bw=bw, block=block),
    supports=lambda p: _local(p) and p.enriched,
    priority=lambda p: 1.5,
    autotune=False,
))

# ---------------------------------------------------------------------------
# approximate tiers: admitted by the tolerance gate only (residual_bound
# set), so default-tolerance problems never see them.  A tolerance-carrying
# ops.linear_solve consults the linear_solve slot first: the tiers need the
# full operand (bf16_ir refines against it, rand_lu sketches it).
# ---------------------------------------------------------------------------
def _ir_tolerance(p: Problem) -> float:
    # refine to the caller's tolerance, never past the tier's floor
    return max(p.tolerance, BF16_IR_RESIDUAL_FLOOR)


def _bf16_ir_solve(a, b, *, block, tolerance, use_kernel):
    """Factor the bf16-rounded operand in fp32, refine the solution in fp32
    against the full operand.  The correction runs through the factor's
    inverted diagonal blocks: B4 (``trsm.solve_inverted``) on the card, its
    plain version (``dense_inverted_solve``) for ``bf16_ir_torch`` and on
    the CPU."""
    a16 = a.to(torch.bfloat16).to(torch.float32)
    lu16 = (_k.lu_fused(a16, block=block) if use_kernel
            else _blocked.fused_blocked_lu(a16, block=block))
    linv, uinv = _fz.dense_block_inverses(lu16, block=block)
    if use_kernel:
        correct = lambda r: _trsm.solve_inverted(lu16, linv, uinv, r)
    else:
        correct = lambda r: _fz.dense_inverted_solve(lu16, linv, uinv, r)
    x, _info = _refine.iterative_refinement(a, b, correct(b.to(torch.float32)), correct,
                                            tolerance=tolerance, max_iters=IR_MAX_ITERS)
    return x.to(a.dtype)


def _bf16_ir_solve_batched(a, b, *, tolerance):
    """The stacked tier (the optimizer's grouped systems): the bf16-rounded
    stack factored by B9 and every correction by B10 (their plain versions
    on the CPU).  The reference runs its vmapped plain factor and solve
    here; the port keeps the stack on its batched kernels."""
    lu16 = _kbatched.batched_lu_vmem(a.to(torch.bfloat16).to(torch.float32))
    correct = lambda r: _kbatched.batched_lu_solve_vmem(lu16, r)
    x, _info = _refine.iterative_refinement(a, b, correct(b.to(torch.float32)), correct,
                                            tolerance=tolerance, max_iters=IR_MAX_ITERS)
    return x.to(a.dtype)


register(Backend(
    name="bf16_ir", op="linear_solve", structure="dense",
    call=lambda p, a, b, *, block=256, **_: _bf16_ir_solve(
        a, b, block=block, tolerance=_ir_tolerance(p), use_kernel=True),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 5.0,  # the preferred approximate tier once admitted
    autotune=False,  # not value-identical to the exact tier
    residual_bound=lambda p: BF16_IR_RESIDUAL_FLOOR,
))
register(Backend(
    name="bf16_ir_torch", op="linear_solve", structure="dense",
    call=lambda p, a, b, *, block=256, **_: _bf16_ir_solve(
        a, b, block=block, tolerance=_ir_tolerance(p), use_kernel=False),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 4.0,
    autotune=False,
    residual_bound=lambda p: BF16_IR_RESIDUAL_FLOOR,
))
register(Backend(
    name="bf16_ir", op="linear_solve", structure="batched_dense",
    call=lambda p, a, b, **_: _bf16_ir_solve_batched(a, b, tolerance=_ir_tolerance(p)),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 5.0,
    autotune=False,
    residual_bound=lambda p: BF16_IR_RESIDUAL_FLOOR,
))


def _rand_rank(p: Problem, rank) -> int:
    # rank= comes through the public ops; an admitted auto-selection without
    # one sketches at n/8
    return int(rank) if rank else max(1, p.n // 8)


def _randomized_kw(p: Problem, rank, oversample, generator, sketch) -> dict:
    return dict(rank=_rand_rank(p, rank), oversample=oversample, generator=generator,
                sketch=sketch, lu_impl=lambda m: _k.lu_fused(m))


register(Backend(
    name="rand_lu", op="factor", structure="dense",
    call=lambda p, a, *, rank=None, oversample=8, generator=None, sketch=None, **_:
        _rand.randomized_lu(a, **_randomized_kw(p, rank, oversample, generator, sketch)),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 0.1,  # statically dominated: reached through rank= or impl=
    autotune=False,
    residual_bound=lambda p: RAND_LU_RESIDUAL_BOUND,
))
register(Backend(
    name="rand_lu", op="solve", structure="dense",
    # consumes RankKFactors, never auto-selected: ops.lu_solve forces it
    # when handed rank-k factors
    call=lambda p, factors, b, **_: _rand.randomized_solve(factors, b),
    supports=lambda p: False,
    priority=lambda p: 0.0,
    autotune=False,
    residual_bound=lambda p: RAND_LU_RESIDUAL_BOUND,
))
register(Backend(
    name="rand_lu", op="linear_solve", structure="dense",
    call=lambda p, a, b, *, rank=None, oversample=8, generator=None, sketch=None, **_:
        _rand.randomized_linear_solve(
            a, b, **_randomized_kw(p, rank, oversample, generator, sketch),
            tolerance=(min(p.tolerance, RAND_LU_RESIDUAL_BOUND) if p.tolerance > 0
                       else RAND_LU_RESIDUAL_BOUND)),
    supports=lambda p: _is_f32(p) and _local(p),
    priority=lambda p: 0.5,  # below bf16_ir: admitted is not preferred
    autotune=False,
    residual_bound=lambda p: RAND_LU_RESIDUAL_BOUND,
))

# ---------------------------------------------------------------------------
# backends of the reference that later slices bring
# ---------------------------------------------------------------------------
_MULTI = "the multi-device slice (ROADMAP A7)"
NOT_PORTED.update({
    ("factor", "banded", "spike"): _MULTI,
    ("factor", "banded", "replicated"): _MULTI,
    ("solve", "banded", "spike"): _MULTI,
    ("linear_solve", "banded", "spike"): _MULTI,
    ("linear_solve", "banded", "replicated"): _MULTI,
    ("factor", "dense", "distributed"): _MULTI,
    ("linear_solve", "dense", "distributed"): _MULTI,
})
