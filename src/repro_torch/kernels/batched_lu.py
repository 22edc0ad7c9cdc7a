"""The batched EbV factor and solve for many small independent systems (the
optimizer's path): CUDA kernels (``csrc/batched_lu.cu``) and their plain
PyTorch versions.

* :func:`batched_lu_vmem`       — each ``(n, n)`` system's ``n-1`` pivots
                                  walked in one launch: one block per
                                  system in shared memory for n ≤ 240;
                                  above, a thread-block cluster per system
                                  holding it in its CTAs' shared memory, or
                                  one block per system in device memory
                                  where that already fills the card
                                  (:func:`batched_lu_plan`).
* :func:`batched_lu_solve_vmem` — one launch of the kernel
                                  :func:`batched_solve_plan` names: where the
                                  grid of (RHS tile, system) blocks fills the
                                  card, one block each sweeps 32-column strips
                                  of the factor, staged in shared memory, with
                                  register-tiled updates; otherwise a
                                  thread-block cluster per (system, tile of
                                  at most 16 columns) whose CTAs own the
                                  strips by equalized pairs.

Both kernels round every operation as their plain versions do
(:func:`repro_torch.core.batched.batched_ebv_lu` and
:func:`repro_torch.core.batched.batched_lu_solve`) and return the same
values bit for bit.  The factor works on its own copy of the stack; the
caller's tensor is never written.

Each wrapper runs its plain version for tensors on the CPU and, for tensors
on the card, launches its kernel and adds to ``wrapper.launches`` the count
its C entry reports.  Both follow their plain versions on a non-finite
value: the factor's C entry makes one more launch (n ≥ 3), which its count
includes, of the pass that spreads NaN as the masked steps do
(``csrc/nonfinite.cuh``; it returns at once on a finite factor), and the
solve's kernels write a column whose
first row is not finite as NaN throughout, as the masked sweeps make it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.batched import batched_ebv_lu, batched_lu_solve
from ..core.factorization import packed_of
from . import _build
from .banded import _launch
from .ebv_lu import H100_SMS, WALK_SMEM, walk_plan
from .trsm import _check_cuda, _f32

__all__ = [
    "batched_lu_vmem", "batched_lu_solve_vmem", "batched_lu_plain", "batched_lu_solve_plain",
    "BatchedPlan", "batched_lu_plan", "cluster_room", "CLUSTER_SIZES", "SolvePlan",
    "batched_solve_plan", "batched_solve_fits", "solve_cluster_room", "wide_cols", "cluster_cols",
]

STRIP = 32           # strip height of the solve's sweeps (kStrip)
SOLVE_THREADS = 256  # a wide solve block (kSolveThreads)
CHUNK_ROWS = 256     # factor rows a wide block stages at once, at most (kChunkRows)
NARROW_COLS = 16     # RHS columns of one cluster's tile, at most (kNarrowCols)
CLUSTER_MAX_RHS = 4  # RHS columns up to which the plan prefers a cluster (kClusterMaxRhs)


def batched_lu_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`batched_lu_vmem`."""
    return batched_ebv_lu(a)


def batched_lu_solve_plain(lu, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`batched_lu_solve_vmem`."""
    return batched_lu_solve(packed_of(lu), b)


CLUSTER_SIZES = (2, 4, 8, 16)  # CTAs of one system's cluster (csrc/batched_lu.cu: kClusterSizes)


class BatchedPlan(NamedTuple):
    """The factor's kernel: ``kind`` "staged", "global" or "cluster",
    ``ctas`` per system, and for a cluster its :class:`~.ebv_lu.WalkPlan`."""
    kind: str
    ctas: int
    walk: object = None


def batched_lu_plan(bsz: int, n: int, sms: int = H100_SMS, room: dict | None = None) -> BatchedPlan:
    """The kernel :func:`batched_lu_vmem` launches for ``bsz`` ``(n, n)``
    systems on ``sms`` SMs that hold ``room[C]`` clusters of C CTAs at once
    (``batched_plan`` in csrc/batched_lu.cu; ``room`` defaults to
    ``sms // C``, :func:`cluster_room` has the card's): a system that fits
    one block's shared memory (n ≤ 240) is staged there, one block each;
    where ``bsz >= sms`` blocks already fill the card, one block per system
    walks device memory; else each system takes a cluster of the largest C
    whose ``bsz`` clusters all run at once, or of 2 CTAs."""
    if (n * n + 2 * n) * 4 <= WALK_SMEM:
        return BatchedPlan("staged", 1)
    if bsz >= sms:
        return BatchedPlan("global", 1)
    room = room or {c: sms // c for c in CLUSTER_SIZES}
    c = next((c for c in CLUSTER_SIZES[:0:-1] if bsz <= room[c]), CLUSTER_SIZES[0])
    return BatchedPlan("cluster", c, walk_plan(n, n, c, 4))


class SolvePlan(NamedTuple):
    """The solve's kernel: ``path`` "wide" or "cluster", the RHS columns of
    a tile, the CTAs per (system, tile) and the shared-memory bytes a CTA."""
    path: str
    cols: int
    ctas: int
    bytes: int


def _wide_bytes(n: int, w: int) -> int:
    """A wide block's shared memory: the tile (n32 rows, stride w+4) and two
    staged chunks of factor rows (32 columns, stride 36)."""
    n32 = -(-n // STRIP) * STRIP
    nrg = SOLVE_THREADS // (w // 4)
    rm = 8 if nrg * 8 <= CHUNK_ROWS else CHUNK_ROWS // nrg
    return 4 * (n32 * (w + 4) + 2 * rm * nrg * (STRIP + 4))


def wide_cols(n: int, m: int) -> int:
    """The wide tile's RHS columns: the least of 4, 8, 16, 32, 64 that holds
    ``m`` (64 past 32), narrowed until its block fits shared memory; 0 if not
    even 4 columns do."""
    w = 4
    while w < 64 and w < m:
        w *= 2
    while w >= 4 and _wide_bytes(n, w) > WALK_SMEM:
        w //= 2
    return w if w >= 4 else 0


def _narrow_bytes(n: int, mt: int, c: int) -> int:
    """A cluster CTA's shared memory: its strips' values (two slots a unit of
    ceil(S/2) over c CTAs) and three receive buffers, ``mt`` columns each."""
    s = -(-n // STRIP)
    slots = 2 * -(-(-(-s // 2)) // c)
    return 4 * (slots * STRIP + 3 * STRIP) * mt


def cluster_cols(n: int, m: int, c: int = CLUSTER_SIZES[-1]) -> int:
    """A cluster tile's RHS columns: at most 16 (a warp each), narrowed to
    what a CTA of a cluster of ``c`` holds beside its strips, in equal tiles
    over ``m``; 0 where not one column fits."""
    cap = min(NARROW_COLS, m, WALK_SMEM // _narrow_bytes(n, 1, c))
    return -(-m // -(-m // cap)) if cap > 0 else 0


def batched_solve_plan(bsz: int, n: int, m: int, sms: int = H100_SMS, room: dict | None = None,
                       path: str | None = None, ctas: int | None = None) -> SolvePlan:
    """The kernel :func:`batched_lu_solve_vmem` launches for ``bsz`` systems
    of order ``n`` with ``m`` RHS columns on ``sms`` SMs that hold
    ``room[C]`` clusters of C CTAs of the cluster kernel at once (``room``
    defaults to ``sms // C``, :func:`solve_cluster_room` has the card's).
    Wide where its grid of (tile, system) blocks fills the SMs or the RHS has
    more than :data:`CLUSTER_MAX_RHS` columns; else a cluster per (system,
    tile of :func:`cluster_cols` columns) of the largest C whose clusters all
    run at once; else wide where a block fits; else the cluster of the fewest
    CTAs whose shared memory holds the strips.  Where one column fits a
    cluster of 16, every ``m`` does, in tiles of fewer columns.  ``path``
    forces "wide" or "cluster", ``ctas`` a cluster's CTAs.  Raises
    ``ValueError`` where nothing fits."""
    if path not in (None, "wide", "cluster"):
        raise ValueError(f"batched_solve_plan: path {path!r} is not 'wide' or 'cluster'")
    room = room or {c: sms // c for c in CLUSTER_SIZES}
    w = wide_cols(n, m)
    mt = cluster_cols(n, m, ctas or CLUSTER_SIZES[-1])
    tiles = -(-m // mt) if mt else 0
    fits = [c for c in ((ctas,) if ctas else CLUSTER_SIZES) if mt and _narrow_bytes(n, mt, c) <= WALK_SMEM]
    at_once = next((c for c in reversed(fits) if bsz * tiles <= room.get(c, 0)), 0)
    wide = SolvePlan("wide", w, 1, _wide_bytes(n, w)) if w else None
    cluster = (lambda c: SolvePlan("cluster", mt, c, _narrow_bytes(n, mt, c)))
    if path == "wide" or (path is None and w and (bsz * -(-m // w) >= sms or m > CLUSTER_MAX_RHS)):
        plan = wide
    elif path == "cluster" or at_once:
        plan = cluster(at_once or fits[0]) if fits else None
    else:
        plan = wide or (cluster(fits[0]) if fits else None)
    if plan is None:
        raise ValueError(f"batched_solve_plan: no {path or 'solve'} kernel holds n={n} in one "
                         "block's shared memory")
    return plan


def batched_solve_fits(n: int) -> bool:
    """Whether the card's solve takes systems of order ``n``."""
    try:
        batched_solve_plan(1, n, 1)
    except ValueError:
        return False
    return True


def cluster_room(device=None) -> dict:
    """{C: clusters of C CTAs of the factor's cluster kernel the card holds
    at once}, asked of the CUDA driver."""
    room = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _build.check(_build.library().ebv_batched_cluster_room(room), "cluster_room")
    return dict(zip(CLUSTER_SIZES, room))


def solve_cluster_room(device=None) -> dict:
    """{C: clusters of C CTAs of the solve's cluster kernel the card holds
    at once}, asked of the CUDA driver."""
    room = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _build.check(_build.library().ebv_batched_solve_cluster_room(room), "solve_cluster_room")
    return dict(zip(CLUSTER_SIZES, room))


@functools.lru_cache(maxsize=None)
def _solve_room(index: int) -> dict:
    return solve_cluster_room(index)


def batched_lu_vmem(a: torch.Tensor) -> torch.Tensor:
    """Packed no-pivot LU of every system of a ``(B, n, n)`` fp32 stack in
    one launch of the kernel :func:`batched_lu_plan` names, then for n ≥ 3
    one of the non-finite pass (two launches in all); the C entry's
    plan (kind 0 staged / 1 global / 2 cluster, CTAs per system, and for a
    cluster theta, shared-memory bytes and clusters the card holds at once)
    in ``batched_lu_vmem.last_plan``."""
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"batched_lu_vmem expects a (B, n, n) stack, got shape {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"batched_lu_vmem supports float32 only, got {a.dtype}")
    if a.device.type == "cpu":
        return batched_lu_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"batched_lu_vmem runs on CPU or CUDA tensors, got {a.device}")
    work = a.clone(memory_format=torch.contiguous_format)
    plan = (ctypes.c_int * 5)()
    try:
        _launch(batched_lu_vmem, "ebv_batched_lu", a.device, work.data_ptr(), work.shape[0],
                work.shape[-1], plan)
    finally:
        batched_lu_vmem.last_plan = tuple(plan)
    return work


batched_lu_vmem.launches = 0
batched_lu_vmem.last_plan = None


def batched_lu_solve_vmem(lu, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(LU)_s x_s = b_s`` for every system of packed ``lu``
    ``(B, n, n)``; ``b`` is ``(B, n)`` or ``(B, n, m)``; the result has
    ``b``'s shape and dtype.  On the card one launch of the kernel
    :func:`batched_solve_plan` names for the card's SMs and cluster room;
    the C entry's report (path 1 wide / 2 cluster, the tile's columns, CTAs,
    shared-memory bytes a CTA and, for a cluster, how many the card holds at
    once) in ``batched_lu_solve_vmem.last_plan``."""
    return _solve(lu, b, None)


def _solve(lu, b: torch.Tensor, plan: SolvePlan | None) -> torch.Tensor:
    """:func:`batched_lu_solve_vmem` with the given ``plan`` (None: the
    card's own), so that the tests and the sweeps can launch either path."""
    lu = packed_of(lu)
    if lu.device.type == "cpu":
        return batched_lu_solve_plain(lu, b)
    _check_cuda("batched_lu_solve_vmem", lu, b)
    squeeze = b.ndim == 2
    bm = b[..., None] if squeeze else b
    if lu.ndim != 3 or bm.ndim != 3 or lu.shape[-1] != lu.shape[-2] or bm.shape[:2] != lu.shape[:2]:
        raise ValueError(f"batched_lu_solve_vmem: factors {tuple(lu.shape)} and RHS "
                         f"{tuple(b.shape)} are not (B, n, n) and (B, n[, m])")
    bsz, n, m = bm.shape
    if bsz == 0 or n == 0 or m == 0:  # nothing to launch
        return torch.empty_like(b)
    index = lu.device.index if lu.device.index is not None else torch.cuda.current_device()
    plan = plan or batched_solve_plan(bsz, n, m, _build.sm_count(index), _solve_room(index))
    name = "batched_lu_solve_vmem"
    lu32, b32 = _f32(lu, name), _f32(bm, name)
    x = torch.empty_like(b32)
    got = (ctypes.c_int * 5)()
    try:
        _launch(batched_lu_solve_vmem, "ebv_batched_lu_solve", lu.device, lu32.data_ptr(),
                b32.data_ptr(), x.data_ptr(), bsz, n, m, 1 if plan.path == "wide" else 2, plan.cols,
                plan.ctas, got)
    finally:
        batched_lu_solve_vmem.last_plan = tuple(got)
    x = x.to(bm.dtype)
    return x[..., 0] if squeeze else x


batched_lu_solve_vmem.launches = 0
batched_lu_solve_vmem.last_plan = None
