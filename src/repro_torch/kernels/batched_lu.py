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
* :func:`batched_lu_solve_vmem` — one block per (system, 32-column RHS tile)
                                  sweeps 32-row strips with the tile in
                                  shared memory.

Both kernels round every operation as their plain versions do
(:func:`repro_torch.core.batched.batched_ebv_lu` and
:func:`repro_torch.core.batched.batched_lu_solve`) and return the same
values bit for bit.  The factor works on its own copy of the stack; the
caller's tensor is never written.

Each wrapper runs its plain version for tensors on the CPU and, for tensors
on the card, launches its kernel and adds to ``wrapper.launches`` the count
its C driver reports.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.batched import batched_ebv_lu, batched_lu_solve
from ..core.factorization import packed_of
from . import _build
from .banded import _MAX_SOLVE_BATCH, _launch
from .ebv_lu import H100_SMS, WALK_SMEM, walk_plan
from .trsm import SMEM_BYTES, _check_cuda, _f32

__all__ = [
    "batched_lu_vmem", "batched_lu_solve_vmem", "batched_lu_plain", "batched_lu_solve_plain",
    "RHS_COLS", "solve_rhs_tile", "BatchedPlan", "batched_lu_plan", "cluster_room", "CLUSTER_SIZES",
]

RHS_COLS = 32  # RHS columns a solve block takes at most


def batched_lu_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`batched_lu_vmem`."""
    return batched_ebv_lu(a)


def batched_lu_solve_plain(lu, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`batched_lu_solve_vmem`."""
    return batched_lu_solve(packed_of(lu), b)


def solve_rhs_tile(n: int, m: int) -> int:
    """RHS columns one solve block holds: at most 32 and at most what one
    block's shared memory holds beside ``n`` rows (stride ``n32 + 1``),
    split into equal tiles; 0 when not even one column fits."""
    n32 = -(-n // 32) * 32
    rt = min(RHS_COLS, m, SMEM_BYTES // ((n32 + 1) * 4))
    if rt < 1:
        return 0
    return -(-m // (-(-m // rt)))  # equal tiles


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


def cluster_room(device=None) -> dict:
    """{C: clusters of C CTAs of the factor's cluster kernel the card holds
    at once}, asked of the CUDA driver."""
    room = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _build.check(_build.library().ebv_batched_cluster_room(room), "cluster_room")
    return dict(zip(CLUSTER_SIZES, room))


def batched_lu_vmem(a: torch.Tensor) -> torch.Tensor:
    """Packed no-pivot LU of every system of a ``(B, n, n)`` fp32 stack in
    one launch of the kernel :func:`batched_lu_plan` names; the C entry's
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
    ``b``'s shape and dtype.  On the card one block per system and
    equal tile of at most 32 RHS columns."""
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
    if bsz > _MAX_SOLVE_BATCH:
        raise ValueError(f"batched_lu_solve_vmem: {bsz} systems in one launch, at most "
                         f"{_MAX_SOLVE_BATCH}")
    if bsz == 0 or m == 0:  # nothing to launch
        return torch.empty_like(b)
    rt = solve_rhs_tile(n, m)
    if rt < 1:
        raise ValueError(f"batched_lu_solve_vmem: n={n} leaves no room for one RHS column in "
                         "shared memory")
    name = "batched_lu_solve_vmem"
    lu32, b32 = _f32(lu, name), _f32(bm, name)
    x = torch.empty_like(b32)
    _launch(batched_lu_solve_vmem, "ebv_batched_lu_solve", lu.device, lu32.data_ptr(),
            b32.data_ptr(), x.data_ptr(), bsz, n, m, rt)
    x = x.to(bm.dtype)
    return x[..., 0] if squeeze else x


batched_lu_solve_vmem.launches = 0
