"""Substitution (solve) on a packed no-pivot LU: CUDA kernels
(``csrc/trsm.cu``) and their plain PyTorch versions.

* :func:`solve_vmem`     — one cooperative launch of at most one block
                           per SM, each owning a contiguous block of the
                           factor's rows (32 up to n = 4224) in shared
                           memory for the whole launch; each sweep is a
                           chain of one handoff a row block, the values
                           tagged in place, a warp per 4 RHS columns
                           (:func:`solve_vmem_plan`, and the source's note).
* :func:`solve_tiled`    — x in device memory, (B, B) LU tiles with
                           B ≤ 128; one launch per diagonal step (2S in
                           all, 2S + 1 with the pass below), each spread
                           over every SM: its blocks solve
                           the diagonal tile and retire equal chunks of the
                           trailing rows.
* :func:`solve_inverted` — the same sweep with every diagonal step one
                           product against the artifact's pre-inverted
                           ``(S, B, B)`` blocks: two launches per step
                           (4S-2 in all).

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on the card, counting the launches the C entry reports.
:func:`solve_vmem` and :func:`solve_tiled` then make one more launch, which
the count includes, of the pass that spreads NaN from a non-finite value as
their plain versions' masked sweeps do (``csrc/nonfinite.cuh``: it reads x
and leaves a finite one as it is); :func:`solve_inverted`'s products need
none.
An (n, 0) right-hand side returns an (n, 0) result and launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.blocked import pad_identity_tail, strip_trsm, strip_utrsm
from ..core.factorization import dense_inverted_solve, equalized_rhs_tile, packed_of
from ..core.solve import lu_solve
from . import _build

__all__ = [
    "solve_vmem", "solve_tiled", "solve_inverted",
    "solve_vmem_plain", "solve_tiled_plain", "tiled_launches", "inverted_launches",
    "SolveVmemPlan", "solve_vmem_plan",
    "SMEM_BYTES", "TILED_MAX_BLOCK", "RHS_COLS", "H100_SMS",
]

SMEM_BYTES = 232_448    # dynamic shared memory one H100 block may use
TILED_MAX_BLOCK = 128   # solve_tiled's largest (B, B) tile: a head's strip retirements grow as B^2
RHS_COLS = 64           # most RHS columns a solve_tiled / solve_inverted block holds (kWide)
H100_SMS = 132
VMEM_THREADS = 512      # threads of a solve_vmem block (kVThreads)
VMEM_OUTPUTS = 8        # outputs a solve_vmem thread accumulates (kVOut)
VMEM_MIN_ROWS = 32      # fewest rows a solve_vmem block owns: one warp's rows
VMEM_WARP_COLS = 64     # RHS columns a group of the warp path holds: 4 a warp


def _as_matrix(b: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (b[:, None], True) if b.ndim == 1 else (b, False)


def _compute_dtype(*ts: torch.Tensor) -> torch.dtype:
    out = torch.float32
    for t in ts:
        out = torch.promote_types(out, t.dtype)
    return out


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors lie on different devices")


def _launch_counted(wrapper, fn_name: str, *args, extra: tuple = ()) -> None:
    """Call a C entry that reports its launches (after the stream and
    ``extra``); add them to ``wrapper.launches``."""
    lib = _build.library()
    launched = ctypes.c_int(0)
    code = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream, *extra,
                                 ctypes.byref(launched))
    wrapper.launches += launched.value
    _build.check(code, fn_name)


def _launch_steps(wrapper, fn_name: str, *args) -> None:
    """Call the C entry of a step solve: it computes every step's grid
    before it launches anything, leaves the largest in
    ``wrapper.last_grid`` and refuses one past a grid axis (``ValueError``);
    its launches are added to ``wrapper.launches``."""
    launched, grid = ctypes.c_int(0), ctypes.c_longlong(0)
    code = getattr(_build.library(), fn_name)(*args, torch.cuda.current_stream().cuda_stream,
                                              ctypes.byref(launched), ctypes.byref(grid))
    wrapper.launches += launched.value
    wrapper.last_grid = grid.value
    _build.check(code, fn_name)


def _rhs(name: str, lu: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``b`` as an (n, m) matrix, checked against the (n, n) factor."""
    bm, squeeze = _as_matrix(b)
    n = lu.shape[-1]
    if lu.shape != (n, n) or bm.ndim != 2 or bm.shape[0] != n:
        raise ValueError(f"{name}: factor {tuple(lu.shape)} and RHS {tuple(b.shape)} do not match")
    return bm, squeeze


def _f32(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype == torch.float64:
        raise TypeError(f"{name}: the CUDA kernel computes in float32; got float64")
    return t.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# solve_vmem
# ---------------------------------------------------------------------------
def solve_vmem_plain(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the column-oriented forward and backward sweeps."""
    return lu_solve(packed_of(lu), b)


class SolveVmemPlan(NamedTuple):
    """One :func:`solve_vmem` launch: ``blocks`` blocks of ``rows`` rows, the
    RHS in groups of ``group`` columns, columns ``[theta, n)`` of a block's
    rows resident in shared memory, a block whose diagonal tile lies left
    of theta keeping a copy of it there where ``copy`` (else it reads the
    tile from L2), ``bytes`` of shared memory a block; ``resident`` is the
    share of the factor held there."""
    blocks: int
    rows: int
    group: int
    theta: int
    copy: bool
    bytes: int
    resident: float


def _vmem_bytes(n: int, rows: int, group: int, theta: int, copy: bool) -> int:
    """Shared memory of a block (``ebv_solve_vmem``): the rows' columns
    ``[theta, n)`` at a stride of a multiple of 32 floats plus 4, a copy of
    the diagonal tile where ``copy``, the rows' reciprocal pivots and, past
    32 rows, the group's (rows, group) right-hand side and two handed-over
    row blocks' (rows, group) values."""
    nr = n - theta
    ld = -(-nr // 32) * 32 + 4 if nr > 0 else 0
    return 4 * rows * (ld + (rows if copy else 0) + 1 + (0 if rows <= 32 else 3 * group))


@functools.lru_cache(maxsize=256)
def solve_vmem_plan(n: int, m: int, sms: int = H100_SMS, smem_bytes: int = SMEM_BYTES) -> SolveVmemPlan:
    """The plan :func:`solve_vmem` launches with for an (n, n) factor and m
    RHS columns on a card of ``sms`` SMs: blocks of R = ceil(n / sms) rows,
    at least 32 (one warp's rows: a link of the chain is a handoff and an
    R-row triangle, and the handoff costs the more, so fewer, fuller
    blocks win, as measured on the H100: ``PERF.md``) and at most n, so at
    most one block per SM; the RHS in equal groups of at most 64 columns
    (4 a warp) up to 32 rows, past that of what a block's 512 threads hold
    at 8 outputs each; ``theta`` the least multiple of R at which the rows'
    columns [theta, n) fit ``smem_bytes`` beside the rest, with a copy of
    a streamed diagonal tile, or, where even nothing resident leaves no
    room for that copy (R past about 240), without it.  Raises
    ``ValueError`` where a block's threads cannot hold R rows (R > 4096)."""
    rows = min(n, max(-(-n // sms), VMEM_MIN_ROWS))
    blocks = -(-n // rows)
    widest = VMEM_WARP_COLS if rows <= 32 else VMEM_THREADS // -(-rows // VMEM_OUTPUTS)
    if widest < 1:
        raise ValueError(f"solve_vmem: n = {n} on {sms} SMs needs {rows} rows a block, past the "
                         f"{VMEM_THREADS * VMEM_OUTPUTS} a block's threads hold")
    m = max(m, 1)
    group = -(-m // -(-m // widest))
    for copy in (True, False):
        # the last theta is the first multiple of R at or past n: nothing resident
        for theta in range(0, n + rows, rows):
            nbytes = _vmem_bytes(n, rows, group, theta, copy and theta > 0)
            if nbytes <= smem_bytes:
                return SolveVmemPlan(blocks, rows, group, theta, copy and theta > 0, nbytes,
                                     max(0, n - theta) / n)
    raise ValueError(f"solve_vmem: a block of {rows} rows and {group} RHS columns does not fit "
                     f"{smem_bytes} bytes of shared memory (n = {n})")


def solve_vmem(lu, b: torch.Tensor, *, rhs_tile: int = 256) -> torch.Tensor:
    """Solve ``(LU) x = b`` for packed ``lu`` (n, n) and ``b`` (n,) or
    (n, m), in the RHS dtype: one cooperative launch (:func:`solve_vmem_plan`;
    the plan the C entry launched is left in ``solve_vmem.last_plan``) and
    the non-finite pass, two launches in all.
    ``rhs_tile`` is the reference's argument, which the registry passes; it
    steers nothing here: the plan groups the RHS columns."""
    lu = packed_of(lu)
    if lu.device.type == "cpu":
        return solve_vmem_plain(lu, b)
    _check_cuda("solve_vmem", lu, b)
    bm, squeeze = _rhs("solve_vmem", lu, b)
    n, m = bm.shape
    if m == 0:
        return torch.empty_like(bm)  # an (n, 0) RHS: nothing to launch
    plan = solve_vmem_plan(n, m, _build.sm_count(lu.device.index or 0))
    lu32, b32 = _f32(lu, "solve_vmem"), _f32(bm, "solve_vmem")
    x = torch.empty_like(b32)
    # the two sweeps' handed-over values, each with its tag in one 8-byte word
    cells = torch.zeros((2, n, m), dtype=torch.int64, device=lu.device)
    got = (ctypes.c_int * 6)()
    with _build.device_guard(lu.device):
        _launch_counted(solve_vmem, "ebv_solve_vmem", lu32.data_ptr(), b32.data_ptr(), x.data_ptr(),
                        cells.data_ptr(), n, m, plan.rows, plan.group, plan.theta, int(plan.copy),
                        extra=(got,))
    solve_vmem.last_plan = tuple(got)
    x = x.to(bm.dtype)
    return x[:, 0] if squeeze else x


solve_vmem.launches = 0
solve_vmem.last_plan = None


# ---------------------------------------------------------------------------
# solve_tiled
# ---------------------------------------------------------------------------
def tiled_block(n: int, block: int) -> int:
    """Tile size of :func:`solve_tiled` (and of its plain version)."""
    return min(block, n, TILED_MAX_BLOCK)


def tiled_launches(n: int, block: int = 256) -> int:
    """Kernel launches :func:`solve_tiled` makes for an (n, n) factor and a
    non-empty RHS: one per diagonal step of each sweep, then the non-finite
    pass."""
    return 2 * (-(-n // tiled_block(n, block))) + 1


def inverted_launches(n: int, block: int) -> int:
    """Kernel launches :func:`solve_inverted` makes for an (n, n) factor
    with ``(S, block, block)`` inverses and a non-empty RHS: per step the
    inverse product and the retirement, none of the last step's retirement
    in either sweep."""
    return 4 * (-(-n // block)) - 2


def _rhs_tile(m: int, rhs_tile: int) -> int:
    """RHS columns per block: equal tiles of at most ``rhs_tile`` and
    :data:`RHS_COLS` columns."""
    return equalized_rhs_tile(m, max(1, min(rhs_tile, RHS_COLS)))


def solve_tiled_plain(lu: torch.Tensor, b: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Plain version: identity-padded blocked sweep, ``strip_trsm`` /
    ``strip_utrsm`` on each diagonal tile and one product per off-diagonal
    block column, at (at least) fp32."""
    lu = packed_of(lu)
    bm, squeeze = _as_matrix(b)
    compute = _compute_dtype(lu, bm)
    n, m = bm.shape
    B = tiled_block(n, block)
    S = -(-n // B)
    N = S * B
    lup = pad_identity_tail(lu.to(compute), N)
    x = torch.zeros((N, m), dtype=compute, device=bm.device)
    x[:n] = bm
    for i in range(S):
        lo, hi = i * B, (i + 1) * B
        x[lo:hi] = strip_trsm(lup[lo:hi, lo:hi], x[lo:hi])
        if hi < N:
            x[hi:] -= lup[hi:, lo:hi] @ x[lo:hi]
    for i in range(S - 1, -1, -1):
        lo, hi = i * B, (i + 1) * B
        x[lo:hi] = strip_utrsm(lup[lo:hi, lo:hi], x[lo:hi])
        if lo:
            x[:lo] -= lup[:lo, lo:hi] @ x[lo:hi]
    x = x[:n].to(bm.dtype)
    return x[:, 0] if squeeze else x


def solve_tiled(lu, b: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Blocked ``(LU) x = b`` with the LU in device memory, in
    ``(B, B)`` tiles, ``B = min(block, n, 128)``: one launch per diagonal
    step, whose blocks each solve the diagonal tile and retire an equal
    chunk of the trailing rows.  Computes at fp32 and casts back to the RHS
    dtype; RHS columns go in equal tiles of at most 64."""
    lu = packed_of(lu)
    if lu.device.type == "cpu":
        return solve_tiled_plain(lu, b, block=block)
    _check_cuda("solve_tiled", lu, b)
    bm, squeeze = _rhs("solve_tiled", lu, b)
    n, m = bm.shape
    if m == 0:
        return torch.empty_like(bm)  # an (n, 0) RHS: nothing to launch
    B, tile = tiled_block(n, block), _rhs_tile(m, RHS_COLS)
    lu32, b32 = _f32(lu, "solve_tiled"), _f32(bm, "solve_tiled")
    x, y = torch.empty_like(b32), torch.empty_like(b32)
    with torch.cuda.device(lu.device):
        _launch_steps(solve_tiled, "ebv_solve_tiled", lu32.data_ptr(), b32.data_ptr(),
                      x.data_ptr(), y.data_ptr(), n, m, B, tile)
    x = x.to(bm.dtype)
    return x[:, 0] if squeeze else x


solve_tiled.launches = 0
solve_tiled.last_grid = None


# ---------------------------------------------------------------------------
# solve_inverted
# ---------------------------------------------------------------------------
def solve_inverted(lu, linv: torch.Tensor, uinv: torch.Tensor, b: torch.Tensor, *,
                   rhs_tile: int = 512) -> torch.Tensor:
    """Blocked ``(LU) x = b`` from a ``Factorization``'s pre-inverted
    ``(S, B, B)`` diagonal blocks: every diagonal step is one product
    against the stored inverse, then a rank-B retirement, each one launch
    spread over every SM.  RHS columns go in equal tiles of at most
    ``min(rhs_tile, 64)``
    (:func:`~repro_torch.core.factorization.equalized_rhs_tile`)."""
    lu = packed_of(lu)
    if lu.device.type == "cpu":
        return dense_inverted_solve(lu, linv, uinv, b)
    _check_cuda("solve_inverted", lu, linv, uinv, b)
    bm, squeeze = _rhs("solve_inverted", lu, b)
    n, m = bm.shape
    S, B = linv.shape[0], linv.shape[1]
    if linv.shape != (S, B, B) or S * B < n or uinv.shape != linv.shape:
        raise ValueError(f"solve_inverted: inverses {tuple(linv.shape)} do not cover n={n}")
    if m == 0:
        return torch.empty_like(bm)  # an (n, 0) RHS: nothing to launch
    tile = _rhs_tile(m, rhs_tile)
    lu32, b32 = _f32(lu, "solve_inverted"), _f32(bm, "solve_inverted")
    li32, ui32 = _f32(linv, "solve_inverted"), _f32(uinv, "solve_inverted")
    x, y = torch.empty_like(b32), torch.empty_like(b32)
    with torch.cuda.device(lu.device):
        _launch_steps(solve_inverted, "ebv_solve_inverted", lu32.data_ptr(), li32.data_ptr(),
                      ui32.data_ptr(), b32.data_ptr(), x.data_ptr(), y.data_ptr(), n, m, B, tile)
    x = x.to(bm.dtype)
    return x[:, 0] if squeeze else x


solve_inverted.launches = 0
solve_inverted.last_grid = None
