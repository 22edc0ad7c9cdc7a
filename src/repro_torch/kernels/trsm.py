"""Substitution (solve) on a packed no-pivot LU: CUDA kernels
(``csrc/trsm.cu``) and their plain PyTorch versions.

* :func:`solve_vmem`     — one block per RHS tile, the (n, rt) tile held in
                           shared memory, the LU read from L2; the sweep
                           goes in 32-row strips (see the source's note).
* :func:`solve_tiled`    — x in device memory, (B, B) LU tiles with
                           B ≤ 128; one launch per diagonal step (2S in
                           all), each spread over every SM: its blocks solve
                           the diagonal tile and retire equal chunks of the
                           trailing rows.
* :func:`solve_inverted` — the same sweep with every diagonal step one
                           product against the artifact's pre-inverted
                           ``(S, B, B)`` blocks: two launches per step
                           (4S-2 in all).

Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for tensors on the card, counting the launches the C entry reports.
An (n, 0) right-hand side returns an (n, 0) result and launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.blocked import pad_identity_tail, strip_trsm, strip_utrsm
from ..core.factorization import dense_inverted_solve, equalized_rhs_tile, packed_of
from ..core.solve import lu_solve
from . import _build

__all__ = [
    "solve_vmem", "solve_tiled", "solve_inverted",
    "solve_vmem_plain", "solve_tiled_plain", "tiled_launches", "inverted_launches",
    "SMEM_BYTES", "TILED_MAX_BLOCK", "RHS_COLS",
]

SMEM_BYTES = 232_448    # dynamic shared memory one H100 block may use
TILED_MAX_BLOCK = 128   # solve_tiled's largest (B, B) tile: a head's strip retirements grow as B^2
RHS_COLS = 64           # most RHS columns a solve_tiled / solve_inverted block holds (kWide)
_THREADS = 512


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


def _launch(fn_name: str, *args) -> None:
    lib = _build.library()
    code = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(code, fn_name)


def _launch_counted(wrapper, fn_name: str, *args) -> None:
    """Call a C entry that reports its launches; add them to ``wrapper.launches``."""
    lib = _build.library()
    launched = ctypes.c_int(0)
    code = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream,
                                 ctypes.byref(launched))
    wrapper.launches += launched.value
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


def solve_vmem(lu, b: torch.Tensor, *, rhs_tile: int = 256) -> torch.Tensor:
    """Solve ``(LU) x = b`` for packed ``lu`` (n, n) and ``b`` (n,) or
    (n, m), in the RHS dtype.  The RHS columns split into equal tiles of at
    most ``rhs_tile`` columns and at most what one block's shared memory
    holds beside n rows."""
    lu = packed_of(lu)
    if lu.device.type == "cpu":
        return solve_vmem_plain(lu, b)
    _check_cuda("solve_vmem", lu, b)
    bm, squeeze = _rhs("solve_vmem", lu, b)
    n, m = bm.shape
    if m == 0:
        return torch.empty_like(bm)  # an (n, 0) RHS: nothing to launch
    n32 = -(-n // 32) * 32
    cap = SMEM_BYTES // (n32 * 4)
    if cap < 1:
        raise ValueError(f"solve_vmem: n={n} leaves no room for one RHS column in shared memory")
    rt = min(rhs_tile, m, cap)
    rt = -(-m // (-(-m // rt)))  # equal tiles
    lu32, b32 = _f32(lu, "solve_vmem"), _f32(bm, "solve_vmem")
    x = torch.empty_like(b32)
    with torch.cuda.device(lu.device):
        _launch("ebv_solve_vmem", lu32.data_ptr(), b32.data_ptr(), x.data_ptr(), n, m, rt, _THREADS)
    solve_vmem.launches += 1
    x = x.to(bm.dtype)
    return x[:, 0] if squeeze else x


solve_vmem.launches = 0


# ---------------------------------------------------------------------------
# solve_tiled
# ---------------------------------------------------------------------------
def tiled_block(n: int, block: int) -> int:
    """Tile size of :func:`solve_tiled` (and of its plain version)."""
    return min(block, n, TILED_MAX_BLOCK)


def tiled_launches(n: int, block: int = 256) -> int:
    """Kernel launches :func:`solve_tiled` makes for an (n, n) factor and a
    non-empty RHS: one per diagonal step of each sweep."""
    return 2 * (-(-n // tiled_block(n, block)))


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
    lu32, b32 = _f32(lu, "solve_tiled"), _f32(bm, "solve_tiled")
    x, y = torch.empty_like(b32), torch.empty_like(b32)
    with torch.cuda.device(lu.device):
        _launch_counted(solve_tiled, "ebv_solve_tiled", lu32.data_ptr(), b32.data_ptr(),
                        x.data_ptr(), y.data_ptr(), n, m, tiled_block(n, block),
                        _rhs_tile(m, RHS_COLS))
    x = x.to(bm.dtype)
    return x[:, 0] if squeeze else x


solve_tiled.launches = 0


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
    lu32, b32 = _f32(lu, "solve_inverted"), _f32(bm, "solve_inverted")
    li32, ui32 = _f32(linv, "solve_inverted"), _f32(uinv, "solve_inverted")
    x, y = torch.empty_like(b32), torch.empty_like(b32)
    with torch.cuda.device(lu.device):
        _launch_counted(solve_inverted, "ebv_solve_inverted", lu32.data_ptr(), li32.data_ptr(),
                        ui32.data_ptr(), b32.data_ptr(), x.data_ptr(), y.data_ptr(), n, m, B,
                        _rhs_tile(m, rhs_tile))
    x = x.to(bm.dtype)
    return x[:, 0] if squeeze else x


solve_inverted.launches = 0
