"""The dense EbV LU kernels: CUDA kernels (``csrc/ebv_lu.cu``,
``csrc/legacy_lu.cu``) and their plain PyTorch versions.

:func:`lu_fused` replaces the reference's single-dispatch Pallas
megakernel.  It factors one copy of the caller's matrix in steps of
``W`` columns (:func:`fused_step_width`: ``block``, at most the 128 of the
diagonal tile the kernel holds in registers): the first
diagonal tile, then per step the panels, the next step's block row and
column, the next diagonal tile and, beside it, the rest of the trailing
update (:func:`fused_launches`).  The kernels mask the ragged last step, so
the matrix is never padded.  The caller's tensor is never mutated.

The legacy kernels behind the forced ``lu(impl="cuda_vmem")`` and
``lu(impl="cuda_blocked")``:

* :func:`lu_vmem`    — the paper-faithful unblocked factor, n-1 masked
                       rank-1 steps on the whole matrix, one cooperative
                       launch of one block per SM, rows resident in shared
                       memory and one ready flag per pivot row
                       (:func:`walk_plan` mirrors its residency);
* :func:`panel`      — the same steps on a tall (m, b) panel, pivots in
                       the top b rows (the same kernel);
* :func:`fused_step` — U12 = L11⁻¹ A12 and A22 − L21·U12 in two launches;
* :func:`update`     — the rank-k trailing update A22 − L21·U12, on
                       :func:`lu_fused`'s SGEMM tile (``csrc/sgemm.cuh``).

They take fp32 or bf16; in bf16 every operation rounds to bf16 as
PyTorch's elementwise bf16 ops do, and products accumulate in fp32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.blocked import fused_block_size, fused_blocked_lu, sub_block_width
from . import _build

__all__ = ["lu_fused", "lu_fused_plain", "fused_launches", "fused_step_width", "lu_vmem", "lu_vmem_plain",
           "panel", "panel_plain", "fused_step", "fused_step_plain", "update", "update_plain",
           "owned_rows", "row_owner", "WalkPlan", "walk_plan", "legacy_walk_plan", "WALK_SMEM", "H100_SMS"]

_LEGACY_DTYPES = (torch.float32, torch.bfloat16)
FUSED_TILE_MAX = 128  # csrc/ebv_lu.cu: the diagonal tile in registers, 16 values a thread


def lu_fused_plain(a: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`lu_fused`
    (:func:`repro_torch.core.blocked.fused_blocked_lu`)."""
    return fused_blocked_lu(a, block=block)


def fused_step_width(n: int, block: int = 256) -> int:
    """Columns one step of :func:`lu_fused`'s kernels factors: ``block``,
    at most the 128 of the kernel's register tile and, where the matrix
    takes more than one step, a multiple of 4 (the trailing update copies
    its operands in 16-byte pieces from the step's offsets).  The kernels
    mask the ragged last step, so the plain version's padding rule
    (:func:`repro_torch.core.blocked.fused_block_size`) has no part in it."""
    width = min(block, n, FUSED_TILE_MAX)
    return width if width == n else max(4, width - width % 4)


def fused_launches(n: int, block: int = 256) -> int:
    """Kernel launches :func:`lu_fused` should make for an (n, n) matrix
    (the count it adds to ``lu_fused.launches`` is the one the C driver
    reports): per step but the last the panels, the next step's block row
    and column, the next diagonal tile and the rest of the trailing update
    (none after the last panels), plus the first diagonal tile, and for
    n ≥ 2 the pass that spreads NaN as the plain version does."""
    steps = -(-n // fused_step_width(n, block))
    return (4 * steps - 4 if steps > 1 else 1) + (n >= 2)


def lu_fused(a: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Packed no-pivot LU of a square fp32 matrix: unit L strictly below
    the diagonal, U on and above it.

    A tensor on the CPU runs the plain version; a CUDA tensor launches the
    kernels, then one launch of the pass that spreads NaN as the plain
    version's masked strips do where the factor holds a non-finite value
    (``csrc/nonfinite.cuh``; it returns at once on a finite factor), and
    ``lu_fused.launches`` adds the count the C entry reports
    (:func:`fused_launches`)."""
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"lu_fused expects a square matrix, got shape {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"lu_fused supports float32 only, got {a.dtype}")
    if a.device.type == "cpu":
        return lu_fused_plain(a, block=block)
    if a.device.type != "cuda":
        raise ValueError(f"lu_fused runs on CPU or CUDA tensors, got {a.device}")
    n = a.shape[-1]
    width = fused_step_width(n, block)
    work = a.clone(memory_format=torch.contiguous_format)
    # the panels' copies, (W, ldt) each, for the trailing updates (a row
    # holds the trailing width and one tile past it), and the W reciprocal
    # pivots of the diagonal tile
    ldt = 4 * -(-(n - width + FUSED_TILE_MAX) // 4)
    scratch = torch.empty(2 * width * ldt + width if n > width else 0, dtype=a.dtype, device=a.device)
    # the plain version's blocking, whose masked strips the C entry's pass
    # after the steps follows where the factor holds a non-finite value
    pb = fused_block_size(n, block)
    lib = _build.library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        code = lib.ebv_lu_fused(work.data_ptr(), n, width, scratch.data_ptr(), ldt, pb, sub_block_width(pb),
                                torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    lu_fused.launches += launched.value
    _build.check(code, "lu_fused")
    return work


lu_fused.launches = 0


# ---------------------------------------------------------------------------
# the legacy kernels (csrc/legacy_lu.cu)
# ---------------------------------------------------------------------------
def _lu_steps_plain(a: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` steps of the reference's ``_lu_body`` on a copy of ``a``:
    the masked column divided by the pivot, the masked row, ``a − l·u``
    over the whole matrix, the multipliers written back into column k."""
    m, n = a.shape
    rows = torch.arange(m, device=a.device)[:, None]
    cols = torch.arange(n, device=a.device)[None, :]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for k in range(steps):
        col = a[:, k:k + 1]
        l_col = torch.where(rows > k, col / a[k, k], zero)
        u_row = torch.where(cols > k, a[k:k + 1, :], zero)
        a = a - l_col * u_row
        a[:, k:k + 1] = torch.where(rows > k, l_col, col)
    return a


def lu_vmem_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`lu_vmem`: n−1 steps of ``_lu_body``."""
    return _lu_steps_plain(a, a.shape[-1] - 1)


def panel_plain(p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`panel`: b steps of ``_lu_body`` on
    the (m, b) panel."""
    return _lu_steps_plain(p, p.shape[-1])


def _check_legacy(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.ndim != 2:
            raise ValueError(f"{name} expects matrices, got shape {tuple(t.shape)}")
        if t.dtype not in _LEGACY_DTYPES or t.dtype != ts[0].dtype:
            raise TypeError(f"{name} supports one dtype of float32/bfloat16, got {t.dtype}")
        if t.device != ts[0].device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} runs on CPU or CUDA tensors on one device, got {t.device}")


# ---------------------------------------------------------------------------
# the walk's plan (csrc/ebv_walk.cuh), mirrored for the CPU tests
# ---------------------------------------------------------------------------
WALK_SMEM = 232448  # dynamic shared memory one H100 block may use (kWalkSmem)
WALK_LAG = 8  # steps a streamed element's updates are applied together (kLag)
H100_SMS = 132


def owned_rows(c: int, parts: int, m: int) -> list[int]:
    """Rows of participant ``c`` of ``parts`` in a walk over ``m`` rows, in
    decreasing order (``Owned::row``): the equalized pairing's units
    ``c, c + parts, ...``, unit u holding rows ``m-1-u`` and ``u+1`` (the
    middle row of an even m once)."""
    units = m // 2
    j = -(-(units - c) // parts) if c < units else 0
    jl = j - int(m % 2 == 0 and j > 0 and c + (j - 1) * parts == units - 1)
    return ([m - 1 - (c + t * parts) for t in range(j)]
            + [c + (jl - 1 - q) * parts + 1 for q in range(jl)])


def row_owner(i: int, parts: int, m: int) -> tuple[int, int]:
    """(participant, place in its :func:`owned_rows`) of row ``i >= 1``
    (``row_owner`` in csrc/ebv_walk.cuh)."""
    units = m // 2
    if i >= m - units:
        u = m - 1 - i
        return u % parts, u // parts
    u = i - 1
    c = u % parts
    return c, len(owned_rows(c, parts, m)) - 1 - u // parts


class WalkPlan(NamedTuple):
    """Shared memory of a walk over ``parts`` participants: rows above
    ``theta`` keep columns ``[theta, ncols)`` (``bytes`` per block at most);
    ``resident`` is the share of the matrix held there at the start."""
    parts: int
    theta: int
    bytes: int
    resident: float


def walk_plan(m: int, ncols: int, parts: int, elem: int) -> WalkPlan | None:
    """The least theta at which every participant's rows above it fit beside
    the fp32 pivot row and the last ``WALK_LAG`` steps' multipliers
    (``walk_plan`` in csrc/ebv_walk.cuh); None if not even those fit."""
    rows_max = 2 * -(-(m // 2) // parts)
    rows_at = -(-(ncols + WALK_LAG * rows_max) * 4 // 16) * 16
    if rows_at > WALK_SMEM:
        return None
    rows = [np.array(owned_rows(c, parts, m), dtype=np.int64) for c in range(parts)]

    def above(theta):
        return [int((r > theta).sum()) for r in rows]

    def fits(theta):
        return rows_at + max(above(theta)) * (ncols - theta) * elem <= WALK_SMEM

    lo, hi = 0, ncols
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if fits(mid) else (mid + 1, hi)
    held = sum(above(lo)) * (ncols - lo)
    return WalkPlan(parts, lo, rows_at + max(above(lo)) * (ncols - lo) * elem, held / (m * ncols))


def legacy_walk_plan(m: int, ncols: int, dtype: torch.dtype = torch.float32,
                     sms: int = H100_SMS) -> WalkPlan | None:
    """The plan :func:`lu_vmem` / :func:`panel` launch with: one block per
    SM, at most one per unit (m // 2)."""
    return walk_plan(m, ncols, max(1, min(sms, m // 2)), torch.empty((), dtype=dtype).element_size())


def _walk(a: torch.Tensor, steps: int, wrapper) -> torch.Tensor:
    """The EbV steps on a contiguous copy of the CUDA matrix ``a`` (one
    cooperative launch, counted on ``wrapper``; the C entry's plan, blocks,
    theta and shared-memory bytes, in ``wrapper.last_plan``)."""
    work = a.contiguous().clone()
    m, ncols = work.shape
    ready = torch.zeros(m + 1, dtype=torch.int32, device=a.device)  # a flag per row, blocks done
    lib = _build.library()
    plan = (ctypes.c_int * 3)()
    launched = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        code = lib.ebv_legacy_walk(work.data_ptr(), m, ncols, steps, int(a.dtype == torch.bfloat16),
                                   ready.data_ptr(), torch.cuda.current_stream().cuda_stream, plan,
                                   ctypes.byref(launched))
    wrapper.launches += launched.value
    wrapper.last_plan = tuple(plan)
    _build.check(code, wrapper.__name__)
    return work


def lu_vmem(a: torch.Tensor) -> torch.Tensor:
    """Paper-faithful unblocked EbV LU of a square matrix: n−1 masked
    rank-1 steps, packed (unit L strictly below the diagonal, U on and
    above).  A CPU tensor runs :func:`lu_vmem_plain`; a CUDA tensor is one
    cooperative launch (none for n = 1), counted in ``lu_vmem.launches``.
    Equal to the plain version value for value, NaN and inf included."""
    _check_legacy("lu_vmem", a)
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"lu_vmem expects a square matrix, got shape {tuple(a.shape)}")
    if a.device.type == "cpu":
        return lu_vmem_plain(a)
    return _walk(a, a.shape[-1] - 1, lu_vmem)


def panel(p: torch.Tensor) -> torch.Tensor:
    """Tall (m, b) panel factorization, pivots in the top b rows (m ≥ b).
    A CPU tensor runs :func:`panel_plain`; a CUDA tensor is one cooperative
    launch (none for m = 1), counted in ``panel.launches``."""
    _check_legacy("panel", p)
    if p.shape[0] < p.shape[1]:
        raise ValueError(f"panel expects a tall (m, b) panel with m >= b, got {tuple(p.shape)}")
    if p.device.type == "cpu":
        return panel_plain(p)
    return _walk(p, p.shape[-1], panel)


def _product_f32(l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.matmul(l.to(torch.float32), u.to(torch.float32))


def fused_step_plain(pan: torch.Tensor, a_top: torch.Tensor, a_trail: torch.Tensor):
    """Plain PyTorch version of :func:`fused_step`: b masked axpys against
    the unit-lower L11 (every op in the operands' dtype), then
    ``A22 − (L21 @ U12)`` with the product in fp32, rounded once."""
    b = pan.shape[1]
    rows = torch.arange(b, device=pan.device)[:, None]
    zero = torch.zeros((), dtype=pan.dtype, device=pan.device)
    y = a_top.clone()
    for k in range(b):
        lk = torch.where(rows > k, pan[:b, k:k + 1], zero)
        y = y - lk * y[k:k + 1]
    return y, a_trail - _product_f32(pan[b:], y).to(a_trail.dtype)


def fused_step(pan: torch.Tensor, a_top: torch.Tensor, a_trail: torch.Tensor, *,
               col_tile: int = 256):
    """Fused bi-vector step.  ``pan``: (m, b) factored packed panel;
    ``a_top``: (b, W) A12 rows; ``a_trail``: (m−b, W) A22, with
    ``W % min(col_tile, W) == 0`` as in the reference.  Returns
    ``(U12, updated A22)``.  A CUDA tensor is two launches in stream order
    (the U12 solve, a tile of columns a block, then A22 − L21·U12 on the
    SGEMM tile; one where m = b), counted in ``fused_step.launches``.  U12
    equals the plain version value for value: a column holding a
    non-finite value comes out NaN throughout, as the masked axpys make it."""
    _check_legacy("fused_step", pan, a_top, a_trail)
    m, b = pan.shape
    w = a_top.shape[1]
    if a_top.shape[0] != b or a_trail.shape != (m - b, w):
        raise ValueError(f"fused_step: shapes {tuple(pan.shape)}, {tuple(a_top.shape)}, "
                         f"{tuple(a_trail.shape)} do not match")
    ct = min(col_tile, w)
    if w % ct:
        raise ValueError(f"fused_step: width {w} is not a multiple of the column tile {ct}")
    if pan.device.type == "cpu":
        return fused_step_plain(pan, a_top, a_trail)
    pan, top, trail = pan.contiguous(), a_top.contiguous(), a_trail.contiguous()
    u12, out = torch.empty_like(top), torch.empty_like(trail)
    launched = ctypes.c_int(0)
    with torch.cuda.device(pan.device):
        code = _build.library().ebv_legacy_fused_step(
            pan.data_ptr(), top.data_ptr(), trail.data_ptr(), u12.data_ptr(), out.data_ptr(),
            m, b, w, int(pan.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
    fused_step.launches += launched.value
    _build.check(code, "fused_step")
    return u12, out


def update_plain(l21: torch.Tensor, u12: torch.Tensor, a22: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`update`: ``A22 − (L21 @ U12)`` with
    the product in fp32, rounded once to A22's dtype."""
    return a22 - _product_f32(l21, u12).to(a22.dtype)


def update(l21: torch.Tensor, u12: torch.Tensor, a22: torch.Tensor, *, row_tile: int = 256,
           col_tile: int = 256) -> torch.Tensor:
    """Rank-k trailing update ``A22 − L21 @ U12`` into a new tensor.  The
    reference's ``row_tile`` / ``col_tile`` must divide (m, W) as there; they
    steer nothing on the card, where it is one launch of the dense factor's
    SGEMM tile (none for an empty result), counted in ``update.launches``."""
    _check_legacy("update", l21, u12, a22)
    m, k = l21.shape
    w = u12.shape[1]
    if u12.shape[0] != k or a22.shape != (m, w):
        raise ValueError(f"update: shapes {tuple(l21.shape)}, {tuple(u12.shape)}, "
                         f"{tuple(a22.shape)} do not match")
    rt, ct = min(row_tile, m), min(col_tile, w)
    if m % rt or w % ct:
        raise ValueError(f"update: tiles ({rt}, {ct}) do not divide ({m}, {w})")
    if l21.device.type == "cpu":
        return update_plain(l21, u12, a22)
    l21, u12, a22 = l21.contiguous(), u12.contiguous(), a22.contiguous()
    out = torch.empty_like(a22)
    if out.numel() == 0:
        return out
    with _build.device_guard(l21.device):
        code = _build.library().ebv_legacy_update(
            l21.data_ptr(), u12.data_ptr(), a22.data_ptr(), out.data_ptr(), m, k, w,
            int(l21.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    update.launches += 1
    _build.check(code, "update")
    return out


lu_vmem.launches = 0
panel.launches = 0
lu_vmem.last_plan = panel.last_plan = None
fused_step.launches = 0
update.launches = 0
