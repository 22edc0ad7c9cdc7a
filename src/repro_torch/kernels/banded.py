"""The banded EbV factor and solves: CUDA kernels (``csrc/banded.cu``, and
``csrc/band_walk.cu`` for the three band factors :func:`banded_lu_blocked`,
:func:`batched_banded_lu_vmem` and :func:`banded_lu_kernelized` up to
bw = 31) and their plain PyTorch versions.

* :func:`banded_lu_blocked`       — one launch walks the whole pivot chain:
                                    up to bw = 31 one warp, the live rows on
                                    its lanes and the band streamed through
                                    a ring of rows in shared memory; wider
                                    bands one block, the band streamed
                                    through a ring of rows in shared memory,
                                    or in device memory for bands too wide
                                    for it (:func:`band_lu_walk`).
* :func:`banded_lu_tiled`         — one launch per block step of ``C``
                                    pivots, in stream order, each staging its
                                    slab of the band through shared memory;
                                    past bw = 32, or where no block holds
                                    the slab, one launch of a thread-block
                                    cluster that
                                    keeps the band's active rows in its
                                    CTAs' shared memory and retires the
                                    pivots in groups (:func:`tiled_plan`).
* :func:`banded_lu_kernelized`    — the legacy scalar-sequential factor:
                                    the one-launch walk of
                                    :func:`banded_lu_blocked` with each pivot
                                    updating its whole ``(bw, 2bw+1)``
                                    window, the pivot row's tail shifted in
                                    by the reference's one-hot contraction
                                    (:func:`banded_lu_window_plain`).
* :func:`banded_solve_kernelized` — forward and backward band substitution
                                    in strips of 32 rows, staged ahead of a
                                    solver warp a RHS column and helper
                                    warps (:func:`band_solve_plan`), then a
                                    launch of the non-finite pass.
* :func:`banded_solve_inverted`   — the substitution from an enriched
                                    ``Factorization``'s inverses and transfer
                                    blocks: batched products and a tail
                                    recurrence, six launches.
* :func:`batched_banded_lu_vmem`  — the one-launch walk of
                                    :func:`banded_lu_blocked` over a
                                    ``(B, n, 2bw+1)`` stack: one warp per
                                    band up to bw = 31, else one block.
* :func:`batched_banded_solve_vmem` — the staged solve of
                                    :func:`banded_solve_kernelized` over a
                                    stack in one launch, one block per
                                    (system, RHS tile), and the pass.

The factors compute the plain version's packed band factor
(:func:`repro_torch.core.banded.banded_lu_blocked`, over the stack for the
batched one; :func:`banded_lu_window_plain` for the scalar one) value for
value: the factor does not depend on the block size, and the kernels round
every operation as the plain version does.  Each factor works on its own copy of
the band; the caller's tensor is never written.

Each wrapper runs its plain version for tensors on the CPU and, for tensors
on the card, launches its kernels and adds to ``wrapper.launches`` the count
its C driver reports.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.banded import band_block_size
from ..core.blocked import sub_block_width
from ..core.banded import banded_lu_blocked as _banded_lu_plain
from ..core.banded import banded_solve_blocked
from ..core.factorization import banded_inverted_solve, packed_of
from . import _build
from .trsm import _as_matrix, _check_cuda, _f32

__all__ = [
    "banded_lu_blocked", "banded_lu_tiled", "banded_lu_kernelized", "banded_solve_kernelized",
    "banded_solve_inverted", "batched_banded_lu_vmem", "batched_banded_solve_vmem",
    "banded_lu_plain", "banded_lu_window_plain", "banded_lu_scalar_plain", "tiled_launches",
    "BandClusterPlan", "BandSolvePlan",
    "band_solve_plan", "SOLVE_STAGES",
    "band_cluster_plan", "tiled_plan", "slab_fits", "GLOBAL_WALK", "BAND_SMEM",
    "BAND_CLUSTER_MIN_BW", "WARP_WALK_MAX_BW", "BAND_WALKS", "band_lu_walk",
]

_WARP_COLS = 32  # RHS columns (one warp each) a band_solve_kernel block takes at most
_SOLVE_COLS = 8  # RHS columns (a solver warp each) a staged band solve block takes at most
SOLVE_STAGES = (4, 3, 2)  # staged strips it tries in turn (three steps of lookahead, then two, one)
BAND_SMEM = 232_448  # dynamic shared memory one H100 block may use (kSmemBytes)
CLUSTER_THREADS = 512  # a CTA of the cluster walk: a thread for each of a panel's rows (kClusterThreads)
# (K, g) the cluster walk tries in turn, fastest first at the Poisson band in
# chip_smoke.py's sweep (launch/time_kernels.py:band_cluster_sweep)
CLUSTER_ORDER = ((16, 16), (16, 8), (8, 16), (16, 32), (8, 32), (8, 8), (4, 16), (4, 8),
                 (2, 16), (2, 8), (2, 32))
CLUSTER_GROUPS = (8, 16, 32)  # the pivots a group the cluster walk is built for
# From this half width the cluster walk beats the slab steps even where the
# slab fits a block (launch/time_kernels.py:band_walk_crossover, PERF.md)
BAND_CLUSTER_MIN_BW = 33
#: Widest band :func:`banded_lu_blocked` walks on one warp: its bw + 1 live
#: rows on the warp's lanes (``csrc/band_walk.cu``; ``csrc/banded.cu:kWarpWalkMaxBw``)
WARP_WALK_MAX_BW = 31
#: The walks :func:`banded_lu_blocked` launches, by the C entry's path number
BAND_WALKS = ("warp walk", "ring walk", "device-memory walk")
#: :func:`tiled_plan`'s answer for a band that no cluster holds: one launch of
#: the one-block walk on the band in device memory (``band_lu_global_kernel``)
GLOBAL_WALK = "global walk"


def _launch(wrapper, fn_name: str, device, *args) -> None:
    lib = _build.library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream,
                                     ctypes.byref(launched))
    wrapper.launches += launched.value
    _build.check(code, fn_name)


def _band_copy(name: str, arow: torch.Tensor, bw: int, ndim: int = 2) -> torch.Tensor:
    """A contiguous fp32 copy of the band (``ndim=3``: the stack of bands)
    on the card, for the kernel to factor in place."""
    if bw < 1 or arow.ndim != ndim or arow.shape[-1] != 2 * bw + 1:
        what = "(n, 2bw+1)" if ndim == 2 else "stack (B, n, 2bw+1)"
        raise ValueError(f"{name} expects a row-aligned band {what} with bw >= 1, got "
                         f"{tuple(arow.shape)} and bw={bw}")
    if arow.dtype != torch.float32:
        raise TypeError(f"{name} supports float32 only, got {arow.dtype}")
    if arow.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {arow.device}")
    return arow.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# band LU
# ---------------------------------------------------------------------------
def banded_lu_plain(arow: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Plain version of both band factors
    (:func:`repro_torch.core.banded.banded_lu_blocked`)."""
    return _banded_lu_plain(arow, bw=bw, block=block)


def banded_lu_window_plain(arow: torch.Tensor, *, bw: int) -> torch.Tensor:
    """Plain version of the scalar-sequential factor :func:`banded_lu_kernelized`:
    the reference kernel's step (``repro.kernels.banded._banded_kernel``),
    one pivot at a time.  Pivot k's window, rows k+1 .. k+bw, takes
    ``window - l * shifted`` and then its multipliers on the anti-diagonal,
    where ``shifted[r, c] = sum_t onehot[r, c, t] * u_t`` shifts the pivot
    row's upper tail ``u`` into the window with IEEE products: while ``u`` is
    finite, ``u`` on the entries the tail reaches and 0 elsewhere (the masked
    step of :func:`repro_torch.core.banded.banded_lu`); where exactly one
    ``u_t`` is infinite, ``u_t`` on the entries that take column t and NaN
    elsewhere (``0 * inf``); otherwise NaN throughout."""
    n, w = arow.shape
    dev = arow.device
    ap = torch.cat([arow, torch.zeros((bw, w), dtype=arow.dtype, device=dev)])
    # window row r (offset s = r + 1) takes tail entry c - (bw + 1 - s) at band column c
    s = torch.arange(1, bw + 1, device=dev)[:, None]
    src = torch.arange(w, device=dev)[None, :] - (bw + 1 - s)
    take = torch.where((src >= 0) & (src < bw), src, bw)  # bw: the 0 past the tail
    anti = (torch.arange(bw, device=dev), bw - 1 - torch.arange(bw, device=dev))
    zero = torch.zeros(1, dtype=arow.dtype, device=dev)
    nan = torch.full((), float("nan"), dtype=arow.dtype, device=dev)
    for k in range(n - 1):
        window = ap[k + 1:k + 1 + bw]  # a view
        l = window[anti] / ap[k, bw]
        tail = torch.cat([ap[k, bw + 1:], zero])
        bad = ~torch.isfinite(tail)
        # 0 * u_t is NaN for a non-finite u_t: NaN where one lies off the entry's own column
        shifted = torch.where(bad.sum() > bad[take], nan, tail[take])
        window -= l[:, None] * shifted
        window[anti] = l
    return ap[:n]


banded_lu_scalar_plain = banded_lu_window_plain


class BandClusterPlan(NamedTuple):
    """The cluster walk of :func:`banded_lu_tiled`: ``ctas`` (K), ``group``
    (g pivots a group), ``ring_rows`` a CTA holds and its shared-memory
    ``bytes``."""
    ctas: int
    group: int
    ring_rows: int
    bytes: int


def _slab_bytes(rows: int, bw: int) -> int:
    return (rows * (2 * bw + 1) + 2 * bw) * 4


def _cluster_bytes(bw: int, k: int, g: int) -> tuple[int, int]:
    """(ring rows, bytes) of a CTA of the cluster walk: the ring, 16-byte
    aligned, then three panels' pivot rows (stride round4(g + bw)), two
    panels' columns of the rows below (stride g + 1) and their multipliers."""
    rows = -(-(2 * g + bw) // k)
    up = -(-rows * (2 * bw + 1) * 4 // 16) * 16
    ldu = -(-(g + bw) // 4) * 4
    return rows, up + 4 * (3 * g * ldu + 3 * (g + bw) * (g + 1))


def band_cluster_plan(bw: int, *, ctas: int | None = None, group: int | None = None) -> BandClusterPlan:
    """The cluster walk's K CTAs and g pivots a group for a band of half
    width ``bw``: ``ctas`` and ``group`` where given, else the first pair of
    :data:`CLUSTER_ORDER` whose CTA fits shared memory, with g in
    :data:`CLUSTER_GROUPS`, at most bw, and a thread for each of a panel's
    g + bw rows.  Raises ``ValueError`` where none fits."""
    for k, g in CLUSTER_ORDER:
        k, g = ctas or k, group or g
        rows, nbytes = _cluster_bytes(bw, k, g)
        if g in CLUSTER_GROUPS and g <= bw and g + bw <= CLUSTER_THREADS and nbytes <= BAND_SMEM:
            return BandClusterPlan(k, g, rows, nbytes)
        if ctas and group:
            break
    raise ValueError(f"band_cluster_plan: no cluster of {ctas or 'any'} CTAs and groups of "
                     f"{group or 'any'} pivots holds bw={bw} in shared memory")


def slab_fits(n: int, bw: int, block: int | None = None) -> bool:
    """Whether one block step's ``(C + bw, 2bw + 1)`` slab fits one block's
    shared memory (bw up to 84 at the default C = 256)."""
    return _slab_bytes(band_block_size(n, bw, block) + bw, bw) <= BAND_SMEM


def tiled_plan(n: int, bw: int, block: int | None = None) -> BandClusterPlan | str | None:
    """The path :func:`banded_lu_tiled` launches for the band: None for the
    per-step slab launches, where the slab fits and the band is narrower
    than :data:`BAND_CLUSTER_MIN_BW`; else the cluster walk's plan, or
    :data:`GLOBAL_WALK` where no cluster holds the band (bw past ~490)."""
    if bw < BAND_CLUSTER_MIN_BW and slab_fits(n, bw, block):
        return None
    try:
        return band_cluster_plan(bw)
    except ValueError:
        return GLOBAL_WALK


def tiled_launches(n: int, bw: int, block: int | None = None) -> int:
    """Launches :func:`banded_lu_tiled` should make: one per block step, or
    one for either walk; none for an empty band."""
    if n == 0:
        return 0
    if tiled_plan(n, bw, block) is not None:
        return 1
    return -(-n // band_block_size(n, bw, block))


def band_lu_walk(n: int, bw: int) -> str:
    """The walk :func:`banded_lu_blocked`, :func:`batched_banded_lu_vmem`
    and :func:`banded_lu_kernelized` launch for (n, 2bw+1) bands (one of
    :data:`BAND_WALKS`): the warp walk up to
    :data:`WARP_WALK_MAX_BW`, else the ring walk where bw + 1 rows and a
    chunk of pivots fit a block's shared memory, else the device-memory
    walk (the C entries' rule, ``csrc/banded.cu:band_lu_walk``)."""
    if bw <= WARP_WALK_MAX_BW:
        return BAND_WALKS[0]
    row, lbuf = (2 * bw + 1) * 4, 2 * bw * 4
    # pivots a chunk: the whole band where it fits, else the ring's rows less bw
    chunk = n if n * row + lbuf <= BAND_SMEM else max(0, BAND_SMEM - lbuf) // row - bw
    return BAND_WALKS[1] if chunk >= 1 else BAND_WALKS[2]


def banded_lu_blocked(arow: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Packed no-pivot LU of the row-aligned band ``(n, 2bw+1)`` in one
    launch (none for an empty band on the warp walk).  ``block`` sets the
    plain version's window; the kernels stage as many rows as they hold,
    which gives the same factor.  The walk that ran (:func:`band_lu_walk`)
    in ``banded_lu_blocked.last_path``."""
    if arow.device.type == "cpu":
        return banded_lu_plain(arow, bw=bw, block=block)
    work = _band_copy("banded_lu_blocked", arow, bw)
    path = ctypes.c_int(0)
    try:
        _launch(banded_lu_blocked, "ebv_band_lu_resident", arow.device, work.data_ptr(),
                work.shape[0], bw, ctypes.byref(path))
    finally:
        banded_lu_blocked.last_path = BAND_WALKS[path.value]
    return work


banded_lu_blocked.launches = 0
banded_lu_blocked.last_path = None


def banded_lu_tiled(arow: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Packed no-pivot LU of the row-aligned band in ``ceil(n/C)``
    launches, one per block step of ``C = band_block_size(n, bw, block)``
    pivots, in stream order; from bw = :data:`BAND_CLUSTER_MIN_BW`, or
    where a step's slab fits no block, in one launch of the cluster walk,
    or of the device-memory walk where no cluster holds the band
    (:func:`tiled_plan`).  The C entry's report (path 0 steps / 1 cluster /
    2 device-memory walk, K, g, ring rows, shared-memory bytes a CTA,
    clusters the card holds at once) in ``banded_lu_tiled.last_plan``."""
    if arow.device.type == "cpu":
        return banded_lu_plain(arow, bw=bw, block=block)
    n = arow.shape[0]
    return _lu_tiled(arow, bw=bw, block=block, plan=tiled_plan(n, bw, block) if n else None)


def _lu_tiled(arow: torch.Tensor, *, bw: int, block: int | None = None,
              plan: BandClusterPlan | str | None = None) -> torch.Tensor:
    """:func:`banded_lu_tiled` on the card by the slab steps (``plan``
    None), the cluster walk ``plan`` or the device-memory walk
    (:data:`GLOBAL_WALK`), whichever :func:`tiled_plan` would pick, so that
    the tests and the sweeps can launch any path."""
    work = _band_copy("banded_lu_tiled", arow, bw)
    n = work.shape[0]
    got = (ctypes.c_int * 6)()
    cluster = isinstance(plan, BandClusterPlan)
    path = 1 if cluster else 2 if plan == GLOBAL_WALK else 0
    try:
        if n:  # an empty band: nothing to launch
            _launch(banded_lu_tiled, "ebv_band_lu_steps", arow.device, work.data_ptr(), n, bw, path,
                    band_block_size(n, bw, block), plan.ctas if cluster else 0,
                    plan.group if cluster else 0, got)
    finally:
        banded_lu_tiled.last_plan = tuple(got)
    return work


banded_lu_tiled.launches = 0
banded_lu_tiled.last_plan = None


def banded_lu_kernelized(arow: torch.Tensor, *, bw: int) -> torch.Tensor:
    """Packed no-pivot LU of the row-aligned band, one pivot at a time, in
    one launch (none for an empty band): each pivot updates the whole
    ``(bw, 2bw+1)`` window below it (the legacy scalar-sequential factor;
    plain version :func:`banded_lu_window_plain`).  The walk that ran, by
    :func:`band_lu_walk`'s rule, in ``banded_lu_kernelized.last_path``."""
    if arow.device.type == "cpu":
        return banded_lu_scalar_plain(arow, bw=bw)
    work = _band_copy("banded_lu_kernelized", arow, bw)
    path = ctypes.c_int(0)
    try:
        _launch(banded_lu_kernelized, "ebv_band_lu_scalar", arow.device, work.data_ptr(),
                work.shape[0], bw, ctypes.byref(path))
    finally:
        banded_lu_kernelized.last_path = BAND_WALKS[path.value]
    return work


banded_lu_kernelized.launches = 0
banded_lu_kernelized.last_path = None


# ---------------------------------------------------------------------------
# band solves
# ---------------------------------------------------------------------------
class BandSolvePlan(NamedTuple):
    """The launch of :func:`banded_solve_kernelized`: ``path`` "staged"
    (``band_solve_staged_kernel``) or "warp" (``band_solve_kernel``, bands
    whose two staged strips no block holds), ``warps`` a block, ``cols``
    RHS columns a block, ``stages`` staged strips and shared-memory
    ``bytes`` a block (the staged path's)."""
    path: str
    warps: int
    cols: int
    stages: int
    bytes: int


def _solve_bytes(bw: int, cols: int, warps: int, stages: int) -> int:
    """A staged solve block's shared memory: ``stages`` strips of 32 rows of
    one half of the band (row stride S, S/4 odd, skewed 4 floats every 8
    rows), a ring of ``cap`` solved values a column and the helpers' partial
    sums, double buffered (``solve_layout`` in ``csrc/banded.cu``)."""
    q = (bw + 10) // 4
    q += 1 - q % 2
    stage, cap = 32 * 4 * q + 16, -(-(bw + 64) // 32) * 32
    helpers = warps - cols if warps > cols else warps
    return 4 * (stages * stage + cols * cap + 2 * helpers * cols * 32)


def band_solve_plan(n: int, bw: int, m: int, *, rhs_tile: int = 256, warps: int | None = None,
                    stages: int | None = None) -> BandSolvePlan:
    """The launch :func:`banded_solve_kernelized` makes for ``m`` RHS
    columns: blocks of ``warps`` (default 4 where bw <= 32, else 16) warps over
    equal tiles of at most ``min(rhs_tile, warps, 8)`` columns, a solver
    warp a column, with ``stages`` (default the most of
    :data:`SOLVE_STAGES` that fits) staged strips; the warp path where not
    even two staged strips of one column fit (bw past ~870) or where
    ``stages`` does not."""
    # 4 where bw <= 32 (no term lies two strips back: no helper has work),
    # else 16 (launch/time_kernels.py:band_solve_sweep, PERF.md)
    warps = warps or (4 if bw <= 32 else 16)
    if not 1 <= warps <= 16:
        raise ValueError(f"band_solve_plan: {warps} warps a block, 1 to 16")
    cols = max(1, min(rhs_tile, m, warps, _SOLVE_COLS))
    while True:  # fewer columns a block where their rings and sums leave no room
        cols = -(-m // -(-m // cols)) if m else cols  # equal tiles
        for r in ((stages,) if stages else SOLVE_STAGES):
            nbytes = _solve_bytes(bw, cols, warps, r)
            if nbytes <= BAND_SMEM:
                return BandSolvePlan("staged", warps, cols, r, nbytes)
        if cols == 1:
            break
        cols //= 2
    rt = max(1, min(rhs_tile, m, _WARP_COLS))
    rt = -(-m // -(-m // rt)) if m else rt
    return BandSolvePlan("warp", rt, rt, 0, 0)


def banded_solve_kernelized(lu_band, b: torch.Tensor, *, bw: int, block: int | None = None,
                            rhs_tile: int = 256) -> torch.Tensor:
    """Solve ``(LU) x = b`` on packed band factors ``(n, 2bw+1)``, ``b``
    ``(n,)`` or ``(n, m)``, in the RHS dtype.  On the card one launch of
    :func:`band_solve_plan`'s kernel and one of the non-finite pass (two
    launches in all): a block per tile of at most
    ``min(rhs_tile, 8)`` columns, strips of 32 rows staged ahead of a solver
    warp a column and helper warps.  ``block`` sets the plain version's
    blocking.  The C entry's report (path 1 staged / 0 warp, warps, columns
    a block, stages, shared-memory bytes) in ``.last_plan``."""
    lu_band = packed_of(lu_band)
    if lu_band.device.type == "cpu":
        return banded_solve_blocked(lu_band, b, bw=bw, block=block)
    _check_cuda("banded_solve_kernelized", lu_band, b)
    bm, _ = _as_matrix(b)
    n, m = bm.shape
    return _solve(lu_band, b, bw=bw, plan=band_solve_plan(n, bw, m, rhs_tile=rhs_tile), block=block)


def _solve(lu_band, b: torch.Tensor, *, bw: int, plan: BandSolvePlan, block: int | None = None) -> torch.Tensor:
    """:func:`banded_solve_kernelized` on the card by ``plan``, so that the
    tests and the sweeps can launch any path, warps a block and stages."""
    name = "banded_solve_kernelized"
    bm, squeeze = _as_matrix(b)
    n, m = bm.shape
    if bw < 1 or lu_band.shape != (n, 2 * bw + 1):
        raise ValueError(f"{name}: factors {tuple(lu_band.shape)} do not match n={n}, bw={bw}")
    if m == 0:  # no column to solve: nothing to launch
        return torch.empty_like(b)
    x = _solve_stack(banded_solve_kernelized, lu_band, bm[None], bw=bw, plan=plan, block=block)[0]
    return x[:, 0] if squeeze else x


def _solve_stack(wrapper, lu_band, bm: torch.Tensor, *, bw: int, plan: BandSolvePlan,
                 block: int | None = None) -> torch.Tensor:
    """One launch of ``plan`` over the factors ``(B, n, 2bw+1)`` (or, for
    one system, ``(n, 2bw+1)``) and the RHS ``(B, n, m)`` on the card, the
    same plan for every system; ``x`` in the RHS dtype and the C entry's
    report in ``wrapper.last_plan``.  The C entry then spreads NaN as the
    plain version's masked strips of ``sub_block_width(band_block_size(n,
    bw, block))`` rows do, in one more launch, which ``wrapper.launches``
    counts (it leaves a finite result as it is)."""
    bsz, n, m = bm.shape
    name = wrapper.__name__
    lu32, b32 = _f32(lu_band, name), _f32(bm, name)
    if lu32.data_ptr() % 16:  # the staged strips are copied in 16-byte chunks from the stack's base
        lu32 = lu32.clone()
    x = torch.empty_like(b32)
    got = (ctypes.c_int * 5)()
    try:
        _launch(wrapper, "ebv_band_solve", lu_band.device, lu32.data_ptr(), b32.data_ptr(), x.data_ptr(),
                bsz, n, bw, m, int(plan.path == "staged"), plan.warps, plan.cols, plan.stages,
                sub_block_width(band_block_size(n, bw, block)), got)
    finally:
        wrapper.last_plan = tuple(got)
    return x.to(bm.dtype)


banded_solve_kernelized.launches = 0
banded_solve_kernelized.last_plan = None


def banded_solve_inverted(linv: torch.Tensor, uinv: torch.Tensor, tlo: torch.Tensor,
                          tup: torch.Tensor, b: torch.Tensor, *, n: int, bw: int) -> torch.Tensor:
    """Solve ``(LU) x = b`` from an enriched banded ``Factorization``: the
    ``(S, C, C)`` inverses ``linv``/``uinv`` and ``(S, C, bw)`` transfer
    blocks ``tlo``/``tup``.  Each sweep is a batched product over all ``S``
    blocks, the ``(bw, m)`` tail recurrence and a second batched product.
    On the card the products are a thread per row for up to 4 RHS columns
    and 32 x 32 tiles past that; the recurrence up to bw = 32 is a solver
    warp per group of up to 8 RHS columns, its loads staged ahead of it by a
    producer warp, and one block per 32 columns past that."""
    if linv.device.type == "cpu":
        return banded_inverted_solve(linv, uinv, tlo, tup, b, n=n, bw=bw)
    return _solve_inverted(linv, uinv, tlo, tup, b, n=n, bw=bw, tiles=False)


def _solve_inverted(linv, uinv, tlo, tup, b, *, n: int, bw: int, tiles: bool) -> torch.Tensor:
    """:func:`banded_solve_inverted` on the card; ``tiles`` runs the products
    on 32 x 32 tiles and the block recurrence at every shape, which give the
    same values: the tests and the sweeps hold the other paths to it."""
    _check_cuda("banded_solve_inverted", linv, uinv, tlo, tup, b)
    bm, squeeze = _as_matrix(b)
    m = bm.shape[1]
    S, C = linv.shape[0], linv.shape[1]
    if (bw < 1 or S * C < n or bm.shape[0] != n or uinv.shape != linv.shape
            or tlo.shape != (S, C, bw) or tup.shape != (S, C, bw)):
        raise ValueError(f"banded_solve_inverted: inverses {tuple(linv.shape)} and transfer blocks "
                         f"{tuple(tlo.shape)} do not fit n={n}, bw={bw}")
    if m == 0:  # no column to solve: nothing to launch
        return torch.empty_like(b)
    name = "banded_solve_inverted"
    li, ui, lo, up = (_f32(t, name) for t in (linv, uinv, tlo, tup))
    xb = torch.zeros((S * C, m), dtype=torch.float32, device=bm.device)
    xb[:n] = _f32(bm, name)
    out, z, y = (torch.empty_like(xb) for _ in range(3))
    t = torch.empty((S * bw, m), dtype=torch.float32, device=bm.device)
    _launch(banded_solve_inverted, "ebv_band_solve_inverted", bm.device, li.data_ptr(),
            ui.data_ptr(), lo.data_ptr(), up.data_ptr(), xb.data_ptr(), out.data_ptr(),
            z.data_ptr(), y.data_ptr(), t.data_ptr(), S, C, bw, m, int(tiles))
    x = out[:n].to(bm.dtype)
    return x[:, 0] if squeeze else x


banded_solve_inverted.launches = 0


# ---------------------------------------------------------------------------
# batched band factor and solve (many independent systems, one block each)
# ---------------------------------------------------------------------------
def batched_banded_lu_vmem(arow: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Packed no-pivot LU of every band of a row-aligned ``(B, n, 2bw+1)``
    stack in one launch (none for an empty stack): one warp per band up to
    :data:`WARP_WALK_MAX_BW`, else one block per band.  ``block`` sets the
    plain version's window; the kernel's factor does not depend on it.  The
    walk that ran (:func:`band_lu_walk`) in
    ``batched_banded_lu_vmem.last_path``."""
    if arow.device.type == "cpu":
        if arow.ndim != 3:
            raise ValueError(f"batched_banded_lu_vmem expects a stack (B, n, 2bw+1), got "
                             f"{tuple(arow.shape)}")
        return banded_lu_plain(arow, bw=bw, block=block)
    work = _band_copy("batched_banded_lu_vmem", arow, bw, ndim=3)
    path = ctypes.c_int(0)
    try:
        _launch(batched_banded_lu_vmem, "ebv_batched_band_lu", arow.device, work.data_ptr(),
                work.shape[0], work.shape[1], bw, ctypes.byref(path))
    finally:
        batched_banded_lu_vmem.last_path = BAND_WALKS[path.value]
    return work


batched_banded_lu_vmem.launches = 0
batched_banded_lu_vmem.last_path = None


def batched_banded_solve_vmem(lu_band, b: torch.Tensor, *, bw: int, block: int | None = None,
                              rhs_tile: int = 256, plan: BandSolvePlan | None = None) -> torch.Tensor:
    """Solve ``(LU)_s x_s = b_s`` for every system of packed band factors
    ``(B, n, 2bw+1)``; ``b`` is ``(B, n)`` or ``(B, n, m)`` and the result
    has its shape and dtype.  On the card one launch of
    :func:`banded_solve_kernelized`'s kernel and plan for one system
    (:func:`band_solve_plan`, or ``plan`` where given, so that the tests
    and the sweeps can force one), and one of the non-finite pass: a block
    per (system, RHS tile), any
    number of systems, each system's ``x`` bitwise
    :func:`banded_solve_kernelized`'s on that system alone.  ``block``
    sets the plain version's blocking.  The C entry's report (as
    :func:`banded_solve_kernelized`'s) in ``.last_plan``."""
    lu_band = packed_of(lu_band)
    if lu_band.device.type == "cpu":
        return banded_solve_blocked(lu_band, b, bw=bw, block=block)
    name = "batched_banded_solve_vmem"
    _check_cuda(name, lu_band, b)
    squeeze = b.ndim == 2
    bm = b[..., None] if squeeze else b
    if (bw < 1 or lu_band.ndim != 3 or bm.ndim != 3 or lu_band.shape[-1] != 2 * bw + 1
            or bm.shape[:2] != lu_band.shape[:2]):
        raise ValueError(f"{name}: factors {tuple(lu_band.shape)} and RHS {tuple(b.shape)} are "
                         f"not (B, n, 2bw+1) and (B, n[, m]) with bw={bw}")
    bsz, n, m = bm.shape
    if bsz == 0 or n == 0 or m == 0:  # nothing to launch
        return torch.empty_like(b)
    plan = plan or band_solve_plan(n, bw, m, rhs_tile=rhs_tile)
    x = _solve_stack(batched_banded_solve_vmem, lu_band, bm, bw=bw, plan=plan, block=block)
    return x[..., 0] if squeeze else x


batched_banded_solve_vmem.launches = 0
batched_banded_solve_vmem.last_plan = None
