"""The banded EbV factor and solves: CUDA kernels (``csrc/banded.cu``) and
their plain PyTorch versions.

* :func:`banded_lu_blocked`       — one launch walks the whole pivot chain,
                                    the band streamed through a ring of rows
                                    in shared memory (in device memory for
                                    bands too wide for it).
* :func:`banded_lu_tiled`         — one launch per block step of ``C``
                                    pivots, in stream order, each staging its
                                    slab of the band through shared memory.
* :func:`banded_solve_kernelized` — forward and backward band substitution,
                                    one warp per RHS column.
* :func:`banded_solve_inverted`   — the substitution from an enriched
                                    ``Factorization``'s inverses and transfer
                                    blocks: batched products and a tail
                                    recurrence, six launches.

Both factors compute the plain version's packed band factor
(:func:`repro_torch.core.banded.banded_lu_blocked`) value for value: the
factor does not depend on the block size, and the kernels round every
operation as the plain version does.  Each factor works on its own copy of
the band; the caller's tensor is never written.

Each wrapper runs its plain version for tensors on the CPU and, for tensors
on the card, launches its kernels and adds to ``wrapper.launches`` the count
its C driver reports.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.banded import band_block_size, banded_lu_blocked as _banded_lu_plain
from ..core.banded import banded_solve_blocked
from ..core.factorization import banded_inverted_solve, packed_of
from . import _build
from .trsm import _as_matrix, _check_cuda, _f32

__all__ = [
    "banded_lu_blocked", "banded_lu_tiled", "banded_solve_kernelized", "banded_solve_inverted",
    "banded_lu_plain", "tiled_launches",
]

_WARP_COLS = 32  # RHS columns (one warp each) a banded_solve_kernelized block takes at most


def _launch(wrapper, fn_name: str, device, *args) -> None:
    lib = _build.library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream,
                                     ctypes.byref(launched))
    wrapper.launches += launched.value
    _build.check(code, fn_name)


def _band_copy(name: str, arow: torch.Tensor, bw: int) -> torch.Tensor:
    """A contiguous fp32 copy of the band on the card, for the kernel to
    factor in place."""
    if bw < 1 or arow.ndim != 2 or arow.shape[1] != 2 * bw + 1:
        raise ValueError(f"{name} expects a row-aligned band (n, 2bw+1) with bw >= 1, got "
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


def tiled_launches(n: int, bw: int, block: int | None = None) -> int:
    """Launches :func:`banded_lu_tiled` should make: one per block step."""
    return -(-n // band_block_size(n, bw, block))


def banded_lu_blocked(arow: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Packed no-pivot LU of the row-aligned band ``(n, 2bw+1)`` in one
    launch.  ``block`` sets the plain version's window; the kernel stages
    as many rows as shared memory holds, which gives the same factor."""
    if arow.device.type == "cpu":
        return banded_lu_plain(arow, bw=bw, block=block)
    work = _band_copy("banded_lu_blocked", arow, bw)
    _launch(banded_lu_blocked, "ebv_band_lu_resident", arow.device, work.data_ptr(),
            work.shape[0], bw)
    return work


banded_lu_blocked.launches = 0


def banded_lu_tiled(arow: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Packed no-pivot LU of the row-aligned band in ``ceil(n/C)``
    launches, one per block step of ``C = band_block_size(n, bw, block)``
    pivots, in stream order."""
    if arow.device.type == "cpu":
        return banded_lu_plain(arow, bw=bw, block=block)
    work = _band_copy("banded_lu_tiled", arow, bw)
    n = work.shape[0]
    _launch(banded_lu_tiled, "ebv_band_lu_steps", arow.device, work.data_ptr(), n, bw,
            band_block_size(n, bw, block))
    return work


banded_lu_tiled.launches = 0


# ---------------------------------------------------------------------------
# band solves
# ---------------------------------------------------------------------------
def banded_solve_kernelized(lu_band, b: torch.Tensor, *, bw: int, block: int | None = None,
                            rhs_tile: int = 256) -> torch.Tensor:
    """Solve ``(LU) x = b`` on packed band factors ``(n, 2bw+1)``, ``b``
    ``(n,)`` or ``(n, m)``, in the RHS dtype.  On the card one warp sweeps
    each RHS column; a block takes an equal tile of at most
    ``min(rhs_tile, 32)`` columns.  ``block`` sets the plain version's
    blocking."""
    lu_band = packed_of(lu_band)
    if lu_band.device.type == "cpu":
        return banded_solve_blocked(lu_band, b, bw=bw, block=block)
    _check_cuda("banded_solve_kernelized", lu_band, b)
    bm, squeeze = _as_matrix(b)
    n, m = bm.shape
    if bw < 1 or lu_band.shape != (n, 2 * bw + 1):
        raise ValueError(f"banded_solve_kernelized: factors {tuple(lu_band.shape)} do not match "
                         f"n={n}, bw={bw}")
    if m == 0:  # no column to solve: nothing to launch
        return torch.empty_like(b)
    rt = max(1, min(rhs_tile, m, _WARP_COLS))
    rt = -(-m // (-(-m // rt)))  # equal tiles
    lu32, b32 = _f32(lu_band, "banded_solve_kernelized"), _f32(bm, "banded_solve_kernelized")
    x = torch.empty_like(b32)
    _launch(banded_solve_kernelized, "ebv_band_solve", lu_band.device, lu32.data_ptr(),
            b32.data_ptr(), x.data_ptr(), n, bw, m, rt)
    x = x.to(bm.dtype)
    return x[:, 0] if squeeze else x


banded_solve_kernelized.launches = 0


def banded_solve_inverted(linv: torch.Tensor, uinv: torch.Tensor, tlo: torch.Tensor,
                          tup: torch.Tensor, b: torch.Tensor, *, n: int, bw: int) -> torch.Tensor:
    """Solve ``(LU) x = b`` from an enriched banded ``Factorization``: the
    ``(S, C, C)`` inverses ``linv``/``uinv`` and ``(S, C, bw)`` transfer
    blocks ``tlo``/``tup``.  Each sweep is a batched product over all ``S``
    blocks, the ``(bw, m)`` tail recurrence and a second batched product."""
    if linv.device.type == "cpu":
        return banded_inverted_solve(linv, uinv, tlo, tup, b, n=n, bw=bw)
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
            z.data_ptr(), y.data_ptr(), t.data_ptr(), S, C, bw, m)
    x = out[:n].to(bm.dtype)
    return x[:, 0] if squeeze else x


banded_solve_inverted.launches = 0
