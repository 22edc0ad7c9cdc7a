"""Paper-faithful "Equal bi-Vectorized" (EbV) LU decomposition.

The paper (Hashemi/Lahooti/Shirani 2019) factorizes a diagonally-dominant
matrix without pivoting.  At elimination step ``r`` the *bi-vector* is the
pair (L-column ``A[r+1:, r]``, U-row ``A[r, r+1:]``): both are scaled by the
pivot and consumed by one rank-1 Schur update (paper eqs. 6-a..6-c).  The
paper *equalizes* work units by pairing vector ``r`` with vector ``n-2-r``
(eqs. 7-a..7-e) so every unit has total length ``n``.

The packed format is Doolittle: ``L`` strictly below the diagonal with an
implicit unit diagonal, ``U`` on and above the diagonal.
"""
from __future__ import annotations

import torch

from .. import device as _device
from .nonfinite import lu_spread

__all__ = [
    "ebv_lu",
    "ebv_step",
    "equalized_pairing",
    "pair_lengths",
    "fold_index",
    "equalized_tile_schedule",
    "tile_schedule_work",
    "unpack_lu",
    "reconstruct",
    "make_diagonally_dominant",
]


def equalized_pairing(n: int) -> list[tuple[int, ...]]:
    """Pair elimination vectors ``r`` and ``n-2-r`` (paper eq. 7).

    Vector ``r`` (``0 <= r <= n-2``) has length ``n-1-r``.  Pairing first
    with last gives units of equal total length ``n``.  With an odd number
    of vectors the middle one forms a singleton unit.
    """
    if n < 2:
        return []
    pairs: list[tuple[int, ...]] = []
    lo, hi = 0, n - 2
    while lo < hi:
        pairs.append((lo, hi))
        lo += 1
        hi -= 1
    if lo == hi:
        pairs.append((lo,))
    return pairs


def pair_lengths(n: int) -> list[int]:
    """Total element count of each equalized work unit (all ``n`` except a
    possible middle singleton)."""
    return [sum(n - 1 - r for r in unit) for unit in equalized_pairing(n)]


def fold_index(i, count):
    """Fold ``i`` from the two ends towards the middle:
    ``0, 1, 2, ... -> 0, count-1, 1, count-2, ...``.  Works on Python ints
    and integer tensors."""
    half = (i + 1) // 2
    if isinstance(i, int):
        return half if i % 2 == 0 else count - half
    return torch.where(i % 2 == 0, half, count - half)


def equalized_tile_schedule(num_steps: int) -> list[tuple[int, ...]]:
    """Equalized owner schedule of the blocked LU: program ``p`` owns the
    trailing tiles ``p+1`` and ``num_steps-1-p``, whose lifetime work sums to
    the constant ``num_steps`` (paper eq. 7 with tiles in place of vectors).
    With an odd tile count the middle tile forms a singleton unit.

    The CUDA factor launches one grid per step, where every block of a
    launch already has equal work, so it does not consume this schedule; a
    persistent executor would (see ``kernels/ebv_lu.py``)."""
    return [
        tuple(sorted(num_steps - 1 - r for r in unit))
        for unit in equalized_pairing(num_steps)
    ]


def tile_schedule_work(num_steps: int) -> list[int]:
    """Lifetime work per program of :func:`equalized_tile_schedule` —
    equals :func:`pair_lengths`."""
    return [sum(unit) for unit in equalized_tile_schedule(num_steps)]


def ebv_step(a: torch.Tensor, k: int) -> torch.Tensor:
    """One bi-vectorized elimination step on the packed array (paper eqs.
    6-a..6-c): scale the L-column by the pivot, take the U-row, apply one
    rank-1 Schur update and store the scaled column.  Written as the
    reference's fixed-shape masked update, so a non-finite entry of the
    bi-vector turns NaN the rows above its U entry and the columns left of
    its multiplier.  Returns a new tensor."""
    rows = torch.arange(a.shape[-2], device=a.device)[:, None]
    cols = torch.arange(a.shape[-1], device=a.device)[None, :]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    col = a[:, k:k + 1]
    l_col = torch.where(rows > k, col / a[k, k], zero)
    a = a - l_col * torch.where(cols > k, a[k:k + 1, :], zero)
    a[:, k:k + 1] = torch.where(rows > k, l_col, a[:, k:k + 1])
    return a


def ebv_lu(a: torch.Tensor) -> torch.Tensor:
    """Unblocked paper-faithful EbV LU (no pivoting); returns the packed LU.
    The steps update the live rows only; the NaN the reference's masked
    steps spread from a non-finite entry are added after them
    (:func:`~repro_torch.core.nonfinite.lu_spread`)."""
    a = a.clone()
    for k in range(a.shape[-1] - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= a[k + 1:, k:k + 1] * a[k:k + 1, k + 1:]
    return lu_spread(a)


def unpack_lu(lu) -> tuple[torch.Tensor, torch.Tensor]:
    """Split the packed array into explicit (L, U) with unit diagonal on L."""
    lu = getattr(lu, "packed", lu)  # accept Factorization artifacts
    eye = torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device)
    return torch.tril(lu, -1) + eye, torch.triu(lu)


def reconstruct(lu) -> torch.Tensor:
    """``L @ U`` from the packed factorization (testing/validation)."""
    l, u = unpack_lu(lu)
    return l @ u


def make_diagonally_dominant(generator, n: int, dtype=torch.float32, *,
                             sparse_band: int | None = None, device=None) -> torch.Tensor:
    """Test matrix of the paper's contract: uniform(-1, 1) entries with the
    diagonal set to the absolute row sum plus one (strict row-wise
    diagonal dominance).  ``sparse_band`` limits the off-diagonal support to
    a band.

    ``generator`` is a ``torch.Generator`` or an int seed.  The matrix is
    drawn on the generator's device and placed on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = _device.resolve(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    a = torch.rand((n, n), generator=generator, dtype=torch.float32,
                   device=generator.device) * 2.0 - 1.0
    a = a.to(dev)
    if sparse_band is not None:
        i = torch.arange(n, device=dev)
        a = a * ((i[:, None] - i[None, :]).abs() <= sparse_band)
    idx = torch.arange(n, device=dev)
    a[idx, idx] = a.abs().sum(dim=-1) + 1.0
    return a.to(dtype)
