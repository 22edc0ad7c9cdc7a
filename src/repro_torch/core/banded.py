"""Banded ("sparse") EbV LU.

The paper's sparse matrices come from CFD stencils — banded systems.  For a
bandwidth-``bw`` matrix every elimination bi-vector has length exactly
``bw``: the vectors are *naturally equalized*, the EbV ideal case.

Storage is row-aligned band form: ``arow[i, t] = A[i, i - bw + t]`` for
``t ∈ [0, 2bw]`` (zero outside the matrix).  Factorization costs
O(n·bw²) instead of O(n³).

Two realizations live here:

* the scalar-sequential path (:func:`banded_lu` / :func:`banded_solve`):
  one step per elimination row — the paper-faithful loop.
* the **blocked** path (:func:`banded_lu_blocked` /
  :func:`banded_solve_blocked`): ``C`` pivot rows retired per step through a
  dense ``(C+bw, C+bw)`` working *window*.  The band is first re-laid into a
  window-aligned skewed form (:func:`band_to_skewed`) in which every window
  assembles from two static slices, and each bi-vector elimination inside
  the window is confined to the ``(bw+1, bw+1)`` sub-block the band can
  reach.  These are the plain PyTorch versions of the CUDA kernels in
  :mod:`repro_torch.kernels.banded`.

Every elimination applies the same scalar operations to each band entry
(``l = a / pivot``, ``a - l·u``) in the same pivot order whatever the
block size, so the packed factor does not depend on ``C``: the scalar, the
blocked and the kernel factors agree up to fused multiply-adds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import device as _device
from .blocked import strip_trsm, strip_utrsm, sub_block_width

__all__ = [
    "to_banded",
    "from_banded",
    "banded_lu",
    "banded_solve",
    "banded_lu_solve",
    "make_banded_dd",
    "band_block_size",
    "pad_band_identity",
    "band_to_skewed",
    "skewed_to_band",
    "skew_rows",
    "skew_pad",
    "band_window_from_slabs",
    "factor_band_window",
    "band_step_slabs",
    "band_step_writeback",
    "band_block_step",
    "unit_lower_window_solve",
    "upper_window_solve",
    "banded_lu_blocked",
    "banded_solve_blocked",
    "banded_linear_solve_blocked",
]


def _band_cols(n: int, bw: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Column index ``j = i - bw + t`` of every band cell and whether it
    lies inside the matrix."""
    i = torch.arange(n, device=device)[:, None]
    t = torch.arange(2 * bw + 1, device=device)[None, :]
    j = i - bw + t
    return j, (j >= 0) & (j < n)


def to_banded(a: torch.Tensor, bw: int) -> torch.Tensor:
    """Dense (n, n) → row-aligned band (n, 2bw+1)."""
    n = a.shape[-1]
    j, valid = _band_cols(n, bw, a.device)
    i = torch.arange(n, device=a.device)[:, None]
    return torch.where(valid, a[i, j.clamp(0, n - 1)], torch.zeros((), dtype=a.dtype, device=a.device))


def from_banded(arow: torch.Tensor) -> torch.Tensor:
    """Row-aligned band (n, 2bw+1) → dense (n, n)."""
    n, w = arow.shape
    bw = (w - 1) // 2
    j, valid = _band_cols(n, bw, arow.device)
    i = torch.arange(n, device=arow.device)[:, None].expand(n, w)
    dense = torch.zeros((n, n), dtype=arow.dtype, device=arow.device)
    dense[i[valid], j[valid]] = arow[valid]
    return dense


def banded_lu(arow: torch.Tensor, *, bw: int) -> torch.Tensor:
    """No-pivot LU on the row-aligned band, one pivot row at a time; factors
    packed in place (``L`` strictly left of the centre column, unit
    diagonal implicit).  Returns a new tensor."""
    n, w = arow.shape
    dev = arow.device
    ap = torch.cat([arow, torch.zeros((bw, w), dtype=arow.dtype, device=dev)])
    # row offset s of the window touches band columns bw+1-s .. 2bw-s, which
    # consume the pivot row's upper tail u[c - (bw+1-s)]
    s = torch.arange(1, bw + 1, device=dev)[:, None]
    src = torch.arange(w, device=dev)[None, :] - (bw + 1 - s)
    valid = (src >= 0) & (src < bw)
    src = src.clamp(0, bw - 1)
    anti = (torch.arange(bw, device=dev), bw - 1 - torch.arange(bw, device=dev))
    for k in range(n - 1):
        window = ap[k + 1:k + 1 + bw]  # rows k+1 .. k+bw (a view)
        l = window[anti] / ap[k, bw]   # the L column lies on the anti-diagonal
        u_tail = ap[k, bw + 1:]
        window -= l[:, None] * torch.where(valid, u_tail[src], torch.zeros((), dtype=ap.dtype, device=dev))
        window[anti] = l
    return ap[:n]


def banded_solve(lu_band, b: torch.Tensor, *, bw: int) -> torch.Tensor:
    """Forward + backward substitution on the packed band factors, one row
    at a time.  ``b`` is a vector."""
    lu_band = getattr(lu_band, "packed", lu_band)
    n = lu_band.shape[0]
    ypad = torch.cat([torch.zeros(bw, dtype=b.dtype, device=b.device), b])
    for i in range(n):  # y_i = b_i − Σ_t L[i, i-bw+t] · y_{i-bw+t}
        ypad[i + bw] = ypad[i + bw] - lu_band[i, :bw] @ ypad[i:i + bw]
    xpad = torch.cat([ypad[bw:], torch.zeros(bw, dtype=b.dtype, device=b.device)])
    for i in range(n - 1, -1, -1):  # x_i = (y_i − Σ_t U[i, i+t] · x_{i+t}) / U[i, i]
        xpad[i] = (xpad[i] - lu_band[i, bw + 1:] @ xpad[i + 1:i + 1 + bw]) / lu_band[i, bw]
    return xpad[:n]


def banded_lu_solve(arow: torch.Tensor, b: torch.Tensor, *, bw: int) -> torch.Tensor:
    return banded_solve(banded_lu(arow, bw=bw), b, bw=bw)


# ---------------------------------------------------------------------------
# blocked band path — shared helpers
# ---------------------------------------------------------------------------
def make_banded_dd(generator, n: int, bw: int, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Diagonally dominant row-aligned band, built directly in band form (no
    dense ``(n, n)`` detour).  ``generator`` is a ``torch.Generator`` or an
    int seed; the band lies on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = _device.resolve(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    w = 2 * bw + 1
    a = torch.rand((n, w), generator=generator, dtype=torch.float32, device=generator.device)
    a = (a * 2.0 - 1.0).to(dev)
    _, valid = _band_cols(n, bw, dev)
    a = torch.where(valid, a, torch.zeros((), device=dev))
    a[:, bw] = a.abs().sum(dim=1) - a[:, bw].abs() + 1.0
    return a.to(dtype)


def band_block_size(n: int, bw: int, block: int | None = None) -> int:
    """Pivot rows ``C`` retired per blocked band step: ``C ≈ 8·bw`` clamped
    to [32, 256], at least ``bw`` (a step's ``bw`` carry rows never span
    more than one following block — the skewed layout's contract) and at
    most ``n`` (bw ≥ n is one step).  It fixes the artifact's layout, so it
    is the reference's integer."""
    if block is None:
        block = max(32, min(256, 8 * bw))
    return min(max(block, bw), n)


def pad_band_identity(arow: torch.Tensor, bw: int, rows_to: int) -> torch.Tensor:
    """Pad the band with identity rows (centre 1, zero coupling) — inert
    under no-pivot elimination and substitution.  Returns ``arow`` itself
    when no padding is needed."""
    n, w = arow.shape
    if rows_to == n:
        return arow
    pad = torch.zeros((rows_to - n, w), dtype=arow.dtype, device=arow.device)
    pad[:, bw] = 1
    return torch.cat([arow, pad])


def band_to_skewed(ap: torch.Tensor, bw: int, block: int) -> torch.Tensor:
    """Re-lay the row-aligned band ``(R, 2bw+1)`` (``R`` a multiple of
    ``block``) into the window-aligned skewed form ``G`` ``(R, C+2bw)``:
    ``G[i, c] = A[i, k(i) - bw + c]`` with ``k(i) = (i // C)·C``.

    Shifting row ``r0`` of a block right by ``r0`` is the identity on
    flattened indices once rows are padded to width ``C+2bw+1``: one pad,
    two reshapes and one slice.  Pure data movement, so exact."""
    r, w = ap.shape
    c = block
    gw = c + 2 * bw
    padded = F.pad(ap.reshape(r // c, c, w), (0, gw + 1 - w))
    flat = padded.reshape(r // c, c * (gw + 1))[:, :c * gw]
    return flat.reshape(r, gw)


def skewed_to_band(g: torch.Tensor, bw: int, block: int) -> torch.Tensor:
    """Inverse of :func:`band_to_skewed`: skewed ``(R, C+2bw)`` →
    row-aligned band ``(R, 2bw+1)``."""
    r, gw = g.shape
    c = block
    w = 2 * bw + 1
    flat = F.pad(g.reshape(r // c, c * gw), (0, c))
    return flat.reshape(r // c, c, gw + 1)[:, :, :w].reshape(r, w)


def band_window_from_slabs(own: torch.Tensor, carry: torch.Tensor, bw: int) -> torch.Tensor:
    """The dense ``(C+bw, C+bw)`` working window of one block step from its
    two skewed slabs: ``own`` ``(C, C+2bw)`` (the step's own rows) and
    ``carry`` (the next block's first ``bw`` rows — ``(bw, 2bw)`` when
    ``C ≥ bw``, ``(bw, C+bw)`` sliced at column ``bw-C`` otherwise)."""
    c = own.shape[0]
    top = own[:, bw:]
    if c >= bw:
        bot = torch.cat([torch.zeros((bw, c - bw), dtype=own.dtype, device=own.device), carry], dim=1)
    else:
        bot = carry
    return torch.cat([top, bot])


def factor_band_window(window: torch.Tensor, npiv: int, bw: int) -> torch.Tensor:
    """No-pivot LU of the dense band window ``(npiv+bw, npiv+bw)``, retiring
    pivots ``0..npiv-1``, each bi-vector elimination confined to the
    ``(bw+1, bw+1)`` block the band reaches.  Returns a new tensor."""
    wnd = window.clone()
    for p in range(npiv):
        blk = wnd[p:p + bw + 1, p:p + bw + 1]
        l_col = blk[1:, :1] / blk[:1, :1]
        blk[1:, 1:] -= l_col * blk[:1, 1:]  # rank-1 Schur update on the reachable block
        blk[1:, :1] = l_col
    return wnd


def unit_lower_window_solve(lwin: torch.Tensor, y: torch.Tensor, bw: int) -> torch.Tensor:
    """Blocked forward substitution against the packed in-block window
    (unit-lower L strictly below the diagonal): per ``C2`` strip a short
    axpy recurrence (:func:`~repro_torch.core.blocked.strip_trsm`), then
    one rank-``C2`` product retiring the ``bw`` rows the band couples.
    Returns a new tensor."""
    y = y.clone()
    c = lwin.shape[0]
    c2 = sub_block_width(c)
    for j in range(0, c, c2):
        strip = strip_trsm(lwin[j:j + c2, j:j + c2], y[j:j + c2])
        y[j:j + c2] = strip
        hr = min(bw, c - j - c2)
        if hr > 0:
            y[j + c2:j + c2 + hr] -= lwin[j + c2:j + c2 + hr, j:j + c2] @ strip
    return y


def upper_window_solve(uwin: torch.Tensor, x: torch.Tensor, bw: int) -> torch.Tensor:
    """Blocked backward substitution against the packed in-block window (U
    on and above the diagonal), :func:`unit_lower_window_solve` bottom-up
    with :func:`~repro_torch.core.blocked.strip_utrsm` strips.  Returns a
    new tensor."""
    x = x.clone()
    c = uwin.shape[0]
    c2 = sub_block_width(c)
    for j in range(c - c2, -1, -c2):
        strip = strip_utrsm(uwin[j:j + c2, j:j + c2], x[j:j + c2])
        x[j:j + c2] = strip
        hr = min(bw, j)
        if hr > 0:
            x[j - hr:j] -= uwin[j - hr:j, j:j + c2] @ strip
    return x


# ---------------------------------------------------------------------------
# blocked band drivers — plain versions of the CUDA kernels
# ---------------------------------------------------------------------------
def skew_rows(n: int, bw: int, block: int) -> int:
    """Padded row count of the skewed band: a whole number of blocks plus
    enough carry blocks for the last step's ``bw`` overhang."""
    s = -(-n // block)
    return (s + max(1, -(-bw // block))) * block


def skew_pad(arow: torch.Tensor, bw: int, block: int) -> tuple[torch.Tensor, int]:
    """Identity-pad the band to :func:`skew_rows` rows and re-lay it into
    the skewed form.  Returns ``(G, num_steps)``; ``G`` never shares memory
    with ``arow``."""
    n = arow.shape[0]
    ap = pad_band_identity(arow, bw, skew_rows(n, bw, block))
    return band_to_skewed(ap, bw, block).contiguous(), -(-n // block)


def band_step_slabs(g: torch.Tensor, k: int, *, block: int, bw: int):
    """One block step's (own, carry) slabs of the skewed band at row ``k``."""
    c = block
    own = g[k:k + c]
    if c >= bw:
        carry = g[k + c:k + c + bw, :2 * bw]
    else:
        carry = g[k + c:k + c + bw, bw - c:2 * bw]
    return own, carry


def band_step_writeback(g: torch.Tensor, window: torch.Tensor, k: int, *, block: int, bw: int):
    """Write a factored window back into the skewed band, in place: the
    step's own ``C`` rows are final; its ``bw`` carry rows flow into the
    next block's leading columns."""
    c = block
    g[k:k + c, bw:] = window[:c]
    if c >= bw:
        g[k + c:k + c + bw, :2 * bw] = window[c:, c - bw:]
    else:
        g[k + c:k + c + bw, bw - c:2 * bw] = window[c:]
    return g


def band_block_step(g: torch.Tensor, k: int, *, block: int, bw: int) -> torch.Tensor:
    """One blocked band LU step on the skewed band, in place: assemble the
    dense window from two slices, retire ``C`` pivots, write back."""
    own, carry = band_step_slabs(g, k, block=block, bw=bw)
    window = factor_band_window(band_window_from_slabs(own, carry, bw), block, bw)
    return band_step_writeback(g, window, k, block=block, bw=bw)


def banded_lu_blocked(arow: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Blocked no-pivot band LU: ``C`` rows retired per step through the
    dense band window on the skewed layout.  Plain version of the CUDA
    factors :func:`repro_torch.kernels.banded.banded_lu_blocked` and
    :func:`~repro_torch.kernels.banded.banded_lu_tiled`.  Never mutates
    ``arow``."""
    n = arow.shape[0]
    c = band_block_size(n, bw, block)
    g, s = skew_pad(arow, bw, c)
    for i in range(s):
        band_block_step(g, i * c, block=c, bw=bw)
    return skewed_to_band(g, bw, c)[:n]


def banded_solve_blocked(lu_band, b: torch.Tensor, *, bw: int, block: int | None = None) -> torch.Tensor:
    """Blocked forward + backward substitution on the packed band factors:
    per block one coupling product against the ``bw`` solved rows above
    (below), then the in-block window solve.  Plain version of the CUDA
    solve :func:`repro_torch.kernels.banded.banded_solve_kernelized`."""
    lu_band = getattr(lu_band, "packed", lu_band)
    n = lu_band.shape[0]
    squeeze = b.ndim == 1
    bm = b[:, None] if squeeze else b
    m = bm.shape[1]
    c = band_block_size(n, bw, block)
    s = -(-n // c)
    np_rows = s * c
    # each block's coupling strip F (C, C+2bw) is one row slice of the
    # skewed factors: F[:, :bw] couples to the rows above, F[:, bw:bw+C] is
    # the in-block packed L/U window, F[:, bw+C:] couples to the rows below
    g = band_to_skewed(pad_band_identity(lu_band, bw, np_rows), bw, c)
    # x carries bw zero margin rows on both ends (rows [bw, bw+n) are real)
    xp = torch.zeros((bw + np_rows + bw, m), dtype=bm.dtype, device=bm.device)
    xp[bw:bw + n] = bm
    for i in range(s):
        k = i * c
        f = g[k:k + c]
        yblk = xp[bw + k:bw + k + c] - f[:, :bw] @ xp[k:k + bw]
        xp[bw + k:bw + k + c] = unit_lower_window_solve(f[:, bw:bw + c], yblk, bw)
    for i in range(s - 1, -1, -1):
        k = i * c
        f = g[k:k + c]
        xblk = xp[bw + k:bw + k + c] - f[:, bw + c:] @ xp[bw + k + c:bw + k + c + bw]
        xp[bw + k:bw + k + c] = upper_window_solve(f[:, bw:bw + c], xblk, bw)
    x = xp[bw:bw + n]
    return x[:, 0] if squeeze else x


def banded_linear_solve_blocked(arow: torch.Tensor, b: torch.Tensor, *, bw: int,
                                block: int | None = None) -> torch.Tensor:
    """Factor + solve through the blocked paths."""
    return banded_solve_blocked(banded_lu_blocked(arow, bw=bw, block=block), b, bw=bw, block=block)
