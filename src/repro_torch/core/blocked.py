"""Blocked (rank-k) EbV LU and the plain version of the fused factor.

The paper's rank-1 updates have O(1) FLOP/byte intensity.  Blocking keeps
its two invariants: the pivot-scaled L-column block and the U-row block of
a step are computed together and consumed by one rank-``b`` update, and the
owner schedules (:func:`ebv_folded_owners`) pair wide early panels with
narrow late panels so per-executor work is equal.

:func:`fused_blocked_lu` is the plain PyTorch version of the CUDA factor
``repro_torch.kernels.ebv_lu.lu_fused``: same padding, same block size,
same result to fp32 round-off (not the same operation order).
"""
from __future__ import annotations

import torch

from .nonfinite import nan_above_last, nan_below_first, nan_left_of_last
from .solve import unit_lower_solve_packed

__all__ = [
    "panel_factor",
    "blocked_lu",
    "fused_blocked_lu",
    "fused_lu_steps",
    "fused_block_size",
    "sub_block_width",
    "strip_trsm",
    "strip_utrsm",
    "factor_diag_strip",
    "solve_below_strip",
    "pad_identity_tail",
    "ebv_folded_owners",
    "cyclic_owners",
    "FACTOR_SMEM_BYTES",
]

# Dynamic shared memory one H100 block may use (232,448 bytes):
# fused_block_size keeps a (B, B+1) fp32 tile within it, the rule of the
# port's first CUDA factor, which still pins the plain version's B.
FACTOR_SMEM_BYTES = 232_448


def sub_block_width(block: int) -> int:
    """Strip width of the two-level (axpy-in-strip, GEMM-retire) panel and
    trsm scheme of :func:`fused_lu_steps`."""
    return next((c for c in (32, 16, 8) if block % c == 0), block)


def pad_identity_tail(a: torch.Tensor, n_to: int) -> torch.Tensor:
    """Embed square ``a`` (or each of a ``(..., n, n)`` stack) in an
    (n_to, n_to) tensor with an identity tail — inert under no-pivot
    elimination and substitution (unit pivots, zero coupling).  Returns
    ``a`` itself when no padding is needed."""
    n = a.shape[-1]
    if n_to == n:
        return a
    out = torch.zeros((*a.shape[:-2], n_to, n_to), dtype=a.dtype, device=a.device)
    out[..., :n, :n] = a
    idx = torch.arange(n, n_to, device=a.device)
    out[..., idx, idx] = 1
    return out


def strip_trsm(ldiag: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Unit-lower solve of a ``(C2, w)`` strip against the ``(C2, C2)``
    diagonal block, as a sequential axpy recurrence; a non-finite ``u[k]``
    turns NaN the strip's rows at or above it, as the reference's masked
    recurrence does.  Returns a new tensor."""
    u = rhs.clone()
    c2 = ldiag.shape[-1]
    for k in range(c2 - 1):
        u[..., k + 1:, :] -= ldiag[..., k + 1:, k:k + 1] * u[..., k:k + 1, :]
    return nan_above_last(u, c2 - 1)


def strip_utrsm(udiag: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Upper-triangular solve (diagonal division included) of a ``(C2, w)``
    strip against the ``(C2, C2)`` diagonal block — the backward twin of
    :func:`strip_trsm` (a non-finite ``x[k]`` turns NaN the strip's rows at
    or below it).  Returns a new tensor."""
    x = rhs.clone()
    for k in range(udiag.shape[-1] - 1, -1, -1):
        x[..., k:k + 1, :] /= udiag[..., k:k + 1, k:k + 1]
        x[..., :k, :] -= udiag[..., :k, k:k + 1] * x[..., k:k + 1, :]
    return nan_below_first(x)


def factor_diag_strip(dblk: torch.Tensor, j: int) -> torch.Tensor:
    """Bi-vectorized (rank-1) factorization of the ``(B, C2)`` diagonal-block
    strip whose pivot rows start at local row ``j``; rows at or above each
    pivot row hold final U values and are left alone, except that, as in
    the reference's masked steps, a non-finite pivot-row entry turns NaN the
    rows above it and a non-finite multiplier the strip's columns left of
    it."""
    d = dblk.clone()
    b, c2 = d.shape
    for k in range(c2):
        p = j + k
        d[p + 1:, k] /= d[p, k]
        d[p + 1:, k + 1:] -= d[p + 1:, k:k + 1] * d[p:p + 1, k + 1:]
    rows = torch.arange(b, device=d.device)[:, None]
    cols = torch.arange(c2, device=d.device)[None, :]
    out = nan_left_of_last(d, rows > j + cols)
    # rows 0..j+k of column c > k, for the last such k whose pivot-row entry is not finite
    piv = torch.zeros_like(d, dtype=torch.bool)
    piv[j:j + c2] = ~torch.isfinite(d[j:j + c2]) & (cols[:, :c2] > rows[:c2])
    bad = piv.flip(0).cummax(0).values.flip(0)
    return out.masked_fill(bad, float("nan"))


def solve_below_strip(diag: torch.Tensor, strip: torch.Tensor, j: int) -> torch.Tensor:
    """Multipliers of a below-diagonal ``(B, C2)`` strip: right-solve against
    the factored diagonal strip (every row lies below the pivots); a
    non-finite multiplier turns NaN the strip's columns left of it, as the
    reference's masked steps do."""
    st = strip.clone()
    for k in range(st.shape[1]):
        p = j + k
        st[:, k] /= diag[p, k]
        st[:, k + 1:] -= st[:, k:k + 1] * diag[p:p + 1, k + 1:]
    return nan_left_of_last(st, torch.ones((), dtype=torch.bool, device=st.device))


def fused_block_size(n: int, block: int) -> int:
    """Effective block size ``B`` of the fused factor for an (n, n) matrix.

    * **padding**: the factor pads n up to ``S·B``; for n just above a
      block multiple (n=257, block=256) that nearly doubles the matrix.  At
      the same step count ``S``, ``B = ceil(n/S)`` rounded up to a 32
      multiple pads least — pick whichever candidate pads less.
    * **the card**: ``B`` is halved until ``B·(B+1)·4`` bytes fit the
      227 KB one Hopper block can address (256 → 128; 224 fits), so
      ``B = 128`` at the paper's dense sizes: the rule of the port's first
      CUDA factor, which held the diagonal tile there.  It now fixes only
      this plain version's blocking; the CUDA factor pads nothing and
      steps by its own width (``kernels/ebv_lu.py:fused_step_width``).
    """
    B = min(block, n)
    S = -(-n // B)
    balanced = min(block, -(-(-(-n // S)) // 32) * 32)  # ceil(n/S) up to a 32-multiple
    if balanced >= 32 and -(-n // balanced) * balanced < S * B:
        B = balanced
    while B > 32 and B * (B + 1) * 4 > FACTOR_SMEM_BYTES:
        B = max(32, B // 2)
    return B


def panel_factor(panel: torch.Tensor) -> torch.Tensor:
    """Unblocked bi-vectorized LU of a tall ``(m, b)`` panel (pivots in the
    top ``b`` rows, no pivoting — paper contract)."""
    p = panel.clone()
    for k in range(p.shape[1]):
        p[k + 1:, k] /= p[k, k]
        p[k + 1:, k + 1:] -= p[k + 1:, k:k + 1] * p[k:k + 1, k + 1:]
    return p


def blocked_lu(a: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Right-looking blocked EbV LU on a packed square tensor."""
    a = a.clone()
    n = a.shape[-1]
    block = min(block, n)
    for k0 in range(0, n, block):
        b = min(block, n - k0)
        panel = panel_factor(a[k0:, k0:k0 + b])
        a[k0:, k0:k0 + b] = panel
        if k0 + b < n:
            # fused bi-vector step: U-row block via trsm against the
            # unit-lower panel factor, consumed at once by the rank-b update
            u12 = unit_lower_solve_packed(panel[:b], a[k0:k0 + b, k0 + b:])
            a[k0:k0 + b, k0 + b:] = u12
            a[k0 + b:, k0 + b:] -= panel[b:] @ u12
    return a


def fused_lu_steps(a: torch.Tensor, *, block: int, num_steps: int) -> torch.Tensor:
    """Body of the fused blocked LU on an already-padded ``(S·B, S·B)``
    tensor, updated in place and returned: per step a two-level panel
    factorization (rank-1 loop in ``C2``-wide strips, strip trsm, rank-C2
    retirement per row block), then per trailing tile a two-level
    unit-lower trsm and the rank-B update per row block.

    ``csrc/nonfinite.cuh:lu_replay_kernel`` replays this loop's blocking on
    the CUDA factor's result to spread NaN as these masked strips do: a
    change to the loop needs the same change there (the CPU emulation
    ``tests/test_torch_nonfinite.py:lu_replay`` fails until both agree)."""
    B, S = block, num_steps
    C2 = sub_block_width(B)
    for s in range(S):
        base = s * B
        end = base + B
        for j in range(0, B, C2):
            r0 = base + j
            w = B - j - C2
            diag = factor_diag_strip(a[base:end, r0:r0 + C2], j)
            a[base:end, r0:r0 + C2] = diag
            if w:
                u = strip_trsm(diag[j:j + C2], a[r0:r0 + C2, r0 + C2:end])
                a[r0:r0 + C2, r0 + C2:end] = u
                a[r0 + C2:end, r0 + C2:end] -= diag[j + C2:] @ u
            for r in range(s + 1, S):
                off = r * B
                strip = solve_below_strip(diag, a[off:off + B, r0:r0 + C2], j)
                a[off:off + B, r0:r0 + C2] = strip
                if w:
                    a[off:off + B, r0 + C2:end] -= strip @ u
        for t in range(s + 1, S):
            tb = t * B
            y = a[base:end, tb:tb + B].clone()
            for j in range(0, B, C2):
                r0 = base + j
                y[j:j + C2] = strip_trsm(a[r0:r0 + C2, r0:r0 + C2], y[j:j + C2])
                if B - j - C2:
                    y[j + C2:] -= a[r0 + C2:end, r0:r0 + C2] @ y[j:j + C2]
            a[base:end, tb:tb + B] = y
            for r in range(s + 1, S):
                off = r * B
                a[off:off + B, tb:tb + B] -= a[off:off + B, base:end] @ y
    return a


def fused_blocked_lu(a: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Plain PyTorch version of the CUDA factor
    (:func:`repro_torch.kernels.ebv_lu.lu_fused`): pad to ``S·B`` with an
    identity tail, run :func:`fused_lu_steps`, cut the padding off.  Never
    mutates ``a``."""
    n = a.shape[-1]
    B = fused_block_size(n, block)
    S = -(-n // B)
    N = S * B
    work = pad_identity_tail(a, N)
    if work is a:
        work = a.clone()
    work = fused_lu_steps(work, block=B, num_steps=S)
    return work[:n, :n].contiguous() if N != n else work


def cyclic_owners(num_blocks: int, num_executors: int) -> list[int]:
    """Standard block-cyclic owner schedule (ScaLAPACK-style baseline)."""
    return [k % num_executors for k in range(num_blocks)]


def ebv_folded_owners(num_blocks: int, num_executors: int) -> list[int]:
    """EbV-folded owner schedule: panels ``k`` and ``nb-1-k`` (whose trailing
    work sums to a constant) go to the same executor."""
    return [min(k, num_blocks - 1 - k) % num_executors for k in range(num_blocks)]
