"""Pure oracles for the dense (fused and legacy), banded and batched
kernels (numpy float64, loop-level naive).

Deliberately the dumbest correct implementations — independent of both
the CUDA kernels and the vectorized :mod:`repro_torch.core` paths — so the
tests anchor three implementations against each other.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lu_ref", "panel_ref", "update_ref", "fused_step_ref", "solve_ref", "forward_ref",
           "backward_ref", "banded_lu_ref", "banded_solve_ref", "batched_lu_ref",
           "batched_solve_ref", "batched_banded_lu_ref", "batched_banded_solve_ref"]


def lu_ref(a) -> np.ndarray:
    """Doolittle LU, no pivoting, packed (unit lower implicit)."""
    a = np.array(a, dtype=np.float64)
    n = a.shape[0]
    for k in range(n - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    return a


def panel_ref(p) -> np.ndarray:
    """Tall-panel LU: pivots in the top b rows."""
    p = np.array(p, dtype=np.float64)
    m, b = p.shape
    for k in range(min(b, m - 1)):
        p[k + 1:, k] /= p[k, k]
        p[k + 1:, k + 1:b] -= np.outer(p[k + 1:, k], p[k, k + 1:b])
    return p


def update_ref(l21, u12, a22) -> np.ndarray:
    """``A22 - L21 @ U12``."""
    return np.asarray(a22, np.float64) - np.asarray(l21, np.float64) @ np.asarray(u12, np.float64)


def fused_step_ref(panel, a_top, a_trail):
    """U12 = L11^{-1} A12 (unit-lower) then A22 - L21 @ U12."""
    panel = np.asarray(panel, np.float64)
    b = panel.shape[1]
    l11 = np.tril(panel[:b], -1) + np.eye(b)
    u12 = np.linalg.solve(l11, np.asarray(a_top, np.float64))
    return u12, update_ref(panel[b:], u12, a_trail)


def forward_ref(lu, b) -> np.ndarray:
    lu = np.asarray(lu, dtype=np.float64)
    y = np.array(b, dtype=np.float64)
    for i in range(lu.shape[0]):
        y[i] = y[i] - lu[i, :i] @ y[:i]
    return y


def backward_ref(lu, y) -> np.ndarray:
    lu = np.asarray(lu, dtype=np.float64)
    x = np.array(y, dtype=np.float64)
    for i in range(lu.shape[0] - 1, -1, -1):
        x[i] = (x[i] - lu[i, i + 1:] @ x[i + 1:]) / lu[i, i]
    return x


def solve_ref(lu, b) -> np.ndarray:
    return backward_ref(lu, forward_ref(lu, b))


def _dense_of_band(arow, bw: int) -> np.ndarray:
    arow = np.asarray(arow, dtype=np.float64)
    n = arow.shape[0]
    dense = np.zeros((n, n))
    for i in range(n):
        for t in range(2 * bw + 1):
            j = i - bw + t
            if 0 <= j < n:
                dense[i, j] = arow[i, t]
    return dense


def banded_lu_ref(arow, bw: int) -> np.ndarray:
    """Band LU by densifying, factoring with :func:`lu_ref`, re-banding."""
    lu = lu_ref(_dense_of_band(arow, bw))
    out = np.zeros(np.shape(arow))
    for i in range(lu.shape[0]):
        for t in range(2 * bw + 1):
            j = i - bw + t
            if 0 <= j < lu.shape[0]:
                out[i, t] = lu[i, j]
    return out


def banded_solve_ref(lu_band, b, bw: int) -> np.ndarray:
    """Substitution on packed band factors, through :func:`solve_ref` on
    the densified factors."""
    return solve_ref(_dense_of_band(lu_band, bw), b)


# ---------------------------------------------------------------------------
# batched: one oracle call per system of the stack
# ---------------------------------------------------------------------------
def batched_lu_ref(a) -> np.ndarray:
    """:func:`lu_ref` of every system of a ``(B, n, n)`` stack."""
    return np.stack([lu_ref(x) for x in np.asarray(a)])


def batched_solve_ref(lu, b) -> np.ndarray:
    """:func:`solve_ref` of every system; ``b`` is ``(B, n)`` or ``(B, n, m)``."""
    return np.stack([solve_ref(x, y) for x, y in zip(np.asarray(lu), np.asarray(b))])


def batched_banded_lu_ref(arow, bw: int) -> np.ndarray:
    """:func:`banded_lu_ref` of every band of a ``(B, n, 2bw+1)`` stack."""
    return np.stack([banded_lu_ref(x, bw) for x in np.asarray(arow)])


def batched_banded_solve_ref(lu_band, b, bw: int) -> np.ndarray:
    """:func:`banded_solve_ref` of every system of the stack."""
    return np.stack([banded_solve_ref(x, y, bw) for x, y in zip(np.asarray(lu_band), np.asarray(b))])
