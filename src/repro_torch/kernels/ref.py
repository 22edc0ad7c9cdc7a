"""Pure oracles for the dense kernels (numpy float64, loop-level naive).

Deliberately the dumbest correct implementations — independent of both
the CUDA kernels and the vectorized :mod:`repro_torch.core` paths — so the
tests anchor three implementations against each other.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lu_ref", "solve_ref", "forward_ref", "backward_ref"]


def lu_ref(a) -> np.ndarray:
    """Doolittle LU, no pivoting, packed (unit lower implicit)."""
    a = np.array(a, dtype=np.float64)
    n = a.shape[0]
    for k in range(n - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    return a


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
