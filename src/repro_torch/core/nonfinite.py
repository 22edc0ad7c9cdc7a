"""Where the reference's masked steps spread NaN, for the port's live-row loops.

The reference writes every elimination and substitution step as a masked
full-length update: ``a - where(live, l, 0) * where(live, u, 0)``.  Where
the mask zeroes a factor, a finite operand leaves the entry as it was
(``y - 0·y_k = y``, up to the sign of a zero), but a non-finite one turns
it NaN (``0·inf``).  The port's plain versions loop over the live rows and
columns only, which gives the same finite values; these helpers then add
the NaN the masked steps spread.  Each rule holds because what a masked step
turns NaN is never read by a later step of the same loop, so it can be
applied once, to the loop's result:

* forward substitution (``k < r - 1``): a non-finite ``y_k`` turns NaN the
  rows ``0..k`` of its column (:func:`nan_above_last`);
* backward substitution: a non-finite ``x_k`` turns NaN the rows ``k..``
  of its column (:func:`nan_below_first`);
* an elimination step ``k``: a non-finite pivot-row entry ``u[k, j]``
  turns NaN the rows ``0..k`` of column ``j``, and a non-finite multiplier
  ``l[i, k]`` the columns ``0..k-1`` of row ``i`` (:func:`lu_spread`).
"""
from __future__ import annotations

import torch

__all__ = ["nan_above_last", "nan_below_first", "nan_left_of_last", "lu_spread"]

_NAN = float("nan")


def _through_last(bad: torch.Tensor, dim: int) -> torch.Tensor:
    """True at every index at or before the last True along ``dim``."""
    return bad.flip(dim).cummax(dim).values.flip(dim)


def nan_above_last(y: torch.Tensor, rows: int) -> torch.Tensor:
    """NaN at rows ``0..k`` of each column of ``y`` (``(..., r, m)``), ``k``
    the last row below ``rows`` that holds a non-finite value: what the
    masked forward steps ``k < rows`` add.  Returns a new tensor."""
    mask = torch.zeros_like(y, dtype=torch.bool)
    mask[..., :rows, :] = _through_last(~torch.isfinite(y[..., :rows, :]), -2)
    return y.masked_fill(mask, _NAN)


def nan_below_first(x: torch.Tensor) -> torch.Tensor:
    """NaN at rows ``k..`` of each column of ``x`` (``(..., r, m)``), ``k``
    its first row holding a non-finite value: what the masked backward
    steps add.  Returns a new tensor."""
    return x.masked_fill((~torch.isfinite(x)).cummax(-2).values, _NAN)


def nan_left_of_last(t: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """NaN left of the last non-finite entry of each row of ``t`` among the
    ``live`` multipliers (a bool mask broadcast against ``t``): what the
    masked elimination steps add to the multipliers' rows.  Returns a new
    tensor."""
    bad = _through_last(~torch.isfinite(t) & live, -1)
    mask = torch.zeros_like(bad)
    mask[..., :-1] = bad[..., 1:]
    return t.masked_fill(mask, _NAN)


def lu_spread(a: torch.Tensor) -> torch.Tensor:
    """The NaN the reference's masked unblocked elimination adds to a
    packed ``(..., n, n)`` LU from the live-row steps: above a non-finite
    U entry (rows ``0..k`` of column ``j > k``) and left of a non-finite
    multiplier (columns ``0..k-1`` of row ``i > k``).  Returns a new
    tensor."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    upper = idx[:, None] < idx[None, :]
    bad_u = ~torch.isfinite(a) & upper
    out = nan_left_of_last(a, idx[:, None] > idx[None, :])
    return out.masked_fill(_through_last(bad_u, -2), _NAN)
