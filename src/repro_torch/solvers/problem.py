"""The :class:`Problem` descriptor — one hashable record per solver call.

The public ops in :mod:`repro_torch.kernels.ops` build one from their
tensor arguments, the registry filters backends by capability against it,
and the autotune cache keys its measurements on it.  The descriptor is
shape-level (no tensor values).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import device_name

__all__ = ["Problem", "OPS", "STRUCTURES", "dtype_name"]

OPS = ("factor", "solve", "linear_solve", "decode")
STRUCTURES = ("dense", "banded", "batched_dense", "batched_banded", "paged_kv")


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"`` (the reference's numpy-style names)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Problem:
    """Shape-level description of one solver invocation.

    ``n``        system order.
    ``bw``       band half-width; 0 for dense structures.
    ``batch``    leading batch size; 1 for unbatched structures.
    ``rhs``      RHS width for solve ops (1 for a vector RHS); 0 for factor.
    ``devices``  device count the call spans; 1 means single-device.
    ``tolerance`` largest acceptable relative residual; 0.0 demands the
                 exact tier.
    ``verify_residual`` measure the relative residual of the composed
                 ``linear_solve`` and escalate past the bound.
    ``enriched`` for solve ops: whether the factor operand is a
                 ``Factorization`` carrying pre-inverted diagonal blocks;
                 the inverted-diagonal solve backends gate on it.  Not part
                 of the autotune cache key.
    ``device``   name of the device the operands lie on (``"cpu"`` or the
                 card's name).  Part of the autotune cache key, never of
                 static selection: the CPU picks the same slot as the card.
    """

    op: str
    structure: str
    n: int
    dtype: str = "float32"
    bw: int = 0
    batch: int = 1
    rhs: int = 0
    devices: int = 1
    tolerance: float = 0.0
    verify_residual: bool = False
    enriched: bool = True
    device: str = "cpu"

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r} (expected one of {OPS})")
        if self.structure not in STRUCTURES:
            raise ValueError(
                f"unknown structure {self.structure!r} (expected one of {STRUCTURES})"
            )
        if self.tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {self.tolerance}")

    @classmethod
    def from_arrays(cls, op: str, a, b=None, *, bw: int = 0, devices: int = 1,
                    tolerance: float = 0.0, verify_residual: bool = False) -> "Problem":
        """Build a descriptor from the operands: ``a`` is the matrix (or a
        ``Factorization``), ``b`` the optional RHS whose trailing width
        becomes ``rhs`` (1 for a vector)."""
        banded = bw > 0
        base = "banded" if banded else "dense"
        if a.ndim == 2:
            structure, batch = base, 1
        elif a.ndim == 3:
            structure, batch = f"batched_{base}", int(a.shape[0])
        else:
            raise ValueError(
                f"{base} {op} expects a 2-D matrix or one leading batch axis; "
                f"got shape {tuple(a.shape)}"
            )
        n = int(a.shape[-2]) if banded else int(a.shape[-1])
        rhs = 0
        if b is not None:
            rhs_ndim_vec = 2 if structure.startswith("batched_") else 1
            rhs = 1 if b.ndim == rhs_ndim_vec else int(b.shape[-1])
        enriched = bool(getattr(a, "enriched", False)) if op == "solve" else True
        packed = getattr(a, "packed", a)
        return cls(op=op, structure=structure, n=n, dtype=dtype_name(a.dtype),
                   bw=int(bw), batch=batch, rhs=rhs, devices=int(devices),
                   tolerance=float(tolerance), verify_residual=bool(verify_residual),
                   enriched=enriched, device=device_name(packed))
