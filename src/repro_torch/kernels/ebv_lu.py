"""The fused EbV LU factor: CUDA kernel (``csrc/ebv_lu.cu``) and its plain
PyTorch version.

:func:`lu_fused` replaces the reference's single-dispatch Pallas
megakernel.  It pads the matrix to ``N = S·B`` with an identity tail, runs
``S`` steps of four launches each (diagonal-tile factor, L21 and U12 panel
solves, trailing update; ``4S-3`` launches in all) on its own padded copy,
and cuts the padding off.  The caller's tensor is never mutated.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.blocked import fused_block_size, fused_blocked_lu, pad_identity_tail
from . import _build

__all__ = ["lu_fused", "lu_fused_plain", "fused_launches"]


def lu_fused_plain(a: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`lu_fused`
    (:func:`repro_torch.core.blocked.fused_blocked_lu`)."""
    return fused_blocked_lu(a, block=block)


def fused_launches(n: int, block: int = 256) -> int:
    """Kernel launches :func:`lu_fused` should make for an (n, n) matrix
    (the count it adds to ``lu_fused.launches`` is the one the C driver
    reports)."""
    B = fused_block_size(n, block)
    return 4 * (-(-n // B)) - 3


def lu_fused(a: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Packed no-pivot LU of a square fp32 matrix: unit L strictly below
    the diagonal, U on and above it.

    A tensor on the CPU runs the plain version; a CUDA tensor launches the
    kernels (``lu_fused.launches`` adds the count the C driver reports)."""
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"lu_fused expects a square matrix, got shape {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"lu_fused supports float32 only, got {a.dtype}")
    if a.device.type == "cpu":
        return lu_fused_plain(a, block=block)
    if a.device.type != "cuda":
        raise ValueError(f"lu_fused runs on CPU or CUDA tensors, got {a.device}")
    n = a.shape[-1]
    B = fused_block_size(n, block)
    N = -(-n // B) * B
    work = pad_identity_tail(a.contiguous(), N)
    if work.data_ptr() == a.data_ptr():  # no padding and no copy yet: never factor the caller's tensor
        work = work.clone()
    lib = _build.library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        code = lib.ebv_lu_fused(work.data_ptr(), N, B, torch.cuda.current_stream().cuda_stream,
                                ctypes.byref(launched))
    lu_fused.launches += launched.value
    _build.check(code, "lu_fused")
    return work[:n, :n].contiguous() if N != n else work


lu_fused.launches = 0
