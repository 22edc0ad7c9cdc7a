"""State carried across from the JAX package.

This system has no weights: its state is the matrix, the right-hand sides
and the ``Factorization`` artifact.  These helpers take the numpy arrays
``np.asarray`` gives of the reference's tensors and rebuild them here, on
the card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .core.factorization import Factorization

__all__ = ["tensor_from_numpy", "factorization_from_numpy"]


def tensor_from_numpy(x, *, device=None) -> torch.Tensor:
    """A numpy matrix or RHS as a tensor of the same dtype on ``device``."""
    return torch.from_numpy(np.array(x)).to(_device.resolve(device))  # a writable copy


def factorization_from_numpy(packed, linv=None, uinv=None, *, block: int, tier: float = 0.0,
                             device=None) -> Factorization:
    """A reference ``Factorization`` (its ``packed``, ``linv`` and ``uinv``
    as numpy arrays, plus its ``block`` and ``tier``) as this package's
    dense artifact.  The health record is not carried: it is recomputed
    here when asked for."""
    if (linv is None) != (uinv is None):
        raise ValueError("linv and uinv come together (an enriched artifact) or not at all")
    dev = _device.resolve(device)
    conv = (lambda x: None if x is None else tensor_from_numpy(x, device=dev))
    return Factorization(packed=conv(packed), linv=conv(linv), uinv=conv(uinv),
                         structure="dense", block=int(block), tier=float(tier))
