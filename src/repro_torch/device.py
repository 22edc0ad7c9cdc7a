"""Device choice and the fp32 precision policy of the port.

Importing this module turns TF32 off for matrix products and cuDNN: the
solver contract is IEEE fp32, and TF32 keeps about three decimal digits,
which the no-pivot factorization and its residual checks cannot afford.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve", "device_name"]


def resolve(device=None) -> torch.device:
    """The device an entry point that creates data runs on.

    ``None`` means the CUDA card; with no card it raises instead of quietly
    running on the CPU.  Pass ``device="cpu"`` to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def device_name(t: torch.Tensor) -> str:
    """Name of the device a tensor lies on: ``"cpu"`` or the card's name
    (``torch.cuda.get_device_name``).  Keys the autotune cache, so a CPU
    measurement never steers a dispatch on the card."""
    if t.device.type == "cuda":
        return torch.cuda.get_device_name(t.device)
    return t.device.type
