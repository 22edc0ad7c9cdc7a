"""Hand-written Hopper kernels for the dense, banded and batched EbV paths
and for paged decode attention.

``<name>.py`` holds each kernel's wrapper beside its plain PyTorch version;
the CUDA sources live in ``../csrc`` and are built on first use
(``_build.py``); ``ops.py`` holds the public ops; ``ref.py`` the numpy
float64 oracles.
"""
from . import banded, batched_lu, ebv_lu, paged_attn, trsm, ref  # noqa: F401
