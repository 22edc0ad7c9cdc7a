"""Hand-written Hopper kernels for the dense and banded EbV paths.

``<name>.py`` holds each kernel's wrapper beside its plain PyTorch version;
the CUDA sources live in ``../csrc`` and are built on first use
(``_build.py``); ``ops.py`` holds the public ops; ``ref.py`` the numpy
float64 oracles.
"""
from . import banded, ebv_lu, trsm, ref  # noqa: F401
