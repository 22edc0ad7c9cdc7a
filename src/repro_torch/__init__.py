"""PyTorch/CUDA port of the EbV (Equal bi-Vectorized) solver stack.

Mirrors the layout of the JAX package (``core/``, ``solvers/``,
``kernels/``, ``train/``, ``serve/``) so each module has a counterpart with
the same name.  The package imports torch and numpy only; the kernels are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` on first
use.  See ``README.md`` in this directory.
"""
from . import device  # noqa: F401  (side effect: fp32 precision policy)
from . import train  # noqa: F401  (the optimizers; they import the solver stack on first step)
