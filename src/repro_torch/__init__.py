"""PyTorch/CUDA port of the EbV (Equal bi-Vectorized) solver stack.

Mirrors the layout of the JAX package (``core/``, ``solvers/``,
``kernels/``) so each module has a counterpart with the same name.  The
package imports torch and numpy only; the kernels on the dense main path
are hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` on
first use.  See ``README.md`` in this directory.
"""
from . import device  # noqa: F401  (side effect: fp32 precision policy)
