"""The LM substrate of the port: the dense and encdec families' model,
blocks and attention (``common``, ``blocks``, ``lm``)."""
from . import blocks, common, lm  # noqa: F401
