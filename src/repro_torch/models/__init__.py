"""The LM substrate of the port: the dense family's model, blocks and
attention (``common``, ``blocks``, ``lm``)."""
from . import blocks, common, lm  # noqa: F401
