from .base import ARCH_IDS, SHAPE_CELLS, ModelConfig, ShapeCell, get_config  # noqa: F401
