"""Deterministic shard-aware data pipeline."""
from .pipeline import TokenPipeline  # noqa: F401
