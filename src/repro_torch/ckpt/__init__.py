"""Fault-tolerant checkpointing in the reference's layout."""
from .manager import CheckpointManager  # noqa: F401
