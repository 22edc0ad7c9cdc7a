"""Training substrate of the port: the optimizers (AdamW and the
EbV-preconditioned optimizer, whose preconditioner solves run on the
batched EbV kernels)."""
from . import optimizer  # noqa: F401
from .optimizer import (
    AdamW,
    EbvPreconditioned,
    clip_by_global_norm,
    constant_lr,
    get_optimizer,
    global_norm,
    warmup_cosine,
)

__all__ = ["optimizer", "AdamW", "EbvPreconditioned", "clip_by_global_norm", "constant_lr",
           "get_optimizer", "global_norm", "warmup_cosine"]
