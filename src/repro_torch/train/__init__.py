"""Training substrate of the port: the optimizers (AdamW and the
EbV-preconditioned optimizer, whose preconditioner solves run on the
batched EbV kernels), the training loop and gradient compression."""
from . import grad_compress, loop, optimizer  # noqa: F401
from .optimizer import (
    AdamW,
    EbvPreconditioned,
    clip_by_global_norm,
    constant_lr,
    get_optimizer,
    global_norm,
    warmup_cosine,
)

__all__ = ["optimizer", "loop", "grad_compress", "AdamW", "EbvPreconditioned",
           "clip_by_global_norm", "constant_lr", "get_optimizer", "global_norm", "warmup_cosine"]
