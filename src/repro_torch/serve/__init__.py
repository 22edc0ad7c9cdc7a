"""Serving subsystem of the port.

* :mod:`repro_torch.serve.scheduler` — shape-bucketed queue, EbV-equalized
  slot filling, deadline/FIFO ordering, padding stats;
* :mod:`repro_torch.serve.solve_service` — the factor-once/solve-many
  linear-system service with a tiered LRU factorization cache and
  coalesced multi-RHS solves.

The reference's generation engine and paged KV cache (``serve/engine.py``,
``serve/paged.py``) arrive with the serving slice (ROADMAP queue A,
item 14).
"""
from .scheduler import Scheduler, bucket_length  # noqa: F401
from .solve_service import (  # noqa: F401
    DeadlineMiss,
    NotFlushed,
    SolveRequest,
    SolveService,
    SolveServiceStats,
    UnknownTicket,
    fingerprint,
)
