"""Serving subsystem of the port.

* :mod:`repro_torch.serve.scheduler` — shape-bucketed queue, EbV-equalized
  slot filling, deadline/FIFO ordering, padding stats;
* :mod:`repro_torch.serve.engine` — the slot-based continuous-batching
  generation engine, dense and paged;
* :mod:`repro_torch.serve.paged` — the paged KV cache's page pool, prompt
  prefix fingerprint chains and the refcounted shared-prefix cache;
* :mod:`repro_torch.serve.solve_service` — the factor-once/solve-many
  linear-system service with a tiered LRU factorization cache and
  coalesced multi-RHS solves.
"""
from .engine import Engine, EngineStats, GenRequest  # noqa: F401
from .paged import PagePool, PrefixCache, prefix_chain  # noqa: F401
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
