"""`repro_torch.solvers` — the solver dispatch registry.

* :class:`Problem` (``problem.py``) — shape-level descriptor of a call;
* :class:`Backend` (``registry.py``) — callable + capability predicate +
  static priority, registered per ``(op, structure)`` slot;
* ``cache.py`` — the measured autotune cache, keyed by device name;
* ``faults.py`` — deterministic fault injection at the dispatch boundary;
* ``backends.py`` — the registrations (imported here for its side effect).
"""
from .problem import Problem, OPS, STRUCTURES
from .registry import (
    Backend,
    DEMOTION_TTL,
    VERIFY_RESIDUAL_DEFAULT_BOUND,
    SolveFailure,
    add_dispatch_hook,
    add_escalation_hook,
    backends_for,
    candidates,
    clear_demotions,
    demotions,
    dispatch,
    get_backend,
    record_dispatches,
    record_escalations,
    register,
    remove_dispatch_hook,
    remove_escalation_hook,
    select,
)
from .cache import AutotuneCache, get_cache, cache_path, invalidate
from .faults import FaultPlan, InjectedFault, inject
from . import backends  # noqa: F401  (side effect: registration)

__all__ = [
    "Problem", "Backend", "OPS", "STRUCTURES", "SolveFailure",
    "register", "backends_for", "candidates", "get_backend", "select", "dispatch",
    "add_dispatch_hook", "remove_dispatch_hook", "record_dispatches",
    "add_escalation_hook", "remove_escalation_hook", "record_escalations",
    "demotions", "clear_demotions", "DEMOTION_TTL", "VERIFY_RESIDUAL_DEFAULT_BOUND",
    "FaultPlan", "InjectedFault", "inject",
    "AutotuneCache", "get_cache", "cache_path", "invalidate",
]
