"""Deterministic fault injection at the registry dispatch boundary.

Tests push a :class:`FaultPlan` onto a stack the registry consults at every
dispatch attempt:

    with faults.inject(nan_pivot_at=0, match=lambda p: p.n == 96):
        ops.lu(a, health=True)     # factors come back pivot-poisoned

Three fault kinds, composable in one plan:

* ``backend_raises`` — the matched backend raises :class:`InjectedFault`
  instead of running; the funnel escalates past it.
* ``nan_pivot_at=i`` — the matched backend runs, then pivot ``i`` of its
  packed factor is overwritten with NaN; only health screening catches it.
* ``slow_dispatch_us`` — a host-side sleep before the backend runs.

Every application is appended to ``plan.applied``.  Leaving the ``inject``
context clears the registry's demotion table, so faults never leak
selection state into later healthy traffic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

__all__ = ["InjectedFault", "FaultPlan", "inject", "active_plans"]


class InjectedFault(RuntimeError):
    """Raised by a ``backend_raises`` plan in place of running the backend."""


@dataclasses.dataclass
class FaultPlan:
    """One active fault description (see module docstring).

    ``match``/``backend``/``op`` restrict which dispatch attempts the plan
    applies to (all ``None`` = every attempt); ``times`` caps the total
    applications (``None`` = unlimited)."""

    nan_pivot_at: int | None = None
    backend_raises: bool = False
    slow_dispatch_us: float = 0.0
    match: Callable | None = None
    backend: str | None = None
    op: str | None = None
    times: int | None = None
    applied: list = dataclasses.field(default_factory=list)

    def matches(self, problem, backend_name: str) -> bool:
        if self.times is not None and len(self.applied) >= self.times:
            return False
        if self.op is not None and problem.op != self.op:
            return False
        if self.backend is not None and backend_name != self.backend:
            return False
        return self.match is None or bool(self.match(problem))

    def _note(self, problem, backend_name: str, kind: str) -> None:
        self.applied.append((problem, backend_name, kind))

    def before_call(self, problem, backend_name: str) -> None:
        """Pre-call faults: straggler sleep, then injected crash."""
        if self.slow_dispatch_us:
            self._note(problem, backend_name, "slow_dispatch")
            time.sleep(self.slow_dispatch_us / 1e6)
        if self.backend_raises:
            self._note(problem, backend_name, "backend_raises")
            raise InjectedFault(f"injected fault: backend {backend_name!r} raised for {problem}")

    def after_call(self, problem, backend_name: str, result):
        """Post-call fault: poison pivot ``nan_pivot_at`` of a packed dense
        factor (factor records such as pivoted factors pass unchanged)."""
        if self.nan_pivot_at is None or problem.op != "factor":
            return result
        if not isinstance(result, torch.Tensor):
            return result
        self._note(problem, backend_name, "nan_pivot")
        i = int(self.nan_pivot_at)
        result = result.clone()
        result[..., i, i] = float("nan")
        return result


_ACTIVE: list[FaultPlan] = []


def active_plans() -> list[FaultPlan]:
    """The currently-injected plans (outermost first)."""
    return list(_ACTIVE)


class inject:
    """Context manager arming one :class:`FaultPlan` (kwargs are the plan
    fields); yields the plan.  On exit the plan is disarmed and the
    registry's demotion table is cleared."""

    def __init__(self, **kwargs):
        self.plan = FaultPlan(**kwargs)

    def __enter__(self) -> FaultPlan:
        _ACTIVE.append(self.plan)
        return self.plan

    def __exit__(self, *exc):
        if self.plan in _ACTIVE:
            _ACTIVE.remove(self.plan)
        from . import registry

        registry.clear_demotions()
        return False
