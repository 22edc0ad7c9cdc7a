"""Backend registry + selection engine.

Every implementation registers a :class:`Backend` under its
``(op, structure)`` slot.  Selection is a three-stage funnel:

1. **capability filter** — ``Backend.supports(problem)`` prunes backends
   that cannot run the problem (dtype, device count, enrichment), and the
   **tolerance gate** prunes approximate backends (those declaring a
   ``residual_bound``) unless the problem carries a tolerance that bound
   meets, so a default (``tolerance == 0``) problem sees the exact tier
   only;
2. **measured selection** — the autotune cache (:mod:`.cache`) picks the
   fastest *measured* capable backend among those flagged ``autotune``,
   measured on the same device;
3. **static fallback** — the highest ``priority(problem)`` wins.  The
   priorities reproduce the reference's slot choices, with the ``pallas_``
   backends renamed ``cuda_``.  They do not look at the device: on the CPU
   the same ``cuda_*`` slot is chosen and its wrapper runs the plain
   version.

``impl=`` on the public ops is a forced override that bypasses stages 2-3.

**Escalation funnel**: a dispatch that carries a *validator* (a factor
health screen from ``ops.lu(..., health=)``, or the relative-residual
check that ``Problem.verify_residual`` arms on a ``linear_solve``
dispatch) or an injected fault plan
becomes a retry loop over the capable candidates, best-first.  A backend
whose result fails validation, or whose call raises, is *demoted* for that
problem shape for the next ``DEMOTION_TTL`` screened dispatches, an
escalation event fires, and the next candidate runs.  On the card only an
injected fault escalates: any other error a backend raises there (a kernel
that fails to build or launch) propagates, so no plain version ever stands
in for a kernel.  The last resort for dense factors is the partial-pivoting
``pivoted`` backend.  When every candidate fails, the dispatch raises a
structured :class:`SolveFailure`.  A default dispatch (no validator, no
active faults) takes the plain select-and-call path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import cache as _cache
from .problem import Problem

__all__ = [
    "Backend",
    "SolveFailure",
    "register",
    "backends_for",
    "get_backend",
    "candidates",
    "select",
    "dispatch",
    "add_dispatch_hook",
    "remove_dispatch_hook",
    "record_dispatches",
    "add_escalation_hook",
    "remove_escalation_hook",
    "record_escalations",
    "demotions",
    "clear_demotions",
    "DEMOTION_TTL",
    "VERIFY_RESIDUAL_DEFAULT_BOUND",
    "NOT_PORTED",
]


@dataclasses.dataclass(frozen=True)
class Backend:
    """One dispatchable implementation.

    ``call``      ``(problem, *tensors, **kw) -> result``; adapters accept
                  and ignore kwargs meant for other backends (``**_``).
    ``supports``  capability predicate; auto-selection only considers
                  backends whose predicate holds.
    ``priority``  static rank (higher wins) used when no measurement
                  transfers.
    ``autotune``  whether the backend competes in measured selection.
    ``residual_bound`` relative residual ``|Ax-b|/|b|`` the backend
                  guarantees for its operand class, or None for exact
                  backends; an approximate backend is a candidate only
                  when ``0 < residual_bound(problem) <= problem.tolerance``.
    """

    name: str
    op: str
    structure: str
    call: Callable
    supports: Callable[[Problem], bool] = lambda p: True
    priority: Callable[[Problem], float] = lambda p: 0.0
    autotune: bool = True
    residual_bound: Callable[[Problem], float] | None = None


_REGISTRY: dict[tuple[str, str], dict[str, Backend]] = {}

# Backends of the reference that later slices of the port bring.  Forcing
# one raises NotImplementedError naming the slice instead of running a
# substitute.
NOT_PORTED: dict[tuple[str, str, str], str] = {}


def register(backend: Backend, *, overwrite: bool = False) -> Backend:
    slot = _REGISTRY.setdefault((backend.op, backend.structure), {})
    if backend.name in slot and not overwrite:
        raise ValueError(
            f"backend {backend.name!r} already registered for "
            f"({backend.op}, {backend.structure})"
        )
    slot[backend.name] = backend
    return backend


def backends_for(op: str, structure: str) -> list[Backend]:
    return list(_REGISTRY.get((op, structure), {}).values())


def get_backend(op: str, structure: str, name: str) -> Backend:
    slot = _REGISTRY.get((op, structure), {})
    if name in slot:
        return slot[name]
    later = NOT_PORTED.get((op, structure, name))
    if later is not None:
        raise NotImplementedError(f"impl {name!r} for ({op}, {structure}) is not ported yet: {later}")
    raise ValueError(f"unknown impl {name!r} for ({op}, {structure}); registered: {sorted(slot)}")


def _tolerance_admits(backend: Backend, problem: Problem) -> bool:
    """The accuracy gate: exact backends always pass; an approximate one
    only when the caller's tolerance is at least as loose as its bound."""
    if backend.residual_bound is None:
        return True
    return problem.tolerance > 0 and backend.residual_bound(problem) <= problem.tolerance


def candidates(problem: Problem) -> list[Backend]:
    """Capability- and tolerance-filtered backends for ``problem``."""
    return [b for b in backends_for(problem.op, problem.structure)
            if b.supports(problem) and _tolerance_admits(b, problem)]


def select(problem: Problem, *, impl: str | None = None,
           cache: _cache.AutotuneCache | None = None) -> Backend:
    """Pick the backend for ``problem``: forced ``impl`` > measured winner >
    static priority."""
    if impl is not None:
        return get_backend(problem.op, problem.structure, impl)
    cands = candidates(problem)
    if not cands:
        raise ValueError(
            f"no capable backend for {problem} among "
            f"{[b.name for b in backends_for(problem.op, problem.structure)]}"
        )
    cache = _cache.get_cache() if cache is None else cache
    measured = cache.best(problem, [b.name for b in cands if b.autotune])
    if measured is not None:
        return get_backend(problem.op, problem.structure, measured)
    return max(cands, key=lambda b: b.priority(problem))


# ---------------------------------------------------------------------------
# dispatch observability
# ---------------------------------------------------------------------------
_DISPATCH_HOOKS: list[Callable[[Problem, Backend], None]] = []


def add_dispatch_hook(fn: Callable[[Problem, Backend], None]) -> Callable:
    """Register ``fn(problem, backend)`` to observe every dispatch (called
    after selection, before the backend runs).  Returns ``fn``."""
    _DISPATCH_HOOKS.append(fn)
    return fn


def remove_dispatch_hook(fn: Callable) -> None:
    if fn in _DISPATCH_HOOKS:
        _DISPATCH_HOOKS.remove(fn)


class record_dispatches:
    """Context manager collecting ``(problem, backend_name)`` for every
    dispatch inside the block::

        with record_dispatches() as log:
            ops.linear_solve(a, b)
    """

    def __enter__(self) -> list[tuple[Problem, str]]:
        self.log: list[tuple[Problem, str]] = []
        self._fn = add_dispatch_hook(lambda p, b: self.log.append((p, b.name)))
        return self.log

    def __exit__(self, *exc):
        remove_dispatch_hook(self._fn)
        return False


# ---------------------------------------------------------------------------
# failure structure + escalation state
# ---------------------------------------------------------------------------
class SolveFailure(RuntimeError):
    """Terminal dispatch failure: every capable backend raised or failed
    validation.  ``problem`` is the dispatched :class:`Problem`, ``chain``
    one ``{"backend", "reason"}`` dict per failed attempt in the order
    tried, ``health`` the last screening record a validator produced."""

    def __init__(self, message: str, *, problem: Problem | None = None,
                 chain: list | None = None, health=None):
        super().__init__(message)
        self.problem = problem
        self.chain = chain or []
        self.health = health


# After a backend fails for a problem shape, screened dispatches of that
# shape skip it for the next DEMOTION_TTL dispatches (TTL-bounded so a
# transient fault cannot permanently re-steer healthy traffic).
DEMOTION_TTL = 8

# Bound the composed exact-tier linear solve is held to under
# verify_residual; fp32 no-pivot solves of in-class operands measure ~1e-7.
VERIFY_RESIDUAL_DEFAULT_BOUND = 1e-4

_DEMOTIONS: dict[tuple, int] = {}  # (shape key, backend name) -> remaining TTL


def _shape_key(p: Problem) -> tuple:
    return (p.op, p.structure, p.dtype, p.n, p.bw, p.batch, p.devices, p.device)


def _demote(problem: Problem, name: str) -> None:
    _DEMOTIONS[(_shape_key(problem), name)] = DEMOTION_TTL


def _tick_demotions(key: tuple) -> None:
    """Age every demotion of this shape by one dispatch; drop the expired."""
    for k in [k for k in _DEMOTIONS if k[0] == key]:
        _DEMOTIONS[k] -= 1
        if _DEMOTIONS[k] <= 0:
            del _DEMOTIONS[k]


def demotions() -> dict[tuple, int]:
    """Snapshot of the active demotion table."""
    return dict(_DEMOTIONS)


def clear_demotions() -> None:
    _DEMOTIONS.clear()


_ESCALATION_HOOKS: list[Callable] = []


def add_escalation_hook(fn: Callable) -> Callable:
    """Register ``fn(problem, failed_backend_name, next_backend_name | None,
    reason)`` to observe every escalation (``next`` is None on the terminal
    failure).  Returns ``fn``."""
    _ESCALATION_HOOKS.append(fn)
    return fn


def remove_escalation_hook(fn: Callable) -> None:
    if fn in _ESCALATION_HOOKS:
        _ESCALATION_HOOKS.remove(fn)


def _notify_escalation(problem, failed: str, nxt: str | None, reason: str) -> None:
    """Fire the escalation hooks (dispatch calls it per funnel step, and
    the composed path of ``ops.linear_solve`` when its residual check fails
    over to the pivoted last resort)."""
    for hook in _ESCALATION_HOOKS:
        hook(problem, failed, nxt, reason)


class record_escalations:
    """Context manager collecting ``(problem, failed, next, reason)`` for
    every escalation inside the block."""

    def __enter__(self) -> list[tuple]:
        self.log: list[tuple] = []
        self._fn = add_escalation_hook(
            lambda p, failed, nxt, reason: self.log.append((p, failed, nxt, reason))
        )
        return self.log

    def __exit__(self, *exc):
        remove_escalation_hook(self._fn)
        return False


def _residual_validator(arrays):
    """Validator of a ``verify_residual`` linear_solve dispatch: the
    result's ``|Ax-b|/|b|`` against ``tolerance`` when set, else
    :data:`VERIFY_RESIDUAL_DEFAULT_BOUND`."""
    from ..core import health as _health

    a, b = arrays[0], arrays[1]

    def validate(problem, backend, result):
        bound = problem.tolerance if problem.tolerance > 0 else VERIFY_RESIDUAL_DEFAULT_BOUND
        rel = float(_health.relative_residual(a, b, result, bw=problem.bw))
        if not rel <= bound:  # NaN-safe
            return f"residual {rel:.3e} > bound {bound:.1e} from {backend.name}", None
        return None

    return validate


def _run_attempt(plans, problem, backend, arrays, kw):
    """One dispatch attempt with fault plans applied around the call."""
    matched = [p for p in plans if p.matches(problem, backend.name)]
    for p in matched:
        p.before_call(problem, backend.name)
    result = backend.call(problem, *arrays, **kw)
    for p in matched:
        result = p.after_call(problem, backend.name, result)
    return result


def dispatch(problem: Problem, *arrays, impl: str | None = None,
             cache: _cache.AutotuneCache | None = None,
             validate: Callable | None = None, **kw):
    """Select and run in one step.

    ``validate(problem, backend, result)`` returns None to accept or a
    ``(reason, health_record | None)`` pair to reject — rejection feeds the
    escalation funnel on auto dispatches and raises :class:`SolveFailure`
    on forced ones."""
    from . import faults as _faults

    plans = _faults.active_plans()
    if validate is None and problem.verify_residual and problem.op == "linear_solve":
        validate = _residual_validator(arrays)

    if impl is not None:
        # forced override: no escalation target, but faults still apply and
        # a failed validation raises the structured failure
        backend = get_backend(problem.op, problem.structure, impl)
        for hook in _DISPATCH_HOOKS:
            hook(problem, backend)
        result = _run_attempt(plans, problem, backend, arrays, kw)
        if validate is not None:
            err = validate(problem, backend, result)
            if err is not None:
                reason, health = err
                raise SolveFailure(
                    f"forced impl {impl!r} failed validation for {problem}: {reason}",
                    problem=problem, chain=[{"backend": backend.name, "reason": reason}],
                    health=health,
                )
        return result

    if not plans and validate is None:
        # plain path; demotions only steer screened dispatches, so an
        # earlier hostile operand never re-routes default traffic
        backend = select(problem, cache=cache)
        for hook in _DISPATCH_HOOKS:
            hook(problem, backend)
        return backend.call(problem, *arrays, **kw)

    # --- escalation funnel -------------------------------------------------
    winner = select(problem, cache=cache)
    rest = sorted(
        (b for b in candidates(problem) if b.name != winner.name),
        key=lambda b: b.priority(problem), reverse=True,
    )
    ordered = [winner] + rest
    key = _shape_key(problem)
    _tick_demotions(key)
    live = [b for b in ordered if (key, b.name) not in _DEMOTIONS] or ordered
    chain: list[dict] = []
    last_health = None
    for i, backend in enumerate(live):
        for hook in _DISPATCH_HOOKS:
            hook(problem, backend)
        health = None
        try:
            result = _run_attempt(plans, problem, backend, arrays, kw)
            err = validate(problem, backend, result) if validate else None
            if err is None:
                return result
            reason, health = err
        except Exception as e:  # noqa: BLE001 — on the CPU every backend error escalates
            if problem.device != "cpu" and not isinstance(e, _faults.InjectedFault):
                raise
            reason = f"{type(e).__name__}: {e}"
        last_health = health if health is not None else last_health
        chain.append({"backend": backend.name, "reason": reason})
        _demote(problem, backend.name)
        nxt = live[i + 1].name if i + 1 < len(live) else None
        _notify_escalation(problem, backend.name, nxt, reason)
    raise SolveFailure(
        f"all {len(live)} capable backends failed for {problem}: "
        + " -> ".join(f"{c['backend']} ({c['reason']})" for c in chain),
        problem=problem, chain=chain, health=last_health,
    )
