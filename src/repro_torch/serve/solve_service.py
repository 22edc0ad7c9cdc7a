"""Linear-system serving front end: factor once, solve many.

The same matrix arrives over and over with fresh right-hand sides
(transient time steps, Monte-Carlo sweeps, parameter scans).  The service
exploits it twice:

* **factorization cache** — an LRU keyed by the matrix *fingerprint*
  (content hash of bytes + shape + dtype + bandwidth).  A hit skips the
  factor dispatch and goes straight to substitution;
* **RHS coalescing** — pending requests against one fingerprint stack
  their RHS columns into one wide solve dispatch
  (:func:`repro_torch.core.solve.stack_rhs`).

Everything routes through :class:`repro_torch.solvers.Problem` descriptors
and the registry; the dispatch counts in ``stats`` come from the registry's
dispatch hook.

**Accuracy tiers.**  Requests carry a ``tolerance`` (largest acceptable
relative residual; 0.0 = exact).  The cache holds factors *per accuracy
tier* under each fingerprint — tier 0.0 for exact packed factors, the
artifact's tier for a tolerance-keyed factor, ``RAND_LU_RESIDUAL_BOUND``
for the rank-k factors of a ``rank=`` request.  A request is served by any
cached tier at or below its tolerance, the tightest first; an approximate
factor never serves a tighter request.

**Coalescing-width cap.**  When the autotune cache holds a measured width
sweep for a transferable shape (``AutotuneCache.best_width``), a stacked
solve is chunked at the most µs-per-column-efficient width; unmeasured
shapes coalesce fully.

**Failure isolation.**  Factorizations are health-screened by default
(``ops.lu(..., health=)`` → the registry's escalation funnel), so a hostile
operand escalates through the capable backends and, when every one fails,
becomes a structured :class:`repro_torch.solvers.SolveFailure`.  The
failing group's tickets resolve to that failure *value* (the other groups
of the flush are untouched), its factors never enter the LRU, and its
fingerprint is quarantined for the next ``quarantine_ttl`` flushes.  With a
``clock=``, requests already past their deadline at drain are shed as
:class:`DeadlineMiss` values.  ``flush`` is transactional: an unexpected
exception requeues every unprocessed entry with its seq and deadline.

**Devices.**  Numpy operands go to the service's device (the card unless
it was built with ``device="cpu"``); tensors stay where they lie.  The
fingerprint of a tensor on the card copies it to the host and hashes it
there.  ``mesh=`` (the reference's multi-device banded routing) raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from .. import device as _device
from .. import solvers
from ..core import health as _health
from ..core import refine as _refine
from ..core.factorization import Factorization
from ..core.pivoted import PivotedFactors
from ..core.randomized import RankKFactors
from ..core.solve import split_rhs, stack_rhs
from ..kernels import ops as kops
from ..solvers.backends import RAND_LU_RESIDUAL_BOUND
from ..solvers.problem import dtype_name
from .scheduler import Scheduler

__all__ = [
    "SolveRequest",
    "SolveServiceStats",
    "SolveService",
    "fingerprint",
    "DeadlineMiss",
    "UnknownTicket",
    "NotFlushed",
]

_MESH = "mesh= arrives with the multi-device slice (ROADMAP A7: SPIKE)"


class UnknownTicket(KeyError):
    """The ticket was never issued, or its result was already redeemed."""


class NotFlushed(KeyError):
    """The ticket is still queued — call :meth:`SolveService.flush` first."""


@dataclasses.dataclass(frozen=True)
class DeadlineMiss:
    """Result value for a request already past its deadline at drain time:
    the service sheds it instead of spending a dispatch on a stale answer."""

    ticket: int
    deadline: float
    now: float


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bf16: hash its bit patterns
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(a)


def fingerprint(a, *, bw: int = 0) -> str:
    """Content hash identifying a matrix operand (dense or row-aligned
    band): sha1 over ``str((shape, dtype.str, bw))`` and the raw bytes, as
    the reference hashes.  A tensor on the card is copied to the host."""
    arr = _host_array(a)
    h = hashlib.sha1()
    h.update(str((arr.shape, arr.dtype.str, int(bw))).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class SolveRequest:
    ticket: int
    fp: str
    a: torch.Tensor  # matrix operand (kept until its group's factor is cached)
    b: torch.Tensor  # RHS (n,) or (n, m)
    bw: int
    deadline: float | None = None
    tolerance: float = 0.0  # largest acceptable relative residual (0 = exact)
    rank: int | None = None  # request the randomized rank-k factor tier


@dataclasses.dataclass
class SolveServiceStats:
    requests: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    factor_dispatches: int = 0
    solve_dispatches: int = 0
    coalesced_requests: int = 0  # requests that shared a solve dispatch
    solved_columns: int = 0
    approx_solves: int = 0  # dispatches served by a residual-bound (approximate) tier
    width_capped_dispatches: int = 0  # extra dispatches forced by the coalescing cap
    failed_requests: int = 0  # tickets resolved to a structured SolveFailure
    escalations: int = 0  # registry escalation events observed during flushes
    quarantined: int = 0  # tickets short-circuited by the negative cache
    shed_deadline: int = 0  # tickets shed as DeadlineMiss at drain
    last_refine_iterations: int | None = None  # sweeps of the last polished approximate solve

    @property
    def hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 0.0


class SolveService:
    """Batch front end over the solver registry.

    ``submit`` enqueues; ``flush`` drains the queue grouped by matrix
    fingerprint — one factor dispatch per *cold* matrix, one coalesced
    stacked-RHS solve dispatch per group — and returns
    ``{ticket: solution}``.  ``solve`` is submit + flush for one request.
    """

    def __init__(self, *, cache_entries: int = 16, health=True, quarantine_ttl: int = 8,
                 clock=None, verify_residual: bool = False, device=None, mesh=None,
                 mesh_axis: str = "model"):
        """``health=`` screens every factorization (``True`` = default
        thresholds, a :class:`repro_torch.core.health.HealthThresholds` to
        tune, ``None``/``False`` to disable).  ``quarantine_ttl`` is how
        many later flushes a terminally failed fingerprint short-circuits
        for.  ``clock`` (e.g. ``time.monotonic``) arms deadline shedding;
        without one, deadlines only order the flush.  ``verify_residual``
        also gates every coalesced solve on its measured relative residual.
        ``device`` is where numpy operands go (the card unless
        ``device="cpu"``)."""
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.cache_entries = cache_entries
        self.health = health
        self.quarantine_ttl = quarantine_ttl
        self.verify_residual = verify_residual
        self.device = device
        self._clock = clock
        # fp -> {accuracy tier -> factors}; LRU order and the entry budget
        # are per fingerprint
        self._lru: OrderedDict[str, dict[float, object]] = OrderedDict()
        # negative cache: fp -> (expiry flush count, the SolveFailure)
        self._quarantine: dict[str, tuple[int, object]] = {}
        self._flush_count = 0
        self._sched = Scheduler()
        self._tickets = 0
        self._pending_tickets: set[int] = set()
        self._done: dict[int, object] = {}  # flushed, not yet redeemed
        self.stats = SolveServiceStats()

    # -- admission ----------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.asarray(x)).to(_device.resolve(self.device))

    def submit(self, a, b, *, bw: int = 0, deadline: float | None = None,
               tolerance: float = 0.0, rank: int | None = None) -> int:
        """Enqueue ``a x = b`` (``bw > 0`` = row-aligned band operand);
        returns a ticket redeemable after the next :meth:`flush`.

        ``tolerance`` keys the scheduler bucket and selects which cached
        factor tiers may serve the request (any tier ≤ tolerance).
        ``rank=`` asks for the randomized rank-k tier (dense only; the
        tolerance must be at least the tier's guaranteed bound)."""
        if tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {tolerance}")
        if rank is not None:
            if bw:
                raise ValueError("rank= (randomized tier) is dense-only")
            if tolerance < RAND_LU_RESIDUAL_BOUND:
                raise ValueError(
                    f"rank= produces factors guaranteed to {RAND_LU_RESIDUAL_BOUND:g} "
                    f"relative residual; request tolerance {tolerance:g} is tighter")
        fp = fingerprint(a, bw=bw)
        a, b = self._tensor(a), self._tensor(b)
        ticket = self._tickets
        self._tickets += 1
        req = SolveRequest(ticket=ticket, fp=fp, a=a, b=b, bw=bw, deadline=deadline,
                           tolerance=float(tolerance), rank=rank)
        n = int(a.shape[-2]) if bw else int(a.shape[-1])
        cols = 1 if b.ndim == 1 else int(b.shape[-1])
        self._sched.submit(req, bucket=("banded" if bw else "dense", n, bw, dtype_name(a.dtype),
                                        float(tolerance)),
                           cost=float(cols), deadline=deadline, real=cols)
        self.stats.requests += 1
        self._pending_tickets.add(ticket)
        return ticket

    def pending(self) -> int:
        return len(self._sched)

    def quarantined_fingerprints(self) -> set[str]:
        """Fingerprints currently in the negative cache."""
        return set(self._quarantine)

    # -- factorization cache ------------------------------------------------
    @staticmethod
    def _factor_tier(factors) -> float:
        """The accuracy tier of a factor object: an artifact's own tier, the
        rank-k tier's bound, 0.0 for pivoted (exact) factors."""
        if isinstance(factors, Factorization):
            return factors.tier
        return RAND_LU_RESIDUAL_BOUND if isinstance(factors, RankKFactors) else 0.0

    def _factors_for(self, req: SolveRequest, tolerance: float):
        tiers = self._lru.get(req.fp)
        if tiers is not None:
            # a cached tier serves the request iff it is at least as tight as
            # the request's tolerance; the tightest eligible tier wins
            eligible = [t for t in tiers if t <= tolerance]
            if eligible:
                self.stats.cache_hits += 1
                self._lru.move_to_end(req.fp)
                return tiers[min(eligible)]
        self.stats.cache_misses += 1
        # with screening on, a SolveFailure propagates out of these ops before
        # anything reaches the LRU: unhealthy factors are never admitted
        if req.bw:
            # enriched at factor time: many solves per factor pay for the
            # pre-inverted blocks
            factors = kops.banded_lu(req.a, bw=req.bw, tolerance=tolerance, health=self.health,
                                     enrich=True)
        elif req.rank is not None:
            factors = kops.lu(req.a, rank=req.rank, tolerance=tolerance, health=self.health)
        else:
            factors = kops.lu(req.a, tolerance=tolerance, health=self.health)
        if self.health:
            factors, _record = factors  # screened ops return (factors, health)
        if isinstance(factors, Factorization):
            factors = dataclasses.replace(factors, fingerprint=req.fp)
        self._lru.setdefault(req.fp, {})[self._factor_tier(factors)] = factors
        self._lru.move_to_end(req.fp)
        while len(self._lru) > self.cache_entries:
            self._lru.popitem(last=False)
            self.stats.cache_evictions += 1
        return factors

    # -- the flush ----------------------------------------------------------
    def flush(self) -> dict[int, object]:
        """Serve every pending request; returns ``{ticket: result}`` for the
        drained queue (results also stay redeemable through
        :meth:`result`).  A result is a solution tensor, a
        :class:`repro_torch.solvers.SolveFailure` (the request's group
        exhausted the escalation funnel, or its fingerprint is
        quarantined), or a :class:`DeadlineMiss`.  One group failing never
        disturbs the other groups of the flush."""
        counting = solvers.add_dispatch_hook(self._count_dispatch)
        escalating = solvers.add_escalation_hook(self._count_escalation)
        self._flush_count += 1
        for fp in [f for f, (exp, _) in self._quarantine.items() if exp < self._flush_count]:
            del self._quarantine[fp]
        drained = self._sched.drain()
        processed: set[int] = set()  # seq of every entry whose group completed
        results: dict[int, object] = {}
        try:
            now = self._clock() if self._clock is not None else None
            live = []
            for entry in drained:
                r = entry.payload
                if now is not None and r.deadline is not None and r.deadline < now:
                    results[r.ticket] = DeadlineMiss(ticket=r.ticket, deadline=r.deadline, now=now)
                    self.stats.shed_deadline += 1
                    processed.add(entry.seq)
                else:
                    live.append(entry)
            groups: OrderedDict[tuple, list] = OrderedDict()
            for entry in live:
                p = entry.payload
                # rank-tier requests coalesce apart from exact requests
                # against the same matrix: they want other factors
                groups.setdefault((p.fp, p.rank), []).append(entry)
            for (fp, _rank), entries in groups.items():
                reqs = [e.payload for e in entries]
                quarantined = self._quarantine.get(fp)
                if quarantined is not None:
                    for r in reqs:
                        results[r.ticket] = quarantined[1]
                    self.stats.quarantined += len(reqs)
                    processed.update(e.seq for e in entries)
                    continue
                # the tightest member tolerance governs the coalesced dispatch
                group_tol = min(r.tolerance for r in reqs)
                try:
                    factors = self._factors_for(reqs[0], group_tol)
                    # hit/miss accounting is per request: members past the
                    # leader skip the factorization too
                    self.stats.cache_hits += len(reqs) - 1
                    stacked, widths, squeezes = stack_rhs([r.b for r in reqs])
                    self.stats.solved_columns += int(stacked.shape[-1])
                    if len(reqs) > 1:
                        self.stats.coalesced_requests += len(reqs)
                    x = self._dispatch_solve(reqs[0], factors, stacked, group_tol)
                    if self.verify_residual:
                        self._check_residual(reqs[0], stacked, x, group_tol)
                except solvers.SolveFailure as failure:
                    # the whole group resolves to the failure value and the
                    # fingerprint enters the negative cache
                    for r in reqs:
                        results[r.ticket] = failure
                    self.stats.failed_requests += len(reqs)
                    self._quarantine[fp] = (self._flush_count + self.quarantine_ttl, failure)
                    processed.update(e.seq for e in entries)
                    continue
                for r, xr in zip(reqs, split_rhs(x, widths, squeezes)):
                    results[r.ticket] = xr
                processed.update(e.seq for e in entries)
            return results
        finally:
            solvers.remove_dispatch_hook(counting)
            solvers.remove_escalation_hook(escalating)
            # commit every completed group's answers even when a later group
            # raised; unprocessed entries go back to the queue with their
            # seq and deadline
            self._done.update(results)
            self._pending_tickets.difference_update(results)
            remaining = [e for e in drained if e.seq not in processed]
            if remaining:
                self._sched.restore(remaining)

    def _check_residual(self, req: SolveRequest, stacked, x, tolerance: float) -> None:
        """``verify_residual`` gate on the coalesced answer; a miss raises
        :class:`SolveFailure` into the group's failure handling."""
        bound = tolerance if tolerance > 0 else solvers.VERIFY_RESIDUAL_DEFAULT_BOUND
        rel = float(_health.relative_residual(req.a, stacked, x, bw=req.bw))
        if not rel <= bound:  # NaN-safe
            problem = solvers.Problem.from_arrays("linear_solve", req.a, stacked, bw=req.bw,
                                                  tolerance=tolerance, verify_residual=True)
            raise solvers.SolveFailure(
                f"coalesced solve residual {rel:.3e} > bound {bound:.1e} for {problem}",
                problem=problem, chain=[{"backend": "serve", "reason": f"residual {rel:.3e}"}])

    def _dispatch_solve(self, req: SolveRequest, factors, stacked, tolerance: float):
        """One coalesced substitution, chunked at the measured coalescing
        width when the autotune cache has one for this shape."""
        def run(cols):
            if req.bw:
                return kops.banded_solve(factors, cols, bw=req.bw, tolerance=tolerance)
            return kops.lu_solve(factors, cols, tolerance=tolerance)

        width = int(stacked.shape[-1])
        cap = None
        if not isinstance(factors, (RankKFactors, PivotedFactors)):
            # widths are measured for packed-factor substitution only
            problem = solvers.Problem.from_arrays("solve", factors, stacked, bw=req.bw,
                                                  tolerance=tolerance)
            cap = solvers.get_cache().best_width(problem)
        if cap and width > cap:
            pieces = [run(stacked[..., i:i + cap]) for i in range(0, width, cap)]
            self.stats.width_capped_dispatches += len(pieces) - 1
            x = torch.cat(pieces, dim=-1)
        else:
            x = run(stacked)
        if isinstance(factors, RankKFactors) and tolerance > 0.0:
            # polish the approximate answer to the group tolerance against
            # the full operand; the sweep count lands in stats
            x, info = _refine.iterative_refinement(req.a, stacked, x, run, tolerance=tolerance)
            self.stats.last_refine_iterations = info.iterations
        return x

    def result(self, ticket: int):
        """Redeem (pop) a flushed ticket.  Raises :class:`NotFlushed` when
        the ticket is still queued and :class:`UnknownTicket` when it was
        never issued or was already redeemed (both subclass ``KeyError``)."""
        try:
            return self._done.pop(ticket)
        except KeyError:
            pass
        if ticket in self._pending_tickets:
            raise NotFlushed(f"ticket {ticket} has not been flushed yet (call flush())")
        raise UnknownTicket(f"ticket {ticket} was never issued or already redeemed")

    def solve(self, a, b, *, bw: int = 0, tolerance: float = 0.0, rank: int | None = None):
        """submit + flush for one request.  Other pending requests flushed
        alongside stay redeemable through :meth:`result`.  A request that
        terminally failed raises its :class:`SolveFailure`."""
        ticket = self.submit(a, b, bw=bw, tolerance=tolerance, rank=rank)
        self.flush()
        out = self.result(ticket)
        if isinstance(out, solvers.SolveFailure):
            raise out
        return out

    def _count_dispatch(self, problem, backend) -> None:
        if problem.op == "factor":
            self.stats.factor_dispatches += 1
        elif problem.op in ("solve", "linear_solve"):
            self.stats.solve_dispatches += 1
            if backend.residual_bound is not None:
                self.stats.approx_solves += 1

    def _count_escalation(self, problem, failed, nxt, reason) -> None:
        self.stats.escalations += 1
