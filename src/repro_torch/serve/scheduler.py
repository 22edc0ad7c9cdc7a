"""Shape-bucketed request queue with EBV-style equalized slot filling.

The scheduler is the admission layer shared by the generation engine
(:mod:`repro_torch.serve.engine`) and the linear-system
front end (:mod:`repro_torch.serve.solve_service`).  It is the reference's
``serve/scheduler.py`` as it is: plain Python, no tensors.  It is
payload-agnostic: callers submit opaque payloads tagged with a *bucket*
(the dispatch shape the payload pads to — prompt-length bucket for LM
requests, ``(structure, n, bw, dtype)`` for solve requests), a *cost*
estimate, and an optional *deadline*.

Ordering is earliest-deadline-first, then FIFO.  Requests that carry a
deadline are never reordered past one another and always admit ahead of
deadline-free traffic.

**Equalized slot filling** (the paper's eq.-7 pairing, applied to the
request queue): when ``k`` slots free simultaneously, picking the first
``k`` FIFO requests can hand every slot a heavy request — they all finish
late together and the next dispatches run underfull.  Instead the scheduler
looks at a bounded window (``2k``) of deadline-free eligible requests,
sorts it by cost, and picks ``k`` via the fold order
(:func:`repro_torch.core.ebv.fold_index`: heaviest, lightest, 2nd-heaviest,
2nd-lightest, …) so each admitted batch mixes long- and short-lived
occupants and the slots turn over at staggered, balanced times — every
decode dispatch stays a full batch.  The window bound keeps the reordering
fair: a request can be overtaken at most once before it is in the front
``k`` of the window and must be picked.

Padding accounting: the caller reports real vs padded sizes at submission
(``real=``, ``padded=``); ``stats.padding_frac`` is the fraction of
dispatched prompt tokens that were bucket padding.

**Page-granular equalized filling** (paged serving engine): with a paged KV
cache the unit of slot occupancy is the fixed-size *page*, not the dense
``max_len`` row — the same equalization the paper applies to elimination
vectors, applied to storage: every allocation is page-shaped, so the fold
pick mixes page-heavy and page-light requests exactly as it mixes
long/short-lived occupants, and the pool fills uniformly with no
per-slot reservation.  Requests carry their prompt's page-block
fingerprint chain in ``ScheduledRequest.prefix`` (computed once at
submission — the reference's ``serve/paged.py:prefix_chain``), so the engine's
admission step can map shared leading pages to refcounted pool pages and
skip the shared part of the prefill.  Two fragmentation axes are
reported: ``padding_frac`` (bucket padding inside the prefill dispatch)
and ``page_frac`` (internal fragmentation of partially-filled last pages,
from the engine's ``live_tokens`` / ``page_tokens`` accounting).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Hashable

from ..core.ebv import fold_index

__all__ = ["ScheduledRequest", "SchedulerStats", "Scheduler", "bucket_length"]


def bucket_length(n: int, bucket: int) -> int:
    """Round ``n`` up to the enclosing shape bucket (multiple of ``bucket``)."""
    if bucket <= 1:
        return n
    return -(-n // bucket) * bucket


@dataclasses.dataclass
class ScheduledRequest:
    """One queue entry.  ``cost`` is the slot-occupancy estimate the
    equalizer balances (for LM requests: padded prompt + new tokens)."""

    payload: Any
    bucket: Hashable
    cost: float = 1.0
    deadline: float | None = None
    seq: int = 0
    real: int = 0
    padded: int = 0
    # prompt page-block fingerprint chain (list of digests) for paged
    # shared-prefix admission; None for non-paged traffic
    prefix: Any = None

    @property
    def priority(self) -> tuple:
        return (self.deadline if self.deadline is not None else math.inf, self.seq)


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    admitted: int = 0
    real_tokens: int = 0
    padding_tokens: int = 0
    equalized_picks: int = 0
    # admissions whose return order was permuted toward even per-shard load
    # (mesh-sharded engine only; 0 for single-shard serving)
    shard_balanced: int = 0
    # paged-engine fragmentation accounting (filled at slot retirement):
    # live_tokens = tokens a request actually occupied, page_tokens = the
    # page-rounded allocation that backed them
    live_tokens: int = 0
    page_tokens: int = 0

    @property
    def padding_frac(self) -> float:
        tot = self.real_tokens + self.padding_tokens
        return self.padding_tokens / tot if tot else 0.0

    @property
    def page_frac(self) -> float:
        """Internal fragmentation: fraction of allocated page slots left
        empty by partially-filled last pages (0.0 for dense serving)."""
        if not self.page_tokens:
            return 0.0
        return (self.page_tokens - self.live_tokens) / self.page_tokens


class Scheduler:
    def __init__(self):
        self._queue: list[ScheduledRequest] = []
        self._seq = itertools.count()
        self.stats = SchedulerStats()

    def __len__(self) -> int:
        return len(self._queue)

    def submit(
        self,
        payload: Any,
        *,
        bucket: Hashable = None,
        cost: float = 1.0,
        deadline: float | None = None,
        real: int = 0,
        padded: int = 0,
        prefix: Any = None,
    ) -> ScheduledRequest:
        req = ScheduledRequest(
            payload=payload, bucket=bucket, cost=cost, deadline=deadline,
            seq=next(self._seq), real=real, padded=padded, prefix=prefix,
        )
        self._queue.append(req)
        self.stats.submitted += 1
        return req

    def buckets(self) -> dict[Hashable, int]:
        """Pending request count per shape bucket."""
        out: dict[Hashable, int] = {}
        for r in self._queue:
            out[r.bucket] = out.get(r.bucket, 0) + 1
        return out

    def take(
        self,
        k: int,
        *,
        equalize: bool = True,
        shards: list[int] | None = None,
        shard_load: list[float] | None = None,
    ) -> list[ScheduledRequest]:
        """Admit up to ``k`` requests.

        Deadline-bearing requests go first, in strict EDF order.  Remaining
        slots fill from the FIFO front window of deadline-free requests with
        the equalized fold pick (see module docstring); ``equalize=False``
        degrades to plain FIFO.

        **Shard-occupancy-aware ordering** (mesh-sharded engine):
        ``shards[i]`` names the shard of the i-th slot the caller will fill
        with the i-th returned request, and ``shard_load`` carries the live
        cost per shard.  The *choice* of requests is unchanged — only their
        return order is permuted, heaviest-cost request to
        lightest-loaded target shard (the eq.-7 pairing applied across the
        mesh), so equalized slot filling balances live tokens per shard
        instead of stacking the heavy picks on whichever shard's slots
        freed first."""
        if k <= 0 or not self._queue:
            return []
        with_dl = sorted(
            (r for r in self._queue if r.deadline is not None), key=lambda r: r.priority
        )
        picked: list[ScheduledRequest] = with_dl[:k]
        rest = k - len(picked)
        if rest > 0:
            fifo = sorted(
                (r for r in self._queue if r.deadline is None), key=lambda r: r.seq
            )
            window = fifo[: 2 * rest]
            if equalize and len(window) > rest:
                by_cost = sorted(window, key=lambda r: (-r.cost, r.seq))
                picked += [by_cost[fold_index(i, len(by_cost))] for i in range(rest)]
                self.stats.equalized_picks += rest
            else:
                picked += window[:rest]
        for r in picked:
            self._queue.remove(r)
            self.stats.admitted += 1
            self.stats.real_tokens += r.real
            self.stats.padding_tokens += r.padded
        if shards is not None and len(set(shards[: len(picked)])) > 1:
            picked = self._balance_shards(
                picked, shards[: len(picked)], shard_load
            )
        return picked

    def _balance_shards(
        self,
        picked: list[ScheduledRequest],
        shards: list[int],
        shard_load: list[float] | None,
    ) -> list[ScheduledRequest]:
        """Permute ``picked`` so position i (→ a slot on ``shards[i]``)
        receives the request that keeps per-shard live cost most even:
        greedily hand the heaviest remaining request to the target slot
        whose shard currently carries the least cost (deadline holders keep
        EDF order among themselves — only their slot assignment moves)."""
        nsh = max(shards) + 1
        load = list(shard_load) + [0.0] * (nsh - len(shard_load or [])) \
            if shard_load else [0.0] * nsh
        by_cost = sorted(
            range(len(picked)), key=lambda i: (-picked[i].cost, picked[i].seq)
        )
        slots_left = list(range(len(picked)))
        out: list[ScheduledRequest | None] = [None] * len(picked)
        for i in by_cost:
            pos = min(slots_left, key=lambda s: (load[shards[s]], s))
            slots_left.remove(pos)
            out[pos] = picked[i]
            load[shards[pos]] += picked[i].cost
        self.stats.shard_balanced += len(picked)
        return [r for r in out if r is not None]

    def drain(self) -> list[ScheduledRequest]:
        """All pending requests in priority order (used by batch front ends
        that coalesce the whole queue, e.g. the solve service)."""
        out = sorted(self._queue, key=lambda r: r.priority)
        for r in out:
            self.stats.admitted += 1
            self.stats.real_tokens += r.real
            self.stats.padding_tokens += r.padded
        self._queue.clear()
        return out

    def restore(self, entries: list[ScheduledRequest]) -> None:
        """Return un-processed ``drain``/``take`` entries to the queue.

        Transactional callers (a flush that fails mid-way) must not lose the
        remainder of the batch.  Entries keep their original ``seq`` and
        ``deadline``, so re-draining preserves the original order, and the
        admission accounting is reversed so stats reflect only work actually
        handed off."""
        for r in entries:
            self._queue.append(r)
            self.stats.admitted -= 1
            self.stats.real_tokens -= r.real
            self.stats.padding_tokens -= r.padded
