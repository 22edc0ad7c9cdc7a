"""Paged KV-cache bookkeeping: page pool, prefix fingerprints, prefix cache.

The serving engine's paged mode replaces one dense ``(max_len)`` KV row per
slot with fixed-size **pages** drawn from a shared pool — the serving-side
analogue of the EBV paper's equalized work unit: every allocation is the
same size, so heterogeneous sequence lengths fill the pool uniformly
instead of fragmenting it, and capacity scales with *live tokens* rather
than ``slots × max_len``.

Three pieces, all host-side (tensors never live here):

* :class:`PagePool` — free-list allocator over ``num_pages`` page ids with
  per-page refcounts.  Page 0 is reserved as the **scrap page**: idle
  page-table rows point at it so stale decode writes from retired slots
  land harmlessly; it is never allocated and never read by a live row.
  A mesh-sharded engine uses one pool per shard over disjoint global id
  ranges (:class:`ShardedPagePool`), each with its own shard-local scrap.
* :func:`prefix_chain` — sha1 chain over page-size token blocks (the same
  bytes+shape+dtype fingerprint shape as the ``SolveService`` matrix
  fingerprint), one digest per *full* page of prompt.  Digest ``j`` commits
  to blocks ``0..j``, so equal chain prefixes imply equal token prefixes.
* :class:`PrefixCache` — maps chain digests to pool pages holding the
  already-computed K/V for that prompt prefix.  A lookup retains the hit
  pages for the caller (refcounted, read-only sharing); insertion retains
  one index reference per page.  Eviction is LRU over entries whose pages
  no live slot references.

Copy-on-write is structural: shared pages are never written — the engine
only shares *full* prompt pages strictly before the first decode-write
position, and a divergent prompt stops matching the chain at its first
divergent block, so its tail K/V is recomputed into freshly-owned pages.
"""
from __future__ import annotations

import hashlib
from collections import deque

import numpy as np

__all__ = ["PagePool", "ShardedPagePool", "PrefixCache", "prefix_chain"]

#: Reserved scrap page id — sink for writes from idle page-table rows.
SCRAP_PAGE = 0


class PagePool:
    """Free-list allocator of fixed-size KV pages with refcounts.

    ``num_pages`` counts device pages including the reserved scrap page 0,
    so ``capacity == num_pages - 1`` pages are allocatable.  ``alloc`` is
    all-or-nothing: a request that cannot get every page it needs gets
    none, so a partially-admitted slot can never corrupt live pages.

    ``base`` offsets every page id by a constant: a mesh-sharded engine
    gives each shard its own pool over the global id range
    ``[base, base + num_pages)`` (shard k of a pool axis laid out over the
    mesh owns exactly that contiguous page block), with id ``base`` as the
    shard-local scrap page so idle rows of that shard's slots sink writes
    without crossing shards.  ``base == 0`` (the default) is the historical
    single-pool layout, scrap page 0 included.
    """

    def __init__(self, num_pages: int, page_size: int, *, base: int = 0):
        if num_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (1 is reserved scrap), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if base < 0:
            raise ValueError(f"base must be >= 0, got {base}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.base = int(base)
        self._free: deque[int] = deque(range(base + 1, base + num_pages))
        self._ref = [0] * num_pages  # indexed by (page - base)
        self.peak_used = 0
        self.failed_allocs = 0

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` pages (refcount 1 each), or ``None`` if short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            self.failed_allocs += 1
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p - self.base] = 1
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def retain(self, pages: list[int]) -> None:
        for p in pages:
            if p == self.base or self._ref[p - self.base] <= 0:
                raise ValueError(f"retain of unallocated page {p}")
            self._ref[p - self.base] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            if p == self.base or self._ref[p - self.base] <= 0:
                raise ValueError(f"release of unallocated page {p}")
            self._ref[p - self.base] -= 1
            if self._ref[p - self.base] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return self._ref[page - self.base]

    def writable(self, page: int) -> bool:
        """A page is safe to write only while exactly one holder owns it."""
        return self._ref[page - self.base] == 1


class ShardedPagePool:
    """Per-shard :class:`PagePool` s over disjoint global page-id ranges.

    The mesh-sharded engine lays the KV page pool over a mesh axis: shard
    ``k`` of ``shards`` owns the contiguous global ids
    ``[k·P, (k+1)·P)`` (``P = pages_per_shard``), i.e. exactly the page
    block a ``PartitionSpec`` over the pool's page axis would place on
    device ``k`` — so every page a slot touches (scrap included) is local
    to the slot's shard, and allocation pressure is tracked per shard
    (occupancy feeds the scheduler's shard-balanced admission).

    The facade mirrors the single-pool API where the engine consumes it;
    ``alloc`` additionally takes the target shard (all-or-nothing within
    that shard — pages are never borrowed across shards, locality is the
    point), and ``release``/``retain`` route by id range.
    """

    def __init__(self, shards: int, pages_per_shard: int, page_size: int):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.shards = int(shards)
        self.pages_per_shard = int(pages_per_shard)
        self.page_size = int(page_size)
        self.pools = [
            PagePool(pages_per_shard, page_size, base=k * pages_per_shard)
            for k in range(shards)
        ]
        self.num_pages = shards * self.pages_per_shard

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    def scrap(self, shard: int) -> int:
        """The shard-local scrap page id (idle page-table rows of that
        shard's slots point here)."""
        return self.pools[shard].base

    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self.pools)

    @property
    def shard_capacity(self) -> int:
        """Allocatable pages per shard — the binding per-request bound (a
        request's pages never span shards)."""
        return self.pages_per_shard - 1

    @property
    def free(self) -> int:
        return sum(p.free for p in self.pools)

    @property
    def used(self) -> int:
        return sum(p.used for p in self.pools)

    @property
    def peak_used(self) -> int:
        return sum(p.peak_used for p in self.pools)

    @property
    def failed_allocs(self) -> int:
        return sum(p.failed_allocs for p in self.pools)

    def shard_used(self) -> list[int]:
        """Live page count per shard (the scheduler's occupancy signal)."""
        return [p.used for p in self.pools]

    def alloc(self, n: int, shard: int = 0) -> list[int] | None:
        return self.pools[shard].alloc(n)

    def _by_shard(self, pages: list[int]) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for p in pages:
            out.setdefault(self.shard_of(p), []).append(p)
        return out

    def retain(self, pages: list[int]) -> None:
        for k, ps in self._by_shard(pages).items():
            self.pools[k].retain(ps)

    def release(self, pages: list[int]) -> None:
        for k, ps in self._by_shard(pages).items():
            self.pools[k].release(ps)

    def refcount(self, page: int) -> int:
        return self.pools[self.shard_of(page)].refcount(page)

    def writable(self, page: int) -> bool:
        return self.pools[self.shard_of(page)].writable(page)


def prefix_chain(tokens, page_size: int, *, salt: str = "") -> list[str]:
    """sha1 chain over full page-size blocks of a prompt.

    Digest ``j`` hashes (digest ``j-1``, block ``j`` bytes, shape, dtype,
    page size) — the SolveService fingerprint shape — so two prompts share
    a chain prefix of length ``h`` iff their first ``h`` pages of tokens
    are identical.  Partial trailing blocks are never fingerprinted: a
    page must be *full* to be shareable.

    ``salt`` seeds the chain: the engine passes the request's bucket
    length, because prefix K/V is bitwise-reproducible only between
    prompts prefilled at the SAME padded length (the attention reduction
    axis is the bucket length; different buckets round differently in the
    last ulp).  Salting keeps every cache hit exact rather than
    approximately-equal.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    chain: list[str] = []
    digest = hashlib.sha1(f"chain|{salt}".encode()).digest() if salt else b"\x00" * 20
    for j in range(toks.size // page_size):
        blk = toks[j * page_size : (j + 1) * page_size]
        h = hashlib.sha1(digest)
        h.update(blk.tobytes())
        h.update(f"|{blk.shape}|{blk.dtype}|{page_size}".encode())
        digest = h.digest()
        chain.append(h.hexdigest())
    return chain


class PrefixCache:
    """LRU index from prefix-chain digests to read-only pool pages.

    Each entry holds one pool reference; a lookup hit retains one more per
    page *for the caller* (the engine releases them at slot retirement).
    Entries are evicted LRU-first, but only when no live slot still
    references the page (``refcount == 1``).  Evicting a mid-chain entry
    orphans its suffix digests — they can no longer be hit, are never
    LRU-bumped, and age out on later sweeps.
    """

    def __init__(self, pool: PagePool):
        self._pool = pool
        self._pages: dict[str, int] = {}  # insertion order == LRU order
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    def __len__(self) -> int:
        return len(self._pages)

    @property
    def pages(self) -> dict[str, int]:
        return dict(self._pages)

    def lookup(self, chain: list[str]) -> list[int]:
        """Longest cached prefix of ``chain``; retains the hit pages."""
        got: list[int] = []
        for digest in chain:
            page = self._pages.get(digest)
            if page is None:
                break
            got.append(page)
            self._pages[digest] = self._pages.pop(digest)  # bump to MRU
        if got:
            self._pool.retain(got)
            self.hits += 1
            self.hit_tokens += len(got) * self._pool.page_size
        else:
            self.misses += 1
        return got

    def insert(self, chain: list[str], pages: list[int]) -> None:
        """Index ``pages[j]`` as the K/V for chain block ``j`` (dedup)."""
        for digest, page in zip(chain, pages):
            if digest in self._pages:
                continue
            self._pool.retain([page])
            self._pages[digest] = page

    def evict(self, need_free: int) -> int:
        """Drop LRU entries (only index-held pages) until the pool has
        ``need_free`` free pages; returns the number of pages freed."""
        freed = 0
        for digest, page in list(self._pages.items()):
            if self._pool.free >= need_free:
                break
            if self._pool.refcount(page) == 1:
                del self._pages[digest]
                self._pool.release([page])
                freed += 1
        return freed

    def clear(self) -> int:
        """Drop every index reference (pages pinned by live slots survive
        until those slots retire)."""
        n = len(self._pages)
        for digest, page in list(self._pages.items()):
            del self._pages[digest]
            self._pool.release([page])
        return n
