"""Slot-based continuous-batching serving engine, dense and paged.

The engine owns a fixed grid of ``slots`` batch rows over one KV cache and
two entry points:

* prefill — the forward pass of ONE shape-bucketed prompt ((1, bucket_len)),
  returning the request's cache rows and the logits at its true last token
  (``last=``; right-pad tokens are causally inert);
* decode — one token for EVERY slot ((slots, 1)) at per-row positions.

Slot lifecycle, as the reference's ``serve/engine.py``: a request admitted
from the scheduler is prefilled and its cache rows go into a free slot
(``pos`` entries past the true prompt length forced to −1, so pad K/V never
match); the slot rides every decode step until its token budget is spent;
then its row of the device-side output buffer is read back (once per
request, no per-token host sync) and the slot is refilled mid-stream from
the queue.  Every per-row computation is independent of the other rows, so
a request's tokens do not depend on its slot or on what else is in flight.

**Paged mode** (``paged=True``): the attention cache is a shared pool of
fixed-size pages (:mod:`repro_torch.serve.paged`); each slot holds a page
table, and decode attention resolves it in one kernel launch per layer
(:func:`repro_torch.kernels.paged_attn.paged_decode_attention`).  Full
prompt pages strictly before the first decode write are shared through a
refcounted prefix index (keyed by a fingerprint chain salted with the
bucket length), so a shared page is never written: copy-on-write is
structural.  When the pool runs dry, admission queues
(``Scheduler.restore``).  The pool persists across ``serve()`` calls.

**EOS early exit**: requests with ``eos_token`` keep a device-side done
flag and truncation index beside the output buffer; the flags are read
every ``eos_poll`` decode steps and finished slots retire early.

**The encdec family** (whisper): the encoder length follows the padded
prompt length, so one ``serve()`` call pads every prompt to one bucket, the
largest request's, and the encoder runs over ``max(bucket // 4, 1)`` stub
frames (:func:`repro_torch.models.lm.stub_frames`, seed 0: the same frames
for every prompt).  A prefill's cross K/V goes into its slot's row of the
per-slot cross caches, which the paged mode keeps dense beside the pool,
made anew for each call's slots.  Prefix reuse stays with the dense family.

**The moe family** (mixtral, granite): the MoE layer's capacity counts
every row of a call, so idle slots in decode and bucket pads in prefill
share it with the live rows, as in the reference.  Sliding-window configs
(mixtral) serve dense only, their cache a ring of ``window`` slots; a
prompt whose bucket would pass the window is prefilled at its exact length
(:meth:`Engine._bucket_len`).

**The ssm and hybrid families** (mamba2; hymba, whose attention has a
window) serve dense only: the ssm family has no attention cache to page.
A prefill hands the mixer each row's true length, so a bucket-padded
prompt leaves the state and conv tails of the prompt alone, and
:func:`_insert_slot` copies those leaves (``conv_*``, ``state``) into the
slot's row beside the attention ring.

Departures from the reference, by design: there is no ``jax.jit`` (the
engine runs eagerly); sampled decoding (``temperature > 0``) draws from a
per-request ``torch.Generator`` seeded by ``GenRequest.seed``, so only
greedy decoding reproduces the reference's tokens; ``shards > 1`` and
``mesh=`` (mesh-sharded pools) raise, naming ROADMAP A7.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device
from ..configs.base import ModelConfig
from ..models import lm
from ..solvers.cache import get_cache
from ..solvers.problem import Problem
from .paged import PagePool, PrefixCache, prefix_chain
from .scheduler import Scheduler, bucket_length

__all__ = ["GenRequest", "EngineStats", "Engine"]


@dataclasses.dataclass
class GenRequest:
    """One generation request.  ``seed`` alone determines the sampling
    stream (slot- and batch-independent)."""

    tokens: np.ndarray  # (S0,) int32 prompt
    max_new_tokens: int = 32
    temperature: float = 0.0
    seed: int = 0
    deadline: float | None = None
    # stop early when this token is sampled (the output truncates at and
    # includes it); None keeps the fixed max_new_tokens budget
    eos_token: int | None = None


@dataclasses.dataclass
class EngineStats:
    prefill_dispatches: int = 0
    decode_dispatches: int = 0
    generated_tokens: int = 0
    padding_frac: float = 0.0
    # ("prefill", request_index) / ("decode", active_slot_count) in issue order
    events: list = dataclasses.field(default_factory=list)
    sched: object | None = None  # SchedulerStats of the last serve() call
    # paged mode
    prefix_hits: int = 0        # admissions that reused >= 1 cached page
    prefix_hit_tokens: int = 0  # prompt tokens whose prefill was skipped
    page_frac: float = 0.0      # partial-last-page fragmentation (sched)
    peak_active: int = 0        # max concurrently occupied slots
    pool_peak_pages: int = 0    # engine-lifetime peak pool occupancy
    # peak concurrent live cost per shard (one shard here)
    shard_peak_cost: list = dataclasses.field(default_factory=list)
    early_exits: int = 0        # slots retired before their token budget

    @property
    def tokens_per_dispatch(self) -> float:
        return self.generated_tokens / max(self.decode_dispatches + self.prefill_dispatches, 1)


def _multi_shard() -> NotImplementedError:
    return NotImplementedError("mesh-sharded serving (shards > 1, mesh=) is not ported to "
                               "repro_torch yet (ROADMAP A7)")


class Engine:
    def __init__(
        self, params: lm.LM, cfg: ModelConfig, *, max_len: int = 512, slots: int = 4,
        bucket: int = 1, paged: bool = False, page_size: int | None = None,
        pool_pages: int | None = None, prefix_reuse: bool = True, eos_poll: int = 4,
        shards: int = 1, mesh=None,
    ):
        if mesh is not None:
            raise _multi_shard()
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > 1:
            raise _multi_shard()
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.bucket = bucket
        self.paged = paged
        self.eos_poll = max(int(eos_poll), 1)
        self.stats = EngineStats()
        self.device = None if params is None else params.embed.device
        if paged:
            if cfg.sliding_window is not None:
                raise ValueError(
                    "paged KV cache does not support sliding-window archs "
                    "(the ring layout is position-modular, pages are not)"
                )
            if cfg.family == "ssm":
                raise ValueError("pure-SSM archs have no attention KV cache to page")
            page_size = int(page_size or self._default_page_size(max_len))
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if prefix_reuse and cfg.family == "dense" and bucket > 1 and page_size % bucket != 0:
                raise ValueError(
                    f"prefix sharing needs page_size ({page_size}) to be a "
                    f"multiple of bucket ({bucket}) so a shared prefix plus "
                    "a bucketed tail reproduces the cold bucket length; pass "
                    "prefix_reuse=False to page without sharing"
                )
            self.page_size = page_size
            self.max_len = -(-max_len // page_size) * page_size
            self.pages_per_slot = self.max_len // page_size
            self.pool = PagePool(pool_pages or slots * self.pages_per_slot + 1, page_size)
            # prefix K/V is reproducible bit for bit only for plain sequence
            # positions with no prompt offset: the dense family exactly
            self.prefix_cache = PrefixCache(self.pool) if prefix_reuse and cfg.family == "dense" \
                else None
            self._pages = None  # the persistent {"k_pages","v_pages"} pool tensors
        else:
            self.max_len = max_len
            self.pool = None
            self.prefix_cache = None

    def _default_page_size(self, max_len: int) -> int:
        """The autotuned page size where a transferable sweep was recorded
        (op="decode", structure="paged_kv"); 16 where none was."""
        best = get_cache().best_page_size(Problem(
            op="decode", structure="paged_kv", n=max_len, dtype=self.cfg.dtype,
            device=_device.device_name(self.params.embed)))
        return int(best) if best else 16

    # ------------------------------------------------------------------
    # paged-cache helpers
    # ------------------------------------------------------------------
    def _request_pages(self, s0: int, lb: int, max_new: int) -> int:
        """Pages a request occupies end to end: the padded prefill width or
        the final sequence length, whichever rounds to more pages."""
        return -(-max(lb, s0 + max_new) // self.page_size)

    def _paged_caches(self, nslots: int, enc_len: int) -> dict:
        """This call's caches: the pool tensors, made on the first call and
        kept across serve() calls (prefix hits read pages written by earlier
        calls), beside the per-slot parts (encdec's cross K/V), made anew
        for ``nslots`` slots."""
        if self._pages is None:
            self._pages = lm.init_paged_caches(self.cfg, nslots, self.pool.num_pages,
                                               self.page_size, device=self.device)["attn"]
        caches = lm.init_caches(self.cfg, nslots, 0, enc_len=enc_len, device=self.device)
        caches["attn"] = self._pages
        return caches

    def _gather_prior(self, caches, pages: list[int]) -> dict:
        """The prior-prefix K/V (L, 1, Sp, KV, Dh) of a warm prefill, read
        from the hit pool pages."""
        idx = torch.as_tensor(pages, device=self.device)

        def sel(pool):
            nl, _, pg, kv, dh = pool.shape
            return pool[:, idx].reshape(nl, 1, len(pages) * pg, kv, dh)

        return {"k": sel(caches["attn"]["k_pages"]), "v": sel(caches["attn"]["v_pages"])}

    def _scatter_pages(self, caches, raw, pages: list[int]) -> None:
        """Write fresh prefill K/V ({"k","v"}: (L, 1, S, KV, Dh)) into pool
        ``pages`` (page j of the suffix → pages[j]), in place.  Pad K/V past
        the true prompt lands too but is never read: decode writes position
        ``cur`` before it attends with length ``cur + 1``."""
        if not pages:
            return
        idx = torch.as_tensor(pages, device=self.device)
        pg = self.page_size
        for name, fresh in (("k_pages", raw["k"]), ("v_pages", raw["v"])):
            pool = caches["attn"][name]
            nl, _, s, kv, dh = fresh.shape
            pad = len(pages) * pg - s
            if pad:
                fresh = torch.nn.functional.pad(fresh, (0, 0, 0, 0, 0, pad))
            pool[:, idx] = fresh.reshape(nl, len(pages), pg, kv, dh).to(pool.dtype)

    def _bucket_len(self, s0: int, fixed: int | None) -> int:
        """A prompt's padded prefill length: ``fixed`` (encdec's one bucket a
        call) or its bucket; for a sliding-window config the exact length
        where the padded one would pass the window, since the prefill ring
        keeps only the last ``window`` positions and pads past it would evict
        prompt K/V before :func:`_insert_slot` masks them."""
        lb = fixed if fixed is not None else bucket_length(s0, self.bucket)
        w = self.cfg.sliding_window
        return s0 if w is not None and lb > w else lb

    def _model_batch(self, tokens: np.ndarray) -> dict:
        """The model's input of prompt rows (b, s): the tokens, and for the
        encdec family the frontend stub's (b, max(s // 4, 1), d) frames."""
        if self.cfg.family == "encdec":
            b, s = tokens.shape
            return {"tokens": tokens,
                    "frames": lm.stub_frames(b, max(s // 4, 1), self.cfg, 0, device=self.device)}
        return {"tokens": tokens}

    # ------------------------------------------------------------------
    # continuous-batching serve loop
    # ------------------------------------------------------------------
    def serve(self, requests, *, slots: int | None = None, equalize: bool = True) -> list[np.ndarray]:
        """Serve ``requests`` (GenRequests) to completion; returns, per
        request (input order), the (S0_i + generated_i,) int32 token array."""
        reqs = list(requests)
        if not reqs:
            return []
        nslots = min(slots or self.slots, len(reqs))
        # encdec: the cross caches' length follows the padded prompt's, so
        # ONE bucket, the largest request's, serves the whole call
        fixed = max(bucket_length(len(r.tokens), self.bucket) for r in reqs) \
            if self.cfg.family == "encdec" else None

        def padded(s0: int) -> int:
            return self._bucket_len(s0, fixed)

        for r in reqs:
            if r.max_new_tokens < 1:
                raise ValueError(
                    f"max_new_tokens must be >= 1, got {r.max_new_tokens} "
                    "(the first token comes from prefill; a slot holding a "
                    "zero-budget request would never retire)"
                )
            lb = padded(len(r.tokens))
            if lb + r.max_new_tokens > self.max_len:
                raise ValueError(f"max_len {self.max_len} is too small for a request of "
                                 f"{lb} padded prompt and {r.max_new_tokens} new tokens")
            if self.paged:
                need = self._request_pages(len(r.tokens), lb, r.max_new_tokens)
                cap = self.pool.capacity
                if need > cap:
                    raise ValueError(
                        f"request needs {need} pages of {self.page_size} but the pool only "
                        f"holds {cap}; raise pool_pages to at least {need + 1} (one page per "
                        "pool is reserved scrap)"
                    )

        sched = Scheduler()
        pcache = self.prefix_cache
        for i, r in enumerate(reqs):
            s0 = len(r.tokens)
            lb = padded(s0)
            # salt = the bucket length: prefix K/V is bitwise-exact only
            # between prompts prefilled at the same padded length
            chain = prefix_chain(r.tokens, self.page_size, salt=f"lb={lb}") \
                if pcache is not None else None
            sched.submit((i, r), bucket=lb, cost=lb + r.max_new_tokens, deadline=r.deadline,
                         real=s0, padded=lb - s0, prefix=chain)

        self.stats = stats = EngineStats()
        dev = self.device
        enc_len = max(fixed // 4, 1) if fixed else 0
        if self.paged:
            caches = self._paged_caches(nslots, enc_len)
            # idle rows sink their writes into the scrap page 0
            page_table = torch.zeros((nslots, self.pages_per_slot), dtype=torch.int32, device=dev)
        else:
            caches = lm.init_caches(self.cfg, nslots, self.max_len, enc_len=enc_len, device=dev)
            page_table = None
        out_cap = max(r.max_new_tokens for r in reqs)
        rows = torch.arange(nslots, device=dev)
        tok = torch.zeros((nslots, 1), dtype=torch.long, device=dev)
        pos = torch.zeros((nslots,), dtype=torch.int32, device=dev)
        temps = [0.0] * nslots
        gens: list[torch.Generator | None] = [None] * nslots
        out_buf = torch.zeros((nslots, out_cap), dtype=torch.long, device=dev)
        out_idx = torch.zeros((nslots,), dtype=torch.long, device=dev)
        # device-side EOS state, read every eos_poll steps
        any_eos = any(r.eos_token is not None for r in reqs)
        eos_vec = torch.full((nslots,), -1, dtype=torch.long, device=dev)
        done = torch.zeros((nslots,), dtype=torch.bool, device=dev)
        done_idx = torch.full((nslots,), out_cap, dtype=torch.long, device=dev)
        eos_countdown = self.eos_poll
        active: list[dict | None] = [None] * nslots
        results: list[np.ndarray | None] = [None] * len(reqs)
        live_cost = 0.0  # admitted cost in flight

        def finish(slot):
            nonlocal live_cost
            st = active[slot]
            r = reqs[st["rid"]]
            live_cost -= st["cost"]
            if r.eos_token is not None:
                # output row ++ truncation index: still ONE transfer per request
                packed = torch.cat([out_buf[slot], done_idx[slot, None]]).cpu().numpy()
                n = min(int(packed[-1]), r.max_new_tokens)
                new = packed[:n]
            else:
                n = r.max_new_tokens
                new = out_buf[slot, :n].cpu().numpy()  # ONE transfer
            results[st["rid"]] = np.concatenate([np.asarray(r.tokens, np.int32),
                                                 new.astype(np.int32)])
            stats.generated_tokens += n
            if self.paged:
                self.pool.release(st["pages"])
                page_table[slot] = 0  # → scrap
                sched.stats.live_tokens += st["valid"] + n
                sched.stats.page_tokens += len(st["pages"]) * self.page_size
            active[slot] = None

        while len(sched) or any(active):
            free = [s for s in range(nslots) if active[s] is None]
            if free and len(sched):
                taken = sched.take(len(free), equalize=equalize)
                while taken:
                    sr = taken.pop(0)
                    slot = free.pop(0)
                    rid, r = sr.payload
                    s0 = len(r.tokens)
                    lb = padded(s0)
                    hit_pages: list[int] = []
                    new_pages: list[int] = []
                    prior = None
                    if self.paged:
                        if pcache is not None and sr.prefix:
                            # stop strictly before the last prompt token: at
                            # least one suffix token is prefilled (the logits
                            # source), and with the s0 // page insert limit
                            # below a shared page is never decode-written
                            hit_pages = pcache.lookup(sr.prefix[: (s0 - 1) // self.page_size])
                        need = self._request_pages(s0, lb, r.max_new_tokens)
                        need_new = need - len(hit_pages)
                        new_pages = self.pool.alloc(need_new)
                        if new_pages is None and pcache is not None:
                            pcache.evict(need_new)
                            new_pages = self.pool.alloc(need_new)
                        if new_pages is None:
                            # pool exhausted: queue the rest of the batch
                            # rather than corrupt live pages
                            if hit_pages:
                                self.pool.release(hit_pages)
                            if not any(a is not None for a in active):
                                raise RuntimeError(
                                    "page pool exhausted with no slot in flight: per-request "
                                    "capacity was checked up front, so only the prefix index "
                                    "can pin pages, and evict() should have freed them"
                                )
                            sched.restore([sr] + taken)
                            free.insert(0, slot)
                            break
                    shared = len(hit_pages) * (self.page_size if self.paged else 0)
                    if hit_pages:
                        prior = self._gather_prior(caches, hit_pages)
                        stats.prefix_hits += 1
                        stats.prefix_hit_tokens += shared
                    tail, tail_lb = s0 - shared, lb - shared
                    prompt = np.zeros((1, tail_lb), np.int32)
                    prompt[0, :tail] = np.asarray(r.tokens[shared:], np.int32)
                    last = [tail - 1]
                    batch = self._model_batch(prompt)
                    if self.paged:
                        new_caches, logits = lm.prefill(self.params, batch, self.cfg, last=last,
                                                        prior=prior, raw_kv=True)
                    else:
                        new_caches, logits = lm.prefill(self.params, batch, self.cfg,
                                                        cache_len=self.max_len, last=last)
                    stats.prefill_dispatches += 1
                    stats.events.append(("prefill", rid))
                    valid = s0
                    if self.paged:
                        raw = new_caches.pop("attn")
                        if new_caches:  # the per-slot parts: encdec's cross K/V
                            _insert_slot({k: caches[k] for k in new_caches}, new_caches, slot, valid)
                        npg = -(-raw["k"].shape[2] // self.page_size)
                        self._scatter_pages(caches, raw, new_pages[:npg])
                        row = hit_pages + new_pages
                        row_t = torch.zeros((self.pages_per_slot,), dtype=torch.int32)
                        row_t[: len(row)] = torch.as_tensor(row, dtype=torch.int32)
                        page_table[slot] = row_t.to(dev)
                        if pcache is not None and sr.prefix:
                            # full prompt pages only: decode writes start at
                            # position s0, i.e. page >= s0 // page_size
                            ins = s0 // self.page_size
                            pcache.insert(sr.prefix[:ins], row[:ins])
                    else:
                        _insert_slot(caches, new_caches, slot, valid)
                    temps[slot] = float(r.temperature)
                    gens[slot] = (torch.Generator(device=dev).manual_seed(int(r.seed))
                                  if r.temperature > 0 else None)
                    t0 = self._sample(logits[:, -1], [temps[slot]], [gens[slot]])
                    tok[slot] = t0[0]
                    pos[slot] = valid
                    out_buf[slot] = 0
                    out_buf[slot, 0] = t0[0, 0]
                    out_idx[slot] = 1
                    if any_eos:
                        e = r.eos_token if r.eos_token is not None else -1
                        eos_vec[slot] = e
                        d0 = (t0[0, 0] == e) & (e >= 0)
                        done[slot] = d0
                        done_idx[slot] = torch.where(d0, 1, out_cap)
                    active[slot] = {"rid": rid, "left": r.max_new_tokens - 1, "cost": sr.cost}
                    live_cost += sr.cost
                    stats.shard_peak_cost = [max((stats.shard_peak_cost or [0.0])[0], live_cost)]
                    if self.paged:
                        active[slot]["pages"] = row
                        active[slot]["valid"] = valid
                    if active[slot]["left"] == 0:
                        finish(slot)
                        free.insert(0, slot)
            stats.peak_active = max(stats.peak_active, sum(a is not None for a in active))
            if not any(active):
                continue
            if self.paged:
                caches, logits = lm.decode_step(self.params, caches, tok, pos, self.cfg,
                                                page_table=page_table)
            else:
                caches, logits = lm.decode_step(self.params, caches, tok, pos, self.cfg)
            stats.decode_dispatches += 1
            stats.events.append(("decode", sum(a is not None for a in active)))
            tok = self._sample(logits[:, -1], temps, gens)
            out_buf[rows, out_idx.clamp(max=out_cap - 1)] = tok[:, 0]
            out_idx += 1
            pos += 1
            if any_eos:
                hit = (tok[:, 0] == eos_vec) & (eos_vec >= 0) & ~done
                done_idx = torch.where(hit, out_idx, done_idx)
                done |= hit
            for slot in range(nslots):
                if active[slot] is not None:
                    active[slot]["left"] -= 1
                    if active[slot]["left"] == 0:
                        finish(slot)
            eos_countdown -= 1
            if any_eos and eos_countdown <= 0:
                eos_countdown = self.eos_poll
                flags = done.cpu().numpy()  # one (slots,) bool transfer
                for slot in range(nslots):
                    if active[slot] is not None and reqs[active[slot]["rid"]].eos_token is not None \
                            and flags[slot]:
                        stats.early_exits += 1
                        finish(slot)
        stats.padding_frac = sched.stats.padding_frac
        stats.sched = sched.stats
        if self.paged:
            stats.page_frac = sched.stats.page_frac
            stats.pool_peak_pages = self.pool.peak_used
        return results  # type: ignore[return-value]

    def generate(self, prompts: np.ndarray, *, max_new_tokens: int = 32, temperature: float = 0.0,
                 seed: int = 0) -> np.ndarray:
        """prompts: (B, S0) int32 → (B, S0 + max_new_tokens) int32: one slot
        per row, exact-length buckets, row ``i`` sampling from seed ``seed + i``."""
        prompts = np.asarray(prompts, np.int32)
        reqs = [GenRequest(tokens=prompts[i], max_new_tokens=max_new_tokens,
                           temperature=temperature, seed=seed + i) for i in range(prompts.shape[0])]
        return np.stack(self.serve(reqs, slots=prompts.shape[0]))

    def _sample(self, logits, temps: list[float], gens: list) -> torch.Tensor:
        """(B, 1) next tokens: greedy where the temperature is 0, else drawn
        from the row's generator at ``softmax(logits / t)``."""
        logits = logits[:, : self.cfg.vocab_size]  # drop the padded vocab tail
        out = logits.argmax(-1)
        for i, (t, g) in enumerate(zip(temps, gens)):
            if t > 0:
                probs = torch.softmax(logits[i] / t, dim=-1)
                out[i] = torch.multinomial(probs, 1, generator=g)[0]
        return out[:, None]


def _insert_slot(live: dict, new: dict, slot: int, valid_len: int) -> None:
    """Copy a prefilled (batch-1) layer-stacked cache into row ``slot`` of
    the live caches, in place, leaf by leaf of ``live`` (a leaf without
    positions, as encdec's cross K/V, is copied as it is).  ``pos`` leaves
    are masked by position value (>= ``valid_len`` → −1), so bucket-pad K/V
    can never be attended.  For a sliding-window ring this relies on
    :meth:`Engine._bucket_len` keeping the padded prompt inside the ring."""
    for key, lv in live.items():
        nw = new[key]
        if isinstance(lv, dict):
            _insert_slot(lv, nw, slot, valid_len)
            continue
        row = nw[:, 0]
        if key == "pos":
            row = torch.where((row >= 0) & (row < valid_len), row, -1)
        lv[:, slot] = row
