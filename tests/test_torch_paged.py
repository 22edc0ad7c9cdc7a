"""The port's paged-KV pieces against the reference's, on the CPU: the plain
version of B13 (``repro_torch.kernels.paged_attn``) against the
reference's pure-jnp twin ``paged_decode_attention_ref`` (jax releases
without ``pl.load`` cannot run the Pallas kernel itself), and the numpy-only bookkeeping
(``PagePool``, ``ShardedPagePool``, ``prefix_chain``, ``PrefixCache``)
driven through the same operations on both sides.

Tolerance for B13, normwise ``max|port - ref| <= tol * max|ref|``: 1e-6 in
fp32 (the same op sequence; XLA's and PyTorch's CPU products round alike up
to an ulp or two) and 2e-2 in bf16 (p and the output round to bf16 at the
same places, but a last-bit difference in an fp32 score can flip a bf16
rounding: one bf16 unit is 2^-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import paged_decode_attention_ref
from repro.serve import paged as RP
from repro_torch.kernels import paged_attn as PA
from repro_torch.models.common import MASK_VALUE
from repro_torch.serve import paged as TP

TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def inputs(b, h, kv, dh, page, np_, pool, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((pool, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((pool, page, kv, dh)).astype(np.float32)
    table = rng.integers(1, pool, (b, np_)).astype(np.int32)
    return q, kp, vp, table


def both(q, kp, vp, table, lengths, dtype):
    want = paged_decode_attention_ref(*(jnp.asarray(x, jnp.dtype(dtype)) for x in (q, kp, vp)),
                                      jnp.asarray(table), jnp.asarray(lengths, np.int32))
    tt = lambda x: torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))
    got = PA.paged_decode_attention(tt(q), tt(kp), tt(vp), torch.from_numpy(table),
                                    torch.as_tensor(lengths, dtype=torch.int32))
    return got, np.asarray(want).astype(np.float32)


def close(got, want, dtype):
    assert got.shape == want.shape
    err = np.abs(got.float().numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], f"normwise {err:.3e} > {TOL[dtype]}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("case", ["holes", "length 1", "full row", "mid page"])
def test_plain_b13_matches_the_reference_twin(dtype, rep, case):
    kv, page, np_ = 2, 4, 5
    q, kp, vp, table = inputs(3, kv * rep, kv, 16, page, np_, 12, seed=rep)
    lengths = {"holes": [7, 20, 13], "length 1": [1, 1, 1], "full row": [20, 20, 20],
               "mid page": [6, 10, 15]}[case]
    if case == "holes":
        table[0, 1] = -1   # a hole inside the live length
        table[1, 4] = -1   # a hole in the last live page
        table[2, 4] = -1   # a hole past the length
    got, want = both(q, kp, vp, table, lengths, dtype)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, kv * rep * 16)
    close(got, want, dtype)


def test_a_hole_scores_zero_and_takes_part():
    """A −1 entry gathers zero K and V: its positions score exactly 0 and take
    part in the softmax (skipping them would compute another function)."""
    kv, dh, page = 1, 16, 4
    q, kp, vp, table = inputs(1, 1, kv, dh, page, 2, 4, seed=3)
    table[0, 0] = -1
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    got = PA.paged_decode_attention(tq, tk, tv, torch.from_numpy(table), torch.tensor([8], dtype=torch.int32))
    s = torch.cat([torch.zeros(4), (tk[table[0, 1], :, 0] @ tq[0, 0]) * dh ** -0.5])
    p = torch.exp(s - s.max())
    want = (p @ torch.cat([torch.zeros(4, dh), tv[table[0, 1], :, 0]])) / p.sum()
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=1e-6)


def test_positions_past_the_length_weigh_exactly_zero():
    q, kp, vp, _ = inputs(2, 4, 2, 16, 4, 3, 8, seed=4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    tt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)  # no page shared
    lengths = torch.tensor([5, 7], dtype=torch.int32)
    base = PA.paged_decode_attention(tq, tk, tv, tt, lengths)
    # whatever finite values sit past the length change nothing, bit for bit
    tk2, tv2 = tk.clone(), tv.clone()
    for r, n in enumerate(lengths.tolist()):
        for j in range(n, 12):
            tk2[tt[r, j // 4], j % 4] = 1e3
            tv2[tt[r, j // 4], j % 4] = -7.0
    assert torch.equal(PA.paged_decode_attention(tq, tk2, tv2, tt, lengths), base)
    assert MASK_VALUE == -1e30


def test_an_empty_row_gives_zeros():
    q, kp, vp, table = inputs(2, 2, 1, 16, 4, 2, 4, seed=5)
    got = PA.paged_decode_attention(*(torch.from_numpy(x) for x in (q, kp, vp, table)),
                                    torch.tensor([0, 3], dtype=torch.int32))
    assert torch.equal(got[0], torch.zeros(32)) and bool(torch.isfinite(got).all())


def test_the_wrapper_checks_shapes():
    q, kp, vp, table = (torch.from_numpy(x) for x in inputs(2, 4, 2, 16, 4, 3, 8, seed=6))
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        PA.paged_decode_attention(q[:, :3], kp, vp, table, lengths)
    with pytest.raises(ValueError, match="do not fit"):
        PA.paged_decode_attention(q, kp, vp[:, :2], table, lengths)
    with pytest.raises(ValueError, match="do not fit"):
        PA.paged_decode_attention(q, kp, vp, table, lengths[:1])


# (rep, NP, page, scores on chip) at 32 rows of llama3-8b's KV heads in bf16,
# one CTA a row and head: the row's scores stay beside the ring up to ~690
# pages of 16 at rep 4, and up to far more at rep 1
@pytest.mark.parametrize("rep,np_,page,smem", [(4, 37, 16, True), (4, 384, 16, True),
                                               (4, 700, 16, False), (1, 1536, 16, True)])
def test_scores_stay_in_shared_memory_while_they_fit(rep, np_, page, smem):
    plan = PA.paged_plan(32, 8 * rep, 8, 128, np_, page, 2, 132, ctas=1)
    assert plan.smem_scores is smem and plan.bytes <= PA.SMEM_BYTES


# ---------------------------------------------------------------------------
# B13's plan and its split softmax
# ---------------------------------------------------------------------------
# (B, H, KV, Dh, NP, page, element size): llama3-8b served (4 rows) and
# decode-heavy (32 rows of 256 pages); one row of one page; GQA groups of
# 8 and 12 query heads (2 and 3 groups of 4); a narrow head; fp32
PLAN_SHAPES = [(4, 32, 8, 128, 36, 16, 2), (32, 32, 8, 128, 256, 16, 2), (1, 4, 1, 64, 1, 16, 2),
               (2, 16, 2, 64, 600, 16, 4), (3, 24, 2, 128, 50, 8, 2), (5, 4, 2, 16, 8, 8, 4)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_b13_plan_reads_only_shapes_and_owns_every_position_once(shape, sms):
    b, h, kv, dh, np_, page, es = shape
    plan = PA.paged_plan(b, h, kv, dh, np_, page, es, sms)
    k = plan.ctas
    assert k in (1, 2, 4, 8) and k <= max(1, np_) and plan.groups == -(-(h // kv) // 4)
    half = PA.paged_plan(b, h, kv, dh, np_, page, es, sms, ctas=k // 2) if k > 1 else None
    # it splits a row to fill the card once, or where half as many CTAs an
    # SM-sized share would keep a CTA alone on its SM
    assert k == 1 or b * kv * plan.groups * k <= sms or 2 * (half.bytes + 1024) > PA.SM_SMEM_BYTES
    assert plan.bytes <= PA.SMEM_BYTES
    owner = np.concatenate([np.full(max(0, min(np_, (r + 1) * plan.pages) - r * plan.pages), r)
                            for r in range(k)])
    assert owner.shape == (np_,) and (np.diff(owner) >= 0).all()  # each page once, in rank order
    for forced in (1, 2, 4, 8, 16):
        f = PA.paged_plan(b, h, kv, dh, np_, page, es, sms, ctas=forced)
        assert f.ctas == forced and f.pages * forced >= np_ > (f.pages - 1) * forced
    if shape[:2] == (4, 32) and sms == 132:
        assert k == 4  # 128 CTAs at the served shape
    if shape[0] == 32:
        assert k == 2  # 512 CTAs of 87 KB, two an SM, where one of 118 KB would sit alone
    with pytest.raises(ValueError, match="CTAs"):
        PA.paged_plan(b, h, kv, dh, np_, page, es, sms, ctas=3)


def split_softmax_emulation(q, kp, vp, table, lengths, k, dtype):
    """B13's order on clusters of k CTAs: CTA r scores the row's pages
    [r·ppc, (r+1)·ppc) that the length reaches (holes zero, page ids past
    the pool clamped), the cluster takes the row's max before any p is
    formed, each CTA rounds p to the V dtype and sums its Σp and Σp·v in
    fp32, and the leader adds the k shares in rank order, then
    round(o) / round(max(l, 1e-30))."""
    rnd = (lambda x: np.asarray(x, np.float32)) if dtype == "float32" else \
        (lambda x: np.asarray(x, np.float32).astype(jnp.bfloat16).astype(np.float32))
    q, kp, vp = rnd(q), rnd(kp), rnd(vp)
    b, h, dh = q.shape
    pool, page, kvh, _ = kp.shape
    np_ = table.shape[1]
    rep, ppc = h // kvh, -(-np_ // k)
    out = np.zeros((b, h * dh), np.float32)
    for row in range(b):
        live = min(max(int(lengths[row]), 0), np_ * page)
        lpg = -(-live // page)
        for head in range(h):
            g = head // rep
            shares = []
            for r in range(k):
                pages = range(r * ppc, min(min((r + 1) * ppc, np_), lpg))
                ks, vs = [], []
                for pg in pages:
                    pid = int(table[row, pg])
                    blk = np.zeros((2, page, dh), np.float32) if pid < 0 else \
                        np.stack([kp[min(pid, pool - 1), :, g], vp[min(pid, pool - 1), :, g]])
                    ks.append(blk[0])
                    vs.append(blk[1])
                ks = np.concatenate(ks) if ks else np.zeros((0, dh), np.float32)
                vs = np.concatenate(vs) if vs else np.zeros((0, dh), np.float32)
                pos = r * ppc * page + np.arange(len(ks))
                s = np.where(pos < live, (ks @ q[row, head]).astype(np.float32) * np.float32(dh ** -0.5),
                             np.float32(-1e30)).astype(np.float32)
                shares.append((s, vs))
            m = max([np.float32(-1e25)] + [s.max() for s, _ in shares if len(s)])
            o, l = np.zeros(dh, np.float32), np.float32(0)
            for s, vs in shares:
                p = np.exp(s - m).astype(np.float32)
                o = (o + (rnd(p) @ vs).astype(np.float32)).astype(np.float32)
                l = np.float32(l + p.sum(dtype=np.float32))
            out[row, head * dh:(head + 1) * dh] = rnd(rnd(o) / rnd(max(l, np.float32(1e-30))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("rep", [1, 4, 6])
def test_b13_split_softmax_is_within_tol_of_the_reference(rep, k, dtype):
    kv, dh, page, np_ = 2, 32, 4, 9
    q, kp, vp, table = inputs(5, kv * rep, kv, dh, page, np_, 40, seed=rep + k)
    table[0, 1] = -1          # a hole inside the live length
    table[3, 2] = -1          # another
    table[4, 0] = 40 + 7      # a page id past the pool: clamped
    lengths = np.array([30, 0, 4 * 5 + 3, 36, 17], np.int32)  # zero, partial pages, a full row
    want = np.asarray(paged_decode_attention_ref(*(jnp.asarray(x, jnp.dtype(dtype)) for x in (q, kp, vp)),
                                                 jnp.asarray(table), jnp.asarray(lengths))).astype(np.float32)
    got = split_softmax_emulation(q, kp, vp, table, lengths, k, dtype)
    err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= {"float32": 1e-5, "bfloat16": 1e-2}[dtype], f"normwise {err:.3e}"
    assert not got[1].any()  # a row of length 0 gives zeros


# ---------------------------------------------------------------------------
# the numpy bookkeeping, driven alike on both sides
# ---------------------------------------------------------------------------
def pool_state(pool):
    return (pool.capacity, pool.free, pool.used, pool.peak_used, pool.failed_allocs,
            [pool.refcount(p) for p in range(pool.base + 1, pool.base + pool.num_pages)])


def test_page_pool_behaves_as_the_reference():
    ours, theirs = TP.PagePool(8, 4), RP.PagePool(8, 4)
    script = [("alloc", 3), ("alloc", 2), ("retain", None), ("alloc", 5), ("release", None),
              ("alloc", 4), ("release", None), ("alloc", 1)]
    held = {id(ours): [], id(theirs): []}
    for op, n in script:
        outs = []
        for pool in (ours, theirs):
            h = held[id(pool)]
            if op == "alloc":
                got = pool.alloc(n)
                if got is not None:
                    h.append(got)
                outs.append(got)
            elif op == "retain":
                pool.retain(h[0])
            else:
                pool.release(h.pop(0))
            outs.append(pool_state(pool))
        assert outs[: len(outs) // 2] == outs[len(outs) // 2:], op
    for pool in (ours, theirs):
        with pytest.raises(ValueError, match="unallocated"):
            pool.release([0])
    with pytest.raises(ValueError, match=">= 2 pages"):
        TP.PagePool(1, 4)
    assert TP.SCRAP_PAGE == RP.SCRAP_PAGE == 0


def test_sharded_page_pool_behaves_as_the_reference():
    ours, theirs = TP.ShardedPagePool(3, 4, 8), RP.ShardedPagePool(3, 4, 8)
    for pool in (ours, theirs):
        a = pool.alloc(2, shard=1)
        pool.alloc(3, shard=2)
        pool.alloc(4, shard=0)  # more than a shard holds: refused
        pool.retain(a)
        pool.release(a)
    for name in ("capacity", "shard_capacity", "free", "used", "peak_used", "failed_allocs",
                 "num_pages"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.shard_used() == theirs.shard_used()
    assert [ours.scrap(k) for k in range(3)] == [theirs.scrap(k) for k in range(3)]


@pytest.mark.parametrize("salt", ["", "lb=16"])
@pytest.mark.parametrize("length", [3, 8, 21])
def test_prefix_chain_equals_the_reference(salt, length):
    toks = np.random.default_rng(length).integers(0, 1000, length).astype(np.int32)
    assert TP.prefix_chain(toks, 4, salt=salt) == RP.prefix_chain(toks, 4, salt=salt)


def test_prefix_cache_behaves_as_the_reference():
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 50, 16).astype(np.int32) for _ in range(3)]
    prompts.append(np.concatenate([prompts[0][:8], prompts[1][8:]]))  # shares two pages of 0
    trace = []
    for mod in (TP, RP):
        pool = mod.PagePool(10, 4)
        cache = mod.PrefixCache(pool)
        log, live = [], []
        for i, toks in enumerate(prompts):
            chain = mod.prefix_chain(toks, 4)
            hit = cache.lookup(chain[:3])
            new = pool.alloc(4 - len(hit))
            if new is None:
                cache.evict(4 - len(hit))
                new = pool.alloc(4 - len(hit))
            row = hit + (new or [])
            cache.insert(chain[:3], row[:3])
            live.append(row)
            if i == 1:  # a request retires mid-stream
                pool.release(live.pop(0))
            log.append((hit, new, len(cache), cache.hits, cache.misses, cache.hit_tokens, pool.free))
        log.append(cache.evict(9))
        log.append(sorted(cache.pages.values()))
        log.append(cache.clear())
        log.append(pool.free)
        trace.append(log)
    assert trace[0] == trace[1]
