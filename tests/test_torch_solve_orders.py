"""The launch plans and the operation orders of the batched solve B10
(``kernels/batched_lu.py:batched_lu_solve_vmem``) and of the wide-band
factor B6 (``kernels/banded.py:banded_lu_tiled``), on the CPU.

Both kernels are held bitwise to their plain versions on the card.  That
rests on each output element seeing the plain version's rounded
operations in the plain version's order, however the kernel schedules
them.  Here each kernel's schedule is written out in numpy float32
(multiply and subtract rounded apart, as ``__fmul_rn``/``__fsub_rn``
do): B10's wide path (32-column strips staged in chunks of rows, the
strip's triangle, then micro-tiles of rows retiring the strip's terms in
passes) and its cluster path (strips owned by equalized pairs, the next
strip's owner retiring the previous strip's terms first); B6's cluster
walk (rows in a ring spread over K CTAs, pivots in groups of g, each CTA
gathering the group's panel and factoring its g columns a row at a time,
then the group's rows past them a column at a time, then one rank-g
update of its own rows, the next panel's part first).  Each must equal the port's
plain version (``repro_torch.core``) bit for bit; the JAX reference
(``repro.core``) agrees with it to 1e-5 normwise, since XLA's CPU code
fuses ``a - l*u`` into one rounding where PyTorch rounds twice.  The
B6 emulation also tags every ring slot with the row it holds and fails
if a read, an update or a gather finds another row there: the check that
K * ring_rows covers the rows live in a group.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banded as jbanded
from repro.core import batched as jbatched
from repro.kernels import banded as jkband
from repro_torch.core import banded as tbanded
from repro_torch.core import batched as tbatched
from repro_torch.kernels import banded as kband
from repro_torch.kernels import batched_lu as kbatched

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMEM = 232448  # dynamic shared memory one H100 block may use
STRIP = 32
F32 = np.float32
TOL = 1e-5
SOLVE_TOL = 1e-4  # B7 against its plain version (tests/test_torch_cuda.py, chip_smoke.py)


def dd_stack(bsz, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (bsz, n, n)).astype(F32)
    idx = np.arange(n)
    a[:, idx, idx] = np.abs(a).sum(axis=2) + 1.0
    return a


def band_dd(n, bw, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, 2 * bw + 1)).astype(F32)
    j = np.arange(n)[:, None] - bw + np.arange(2 * bw + 1)[None, :]
    a = np.where((j >= 0) & (j < n), a, 0.0).astype(F32)
    a[:, bw] = np.abs(a).sum(axis=1) - np.abs(a[:, bw]) + 1.0
    return a


def normwise(got, want):
    scale = float(np.abs(want).max())
    return float(np.abs(got.astype(np.float64) - want).max()) / scale


# ---------------------------------------------------------------------------
# B10's plans
# ---------------------------------------------------------------------------
# (B, n, m): the optimizer's group, the batched dense path's stacks with a
# vector and a square RHS, the cluster side of the split, large n
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("bsz,n,m", [(2, 384, 51968), (8, 1024, 1024), (8, 1024, 1), (8, 1024, 16),
                                     (32, 256, 256), (32, 256, 1), (8, 128, 128), (8, 128, 1),
                                     (1, 1, 1), (3, 31, 5), (5, 1000, 33), (133, 64, 1),
                                     (1, 4960, 1), (1, 58080, 1), (2, 700, 64), (2, 704, 64),
                                     (1, 58080, 16), (1, 80000, 64), (3, 56352, 16), (1, 927744, 17)])
def test_batched_solve_plan_fits_the_card(bsz, n, m, sms):
    plan = kbatched.batched_solve_plan(bsz, n, m, sms)
    assert plan.bytes <= SMEM
    wide = kbatched.wide_cols(n, m)
    if plan.path == "wide":
        assert plan.ctas == 1 and plan.cols == wide and plan.cols in (4, 8, 16, 32, 64)
        # the least width that holds m, unless shared memory narrows it
        assert plan.cols >= min(m, 64) or kbatched._wide_bytes(n, 2 * plan.cols) > SMEM
    else:
        assert plan.ctas in (2, 4, 8, 16) and 1 <= plan.cols <= kbatched.cluster_cols(n, m)
        tiles = -(-m // plan.cols)
        assert tiles * plan.cols - m < tiles  # equal tiles of at most 16 columns
        # a narrow RHS whose wide grid leaves SMs idle, or no wide block fits
        assert not wide or (bsz * -(-m // wide) < sms and m <= kbatched.CLUSTER_MAX_RHS)
    # every strip owned once, by its unit's CTA (equalized pairs)
    if plan.path == "cluster":
        s = -(-n // STRIP)
        owners = [min(k, s - 1 - k) % plan.ctas for k in range(s)]
        per_cta = [owners.count(c) for c in range(plan.ctas)]
        assert max(per_cta) * STRIP * plan.cols * 4 <= plan.bytes


@pytest.mark.parametrize("bsz,n,m,want", [
    (2, 384, 51968, ("wide", 64, 1)), (8, 1024, 1024, ("wide", 32, 1)),
    (32, 256, 256, ("wide", 64, 1)), (8, 1024, 1, ("cluster", 1, 16)),
    (8, 1024, 16, ("wide", 16, 1)), (32, 256, 1, ("cluster", 1, 4)),
    (8, 128, 128, ("wide", 64, 1)), (133, 64, 1, ("wide", 4, 1)), (8, 128, 1, ("cluster", 1, 16)),
    (1, 58080, 1, ("cluster", 1, 16)), (1, 58080, 16, ("cluster", 8, 16)),
    (1, 80000, 64, ("cluster", 11, 16)), (1, 927744, 5, ("cluster", 1, 16))])
def test_batched_solve_plan_at_the_paths_shapes(bsz, n, m, want):
    plan = kbatched.batched_solve_plan(bsz, n, m)
    assert (plan.path, plan.cols, plan.ctas) == want


def test_batched_solve_plan_follows_the_cards_room_and_the_forced_path():
    # the card holds 7 clusters of 16: 8 systems take clusters of 8
    room = {2: 66, 4: 30, 8: 15, 16: 7}
    assert kbatched.batched_solve_plan(8, 1024, 1, room=room).ctas == 8
    # more clusters than the card holds at once: wide where a block fits
    assert kbatched.batched_solve_plan(100, 128, 1, room=room).path == "wide"
    assert kbatched.batched_solve_plan(8, 1024, 1024, path="cluster").path == "cluster"
    assert kbatched.batched_solve_plan(8, 1024, 1, path="wide") == ("wide", 4, 1, 106496)
    # a forced cluster size, even one no card holds (its launch is refused)
    assert kbatched.batched_solve_plan(1, 256, 1, path="cluster", ctas=32)[:3] == ("cluster", 1, 32)
    assert kbatched.batched_solve_plan(1, 58080, 16, path="cluster", ctas=8)[:3] == ("cluster", 6, 8)


# the orders past which fewer than 16 columns fit a cluster's CTA (56321)
# and past which one does not (927744); m from a vector to the optimizer's
@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 64, 1000])
@pytest.mark.parametrize("n", [4961, 56320, 56352, 58080, 80000, 927744, 927745])
def test_batched_solve_takes_every_width_where_one_column_fits(n, m):
    """The registry's slot asks only for one column (batched_solve_fits):
    the plan narrows a cluster's tile down to one column until its CTA fits,
    so every width of RHS it admits has a plan."""
    if not kbatched.batched_solve_fits(n):
        with pytest.raises(ValueError, match="holds n="):
            kbatched.batched_solve_plan(1, n, m)
        return
    plan = kbatched.batched_solve_plan(1, n, m)
    assert plan.path == "cluster" and plan.bytes <= SMEM and 1 <= plan.cols <= 16
    tiles = -(-m // plan.cols)
    assert tiles * plan.cols - m < tiles  # equal tiles
    # the widest equal tiles that fit: those of at most 16 columns, or one tile
    # fewer overflows a CTA
    assert plan.cols == -(-m // -(-m // 16)) or kbatched._narrow_bytes(n, -(-m // (tiles - 1)), 16) > SMEM


def test_batched_solve_plan_refuses_what_nothing_holds():
    with pytest.raises(ValueError, match="holds n="):
        kbatched.batched_solve_plan(1, 10_000, 1, path="wide")
    with pytest.raises(ValueError, match="holds n="):
        kbatched.batched_solve_plan(1, 1_000_000, 1)
    with pytest.raises(ValueError, match="path"):
        kbatched.batched_solve_plan(1, 64, 1, path="narrow")
    assert kbatched.batched_solve_fits(58080) and not kbatched.batched_solve_fits(1_000_000)


# ---------------------------------------------------------------------------
# B10's operation orders
# ---------------------------------------------------------------------------
def triangle(lu, ys, k0, fwd, cols):
    """A strip's triangle for the tile's columns (the warp's shuffle order)."""
    n = lu.shape[0]
    top = min(STRIP, n - k0)
    if fwd:
        for l in range(top - 1):
            rows = slice(k0 + l + 1, k0 + top)
            ys[rows, cols] = ys[rows, cols] - lu[rows, k0 + l, None] * ys[k0 + l, cols]
    else:
        for l in range(top - 1, -1, -1):
            ys[k0 + l, cols] = ys[k0 + l, cols] / lu[k0 + l, k0 + l]
            rows = slice(k0, k0 + l)
            ys[rows, cols] = ys[rows, cols] - lu[rows, k0 + l, None] * ys[k0 + l, cols]


def retire(lu, ys, k0, rows, fwd, cols):
    """A micro-tile pass: rows retire the strip's terms in order, four
    columns of the strip (one float4) at a time."""
    n = lu.shape[0]
    ls = range(min(STRIP, n - k0)) if fwd else range(min(STRIP, n - k0) - 1, -1, -1)
    for l in ls:
        ys[np.ix_(rows, cols)] = ys[np.ix_(rows, cols)] - lu[rows, k0 + l, None] * ys[k0 + l, cols]


def wide_emulation(lu, b, w, chunk, nrg):
    """B10's wide path: tiles of w columns; per strip the triangle, then
    the rows below (above) in chunks of `chunk`, each in passes of R rows
    a thread over nrg row groups, the largest R the rows left fill."""
    n, m = b.shape
    x = np.empty_like(b)
    for c0 in range(0, m, w):
        cols = np.arange(c0, min(c0 + w, m))
        ys = b.copy()
        pieces = [(True, k0) for k0 in range(0, n, STRIP)]
        pieces += [(False, k0) for k0 in range((n - 1) // STRIP * STRIP, -1, -STRIP)]
        for fwd, k0 in pieces:
            triangle(lu, ys, k0, fwd, cols)
            lo, hi = (k0 + STRIP, n) if fwd else (0, k0)
            for r0 in range(lo, hi, chunk):
                rows_left = list(range(r0, min(r0 + chunk, hi)))
                while rows_left:
                    r = next(r for r in (8, 4, 2, 1) if len(rows_left) >= r * nrg or r == 1)
                    take, rows_left = rows_left[:r * nrg], rows_left[r * nrg:]
                    retire(lu, ys, k0, np.array(take), fwd, cols)
        x[:, cols] = ys[:, cols]
    return x


def cluster_emulation(lu, b, ctas, mt):
    """B10's cluster path: strips owned by equalized pairs over `ctas`
    CTAs; link t's owner retires link t-1's terms from its strip, then
    solves the triangle; every CTA then retires the terms from its own
    rows the link reaches, all but the next link's strip."""
    n, m = b.shape
    s = -(-n // STRIP)
    owner = [min(k, s - 1 - k) % ctas for k in range(s)]
    links = [(True, k) for k in range(s)] + [(False, k) for k in range(s - 1, -1, -1)]
    x = np.empty_like(b)
    for c0 in range(0, m, mt):
        cols = np.arange(c0, min(c0 + mt, m))
        ys = b.copy()
        for t, (fwd, k) in enumerate(links):
            k0 = k * STRIP
            if t > 0 and t != s:  # the lookahead: the previous link's terms first
                pfwd, pk = links[t - 1]
                retire(lu, ys, pk * STRIP, np.arange(k0, min(k0 + STRIP, n)), pfwd, cols)
            triangle(lu, ys, k0, fwd, cols)
            nxt = links[t + 1][1] if t + 1 < len(links) else -1
            for c in range(ctas):
                for k2 in range(s):
                    if owner[k2] != c or k2 == nxt or (k2 <= k if fwd else k2 >= k):
                        continue
                    retire(lu, ys, k0, np.arange(k2 * STRIP, min(k2 * STRIP + STRIP, n)), fwd, cols)
        x[:, cols] = ys[:, cols]
    return x


# n: one strip, a ragged one, odd n, a few strips; chunks of 8 rows split
# the rows below a strip, and passes of 1 and 2 rows a thread
@pytest.mark.parametrize("n,m", [(1, 1), (31, 3), (33, 5), (65, 4), (100, 7), (129, 9)])
def test_wide_order_is_the_plain_solves(n, m):
    a = dd_stack(1, n, n)[0]
    lu = tbatched.batched_ebv_lu(torch.from_numpy(a)).numpy()
    b = np.random.default_rng(m).standard_normal((n, m)).astype(F32)
    want = tbatched.batched_lu_solve(torch.from_numpy(lu), torch.from_numpy(b)).numpy()
    for w, chunk, nrg in ((4, 8, 2), (8, 256, 128), (64, 16, 3)):
        assert np.array_equal(wide_emulation(lu, b, w, chunk, nrg), want)
    jwant = np.asarray(jbatched.batched_lu_solve(jnp.asarray(lu[None]), jnp.asarray(b[None])))[0]
    assert normwise(want, jwant) <= TOL


@pytest.mark.parametrize("ctas", [2, 4])
@pytest.mark.parametrize("n,m", [(1, 1), (31, 2), (33, 1), (97, 3), (160, 2), (225, 17)])
def test_cluster_order_is_the_plain_solves(n, m, ctas):
    a = dd_stack(1, n, n + 1)[0]
    lu = tbatched.batched_ebv_lu(torch.from_numpy(a)).numpy()
    b = np.random.default_rng(m).standard_normal((n, m)).astype(F32)
    want = tbatched.batched_lu_solve(torch.from_numpy(lu), torch.from_numpy(b)).numpy()
    assert np.array_equal(cluster_emulation(lu, b, ctas, 16), want)
    jwant = np.asarray(jbatched.batched_lu_solve(jnp.asarray(lu[None]), jnp.asarray(b[None])))[0]
    assert normwise(want, jwant) <= TOL


# ---------------------------------------------------------------------------
# B6's plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bw", [16, 32, 33, 64, 84, 85, 100, 169, 200, 256, 300, 400])
@pytest.mark.parametrize("n", [300, 4103, 65536])
def test_band_cluster_plan_fits_a_cta(n, bw):
    plan = kband.tiled_plan(n, bw)
    c = tbanded.band_block_size(n, bw)
    slab = ((c + bw) * (2 * bw + 1) + 2 * bw) * 4
    assert kband.slab_fits(n, bw) == (slab <= SMEM)
    if slab <= SMEM and bw < kband.BAND_CLUSTER_MIN_BW:  # the per-step slab launches
        assert plan is None and kband.tiled_launches(n, bw) == -(-n // c)
        return
    assert kband.tiled_launches(n, bw) == 1
    assert plan.group <= bw and plan.group in (8, 16, 32) and plan.ctas in (2, 4, 8, 16)
    assert plan.ctas * plan.ring_rows >= 2 * plan.group + bw  # the rows live in a group
    assert plan.group + bw <= kband.CLUSTER_THREADS  # a thread for each of a panel's rows
    assert plan.bytes <= SMEM


@pytest.mark.parametrize("bw,want", [(100, (16, 16)), (256, (16, 16)), (300, (16, 16)), (400, (16, 8)),
                                     (490, (16, 8))])
def test_band_cluster_plan_takes_the_first_pair_that_fits(bw, want):
    plan = kband.band_cluster_plan(bw)
    assert (plan.ctas, plan.group) == want == kband.tiled_plan(65536, bw)[:2]


def test_the_tiled_slot_takes_only_the_bands_its_kernel_holds():
    """Every fp32 local band (fault C5, repaired): the slab steps, a cluster
    walk, or, where no cluster's CTAs hold a group's rows and panels, the
    one-launch walk of the band in device memory; other dtypes stay out."""
    from repro_torch import solvers

    assert kband.tiled_plan(16384, 16) is None
    assert isinstance(kband.tiled_plan(65536, 256), kband.BandClusterPlan)
    for bw in (497, 600, 3000):
        assert kband.tiled_plan(65536, bw) == kband.GLOBAL_WALK and kband.tiled_launches(65536, bw) == 1
        wide = solvers.Problem(op="factor", structure="banded", n=65536, bw=bw)
        assert "cuda_tiled" in [b.name for b in solvers.candidates(wide)]
        assert solvers.select(wide).name == "cuda_tiled"
    half = solvers.Problem(op="factor", structure="banded", n=65536, bw=600, dtype="bfloat16")
    assert "cuda_tiled" not in [b.name for b in solvers.candidates(half)]


def test_band_cluster_plan_forced_and_refused():
    assert kband.band_cluster_plan(256, ctas=4, group=8)[:2] == (4, 8)
    # forced on a band whose slab fits a block: g at most bw
    assert kband.band_cluster_plan(16, ctas=2, group=16)[:2] == (2, 16) and kband.tiled_plan(16384, 16) is None
    # past the measured crossover the walk runs where the slab also fits
    assert kband.slab_fits(16384, 64) and kband.tiled_plan(16384, 64) == kband.band_cluster_plan(64)
    assert kband.tiled_plan(16384, 32) is None and kband.tiled_plan(16384, 33) is not None
    with pytest.raises(ValueError, match="holds bw=16"):
        kband.band_cluster_plan(16, ctas=2, group=32)
    with pytest.raises(ValueError, match="holds bw=256"):
        kband.band_cluster_plan(256, ctas=2, group=32)
    with pytest.raises(ValueError, match="holds bw=256"):  # no kernel for groups of 12
        kband.band_cluster_plan(256, ctas=4, group=12)
    with pytest.raises(ValueError, match="holds bw=500"):  # not even 16 CTAs hold its rows and panels
        kband.band_cluster_plan(500)
    assert kband.tiled_plan(65536, 500) == kband.GLOBAL_WALK  # the device-memory walk takes it
    with pytest.raises(ValueError, match="holds bw="):
        kband.band_cluster_plan(3000)
    assert kband.tiled_launches(0, 256) == 0 and kband.tiled_launches(0, 600) == 0


# ---------------------------------------------------------------------------
# B6's operation order
# ---------------------------------------------------------------------------
class Ring:
    """The ring spread over K CTAs: row i in CTA i mod K, slot (i // K) mod
    rows; each slot tagged with the row it holds."""

    def __init__(self, k, rows, w):
        self.k, self.rows = k, rows
        self.data = np.zeros((k, rows, w), F32)
        self.tag = -np.ones((k, rows), np.int64)

    def where(self, i):
        return i % self.k, (i // self.k) % self.rows

    def load(self, band, i):
        c, s = self.where(i)
        self.data[c, s] = band[i]
        self.tag[c, s] = i

    def row(self, i):
        c, s = self.where(i)
        assert self.tag[c, s] == i, f"slot of row {i} holds row {self.tag[c, s]}"
        return self.data[c, s]


def band_cluster_emulation(arow, bw, k, g):
    """B6's cluster walk: the ring of k * rows rows; each group of g pivots
    gathers its panel, factors the panel's g columns pivot by pivot, then
    the group's rows past them (U12) column by column, writes its entries
    out and applies the rank-g update to the rows below, the next panel's
    part first; the rows of the group after next load a group ahead."""
    n, w = arow.shape
    out = arow.copy()
    ring = Ring(k, -(-(2 * g + bw) // k), w)
    for i in range(min(n, g + bw)):
        ring.load(arow, i)
    for p0 in range(0, n, g):
        pe = min(p0 + g, n)
        for i in range(p0 + g + bw, min(n, p0 + 2 * g + bw)):
            ring.load(arow, i)
        # gather: pc[r - p0, j - p0] = A[r, j] over the group's columns j;
        # up[q - p0, j - p0] = A[q, j] past them (U12)
        pc = np.zeros((g + bw, g), F32)
        up = np.zeros((g, g + bw), F32)
        ml = np.full((g + bw, g), np.nan, F32)
        rows = range(p0, min(n, pe + bw))
        for r in rows:
            for j in range(max(p0, r - bw), min(pe, r + bw + 1)):
                pc[r - p0, j - p0] = ring.row(r)[j - r + bw]
        for q in range(p0, pe):
            for j in range(pe, min(q + bw, n - 1) + 1):
                up[q - p0, j - p0] = ring.row(q)[j - q + bw]
        # the panel's columns, pivot by pivot, a row at a time
        for p in range(p0, pe):
            pp = p - p0
            for r in range(p + 1, min(n - 1, p + bw) + 1):
                rr = r - p0
                l = F32(pc[rr, pp] / pc[pp, pp])
                ml[rr, pp] = l
                jj = np.arange(pp + 1, pe - p0)
                pc[rr, jj] = pc[rr, jj] - l * pc[pp, jj]
        # U12, a column at a time: row q takes the pivots p < q in order
        for j in range(pe, min(n, pe + bw)):
            for q in range(p0 + 1, pe):
                if j > q + bw:
                    continue
                acc = up[q - p0, j - p0]
                for p in range(p0, q):
                    if j <= p + bw:
                        acc = F32(acc - F32(ml[q - p0, p - p0] * up[p - p0, j - p0]))
                up[q - p0, j - p0] = acc
        for r in rows:
            for j in range(max(p0, r - bw), min(pe, r + bw + 1)):
                out[r, j - r + bw] = ml[r - p0, j - p0] if j < r else pc[r - p0, j - p0]
        for q in range(p0, pe):
            for j in range(pe, min(q + bw, n - 1) + 1):
                out[q, j - q + bw] = up[q - p0, j - p0]

        def trail(r_lo, r_hi, c_lo, c_hi):
            for r in range(r_lo, min(r_hi, n)):
                row = ring.row(r)
                for j in range(c_lo, min(c_hi, n)):
                    acc = row[j - r + bw]
                    for p in range(max(p0, max(r, j) - bw), pe):
                        acc = F32(acc - F32(ml[r - p0, p - p0] * up[p - p0, j - p0]))
                    row[j - r + bw] = acc

        trail(pe, pe + g, pe, pe + bw)
        trail(pe + g, pe + bw, pe, pe + g)
        trail(pe + g, pe + bw, pe + g, pe + bw)
    return out


# (n, bw, g): a ragged last group, n < bw, n < g, one row, n = bw, g = 1
# and 3 beside the kernel's 8 (groups of at most bw pivots); K = 2 and 4
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("n,bw,g", [(40, 9, 8), (40, 9, 3), (23, 5, 1), (23, 5, 3), (7, 12, 8),
                                    (1, 4, 3), (30, 30, 8), (26, 8, 8), (26, 8, 1), (50, 16, 3)])
def test_band_cluster_order_is_the_plain_factors(n, bw, g, k):
    a = band_dd(n, bw, n + bw + g)
    want = tbanded.banded_lu_blocked(torch.from_numpy(a), bw=bw).numpy()
    assert np.array_equal(band_cluster_emulation(a, bw, k, g), want)
    jwant = np.asarray(jbanded.banded_lu_blocked(jnp.asarray(a), bw=bw))
    assert normwise(want, jwant) <= TOL


# ---------------------------------------------------------------------------
# B7's staged schedule
# ---------------------------------------------------------------------------
def staged_solve_emulation(lu, b, bw, warps, cols, stages):
    """B7's staged solve (``band_solve_staged_kernel``) step by step: per
    tile of ``cols`` RHS columns, strips of 32 rows forward then backward;
    each strip's half of the band enters a ring of ``stages`` buffers (each
    tagged with its strip, ready only once the kernel's waits cover its
    copy, and written only where a block barrier separates the copy from
    the buffer's last read: other warps run ahead), the solver warps start from b (y) less the helpers' partial sums
    of the step before, retire the previous strip's block and solve the
    triangle; the helpers split the next strip's diagonals into slices
    against a ring of ``cap`` solved values a column, tagged with the row
    each slot holds, so a read of an overwritten slot fails.

    ``lu`` ``(B, n, 2bw+1)`` and ``b`` ``(B, n, m)`` are a stack, as B12
    launches it: one flat array, system s's band ``s * n * (2bw+1)`` floats
    past its base.  Each strip row is copied into its buffer in the
    kernel's 16-byte chunks, aligned on the stack's base and cut (zero
    filled) at the stack's end, with each buffer float tagged with the
    flat index it came from; a read must find its own row's entry there,
    so a chunk's floats of a neighbouring system are never used.  A
    ``(n, 2bw+1)`` band and ``(n, m)`` RHS are a stack of one."""
    if lu.ndim == 2:
        return staged_solve_emulation(lu[None], b[None], bw, warps, cols, stages)[0]
    bsz, n, w = lu.shape
    m = b.shape[2]
    strips = -(-n // 32)
    q4 = (bw + 10) // 4
    q4 += 1 - q4 % 2
    S, cap = 4 * q4, -(-(bw + 64) // 32) * 32
    stage_floats = 32 * S + 16
    x = np.zeros((bsz, n, m), F32)
    flat, end = lu.reshape(-1), bsz * n * w
    for sys_, c0 in ((s_, c) for s_ in range(bsz) for c in range(0, m, cols)):
        base = sys_ * n * w
        ct = min(cols, m - c0)
        nh = warps - cols if warps > cols else warps
        ring = np.zeros((ct, cap), F32)
        ring_tag = -np.ones((ct, cap), np.int64)
        bs, xs = b[sys_], x[sys_]
        for upper in (False, True):
            strip_of = (lambda q: strips - 1 - q) if upper else (lambda q: q)
            length = bw + 1 if upper else bw  # the half's entries a row
            buf_tag = [None] * stages   # (strip, upper) a buffer holds
            bufv = np.zeros((stages, stage_floats), F32)
            bufsrc = -np.ones((stages, stage_floats), np.int64)  # the flat index each float came from
            issued = []                 # (buffer, tag) per commit group, in order
            done = 0                    # groups the waits have covered
            epoch = 0                   # block barriers so far
            last_read = [-1] * stages   # the epoch of each buffer's last read

            def barrier():
                nonlocal epoch
                epoch += 1

            def row_start(k, rr):
                return base + (32 * k + rr) * w + (bw if upper else 0)

            def stage(k, buf):
                if 0 <= k < strips:
                    assert last_read[buf] < epoch, f"buffer {buf} copied over before a barrier"
                    # chunk cc of row rr: floats a .. a+3 from a = (start & ~3) + 4 cc,
                    # those from start + length on skipped, those past the stack zero
                    rr = np.arange(min(32, n - 32 * k))[:, None, None]
                    cc, j = np.arange(S // 4)[None, :, None], np.arange(4)[None, None, :]
                    start = row_start(k, rr)
                    a = (start & ~3) + 4 * cc
                    copied = np.broadcast_to(a < start + length, (rr.size, S // 4, 4))
                    src, dst = a + j, rr * S + 4 * (rr >> 3) + 4 * cc + j
                    bufv[buf, dst[copied]], bufsrc[buf, dst[copied]] = 0, -1
                    real = copied & (src < end)
                    bufv[buf, dst[real]], bufsrc[buf, dst[real]] = flat[src[real]], src[real]
                issued.append((buf, (k, upper) if 0 <= k < strips else None))
                buf_tag[buf] = ("pending", len(issued) - 1)

            def wait(pending):
                nonlocal done
                done = max(done, len(issued) - pending)
                for i in range(done):
                    bf, tag = issued[i]
                    if buf_tag[bf] == ("pending", i):
                        buf_tag[bf] = tag

            def entry(buf, k, rr, e):
                assert buf_tag[buf] == (k, upper), f"buffer {buf} holds {buf_tag[buf]}, not strip {k}"
                last_read[buf] = epoch
                start = row_start(k, rr)
                assert (start & 3) + e < S and 0 <= e < length
                d = rr * S + 4 * (rr >> 3) + (start & 3) + e
                assert bufsrc[buf, d] == start + e, f"entry {e} of row {rr} reads flat {bufsrc[buf, d]}"
                return bufv[buf, d]

            for qq in range(stages):
                stage(strip_of(qq), qq)
            part = {0: np.zeros((nh, ct, 32), F32)}
            wait(stages - 2)
            barrier()

            def preload(k, buf):
                near, tri = np.zeros((32, 32), F32), np.zeros((32, 32), F32)
                diag, nb = np.ones(32, F32), np.zeros((32, ct), F32)
                for lane in range(32):
                    i = 32 * k + lane
                    if not (0 <= k < strips and i < n):
                        continue
                    for s in range(32):
                        if not upper:
                            tn, tt = bw - 32 + s - lane, bw + s - lane
                            near[lane, s] = entry(buf, k, lane, tn) if k > 0 and tn >= 0 else 0
                            tri[lane, s] = entry(buf, k, lane, tt) if s < lane and tt >= 0 else 0
                        else:
                            un, ut = 32 + s - lane, s - lane
                            near[lane, s] = entry(buf, k, lane, un) if un <= bw and 32 * k + 32 + s < n else 0
                            tri[lane, s] = entry(buf, k, lane, ut) if s > lane and ut <= bw and 32 * k + s < n else 0
                    if upper:
                        diag[lane] = entry(buf, k, lane, 0)
                    nb[lane] = (xs if upper else bs)[i, c0:c0 + ct]
                return near, tri, diag, nb

            regs = preload(strip_of(0), 0)
            barrier()
            prev = np.zeros((32, ct), F32)
            for q in range(strips):
                k = strip_of(q)
                near, tri, diag, nb = regs
                pin = part[q & 1]
                acc = nb.copy()
                for hh in range(nh):
                    acc = (acc - pin[hh].T).astype(F32)
                for s in range(32):
                    acc = (acc - near[:, s:s + 1] * prev[s:s + 1, :]).astype(F32)
                if not upper:
                    for l in range(31):
                        acc = (acc - tri[:, l:l + 1] * acc[l:l + 1, :]).astype(F32)
                else:  # x_l = acc_l times the reciprocal of its pivot
                    inv = (F32(1) / diag).astype(F32)[:, None]
                    for l in range(31, -1, -1):
                        xl = (acc[l:l + 1, :] * inv[l]).astype(F32)
                        acc = (acc - tri[:, l:l + 1] * xl).astype(F32)
                    acc = (acc * inv).astype(F32)
                for lane in range(32):
                    i = 32 * k + lane
                    if i < n:
                        ring[:, i % cap] = acc[lane]
                        ring_tag[:, i % cap] = i
                        xs[i, c0:c0 + ct] = acc[lane]
                prev = np.where((32 * k + np.arange(32) < n)[:, None], acc, 0).astype(F32)
                stage(strip_of(q + stages), q % stages)
                # the helpers: the next strip's terms against strips solved before this one
                out = np.zeros((nh, ct, 32), F32)
                kn = k - 1 if upper else k + 1
                span = bw - 32
                ts = -(-span // nh) if span > 0 else 0
                for h in range(nh):
                    for lane in range(32):
                        i = 32 * kn + lane
                        if not (0 <= kn < strips and i < n and ts > 0):
                            continue
                        if not upper:
                            lo, hi = max(h * ts, max(0, bw - i)), min((h + 1) * ts, bw - 32 - lane)
                        else:
                            lo = max(33 + h * ts, 64 - lane)
                            hi = min(33 + (h + 1) * ts, min(bw, n - 1 - i) + 1)
                        accs = np.zeros(ct, F32)
                        for e in range(lo, hi):
                            j = i + e if upper else i - bw + e
                            assert (ring_tag[:, j % cap] == j).all(), f"ring slot of {j} overwritten"
                            accs = (accs + entry((q + 1) % stages, kn, lane, e) * ring[:, j % cap]).astype(F32)
                        out[h, :, lane] = accs
                part[(q + 1) & 1] = out
                wait(stages - 2)
                regs = preload(strip_of(q + 1), (q + 1) % stages)
                barrier()
            wait(0)
            barrier()
    return x


# (n, bw): a tridiagonal band, Table 1's width, the shootout's, one just
# past a strip, n not a multiple of 32, bw >= n, and the Poisson width on a
# short band; warps a block, columns a block and stage counts the plan takes
@pytest.mark.parametrize("warps,cols,stages", [(8, 1, 3), (8, 3, 2), (4, 4, 3), (1, 1, 2), (16, 8, 4)])
@pytest.mark.parametrize("n,bw", [(97, 1), (131, 5), (200, 16), (150, 33), (45, 60), (300, 256), (64, 64)])
def test_staged_band_solve_order_is_within_tol_of_the_reference(n, bw, warps, cols, stages):
    lu = tbanded.banded_lu_blocked(torch.from_numpy(band_dd(n, bw, n + bw)), bw=bw).numpy()
    b = np.random.default_rng(n).standard_normal((n, 5)).astype(F32)
    got = staged_solve_emulation(lu, b, bw, warps, cols, stages)
    want = np.asarray(jkband.banded_solve_kernelized(jnp.asarray(lu), jnp.asarray(b), bw=bw, interpret=True))
    assert normwise(got, want) <= SOLVE_TOL


# B12: B7's staged kernel over a stack of systems, each band at its offset
# in one flat array, so the strips' 16-byte chunks are aligned on the
# stack's base: n (2bw+1) is no multiple of 4 in any of these, and the
# chunks take floats of the neighbouring systems into the buffers
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("bsz,n,bw", [(3, 37, 1), (3, 33, 5), (2, 65, 16), (2, 70, 33)])
def test_staged_band_solve_over_a_stack_is_each_system_alone(bsz, n, bw, m):
    assert n * (2 * bw + 1) % 4
    lu = np.stack([tbanded.banded_lu_blocked(torch.from_numpy(band_dd(n, bw, 7 * n + bw + s)), bw=bw).numpy()
                   for s in range(bsz)])
    b = np.random.default_rng(n + m).standard_normal((bsz, n, m)).astype(F32)
    plan = kband.band_solve_plan(n, bw, m)
    assert plan.path == "staged"
    got = staged_solve_emulation(lu, b, bw, plan.warps, plan.cols, plan.stages)
    for s in range(bsz):
        alone = staged_solve_emulation(lu[s], b[s], bw, plan.warps, plan.cols, plan.stages)
        assert np.array_equal(got[s], alone), f"system {s} differs from the solve of it alone"
    want = tbanded.banded_solve_blocked(torch.from_numpy(lu), torch.from_numpy(b), bw=bw).numpy()
    assert normwise(got, want) <= TOL


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # its imports are the standard library's; torch loads in main()
    return mod


_SMOKE = _chip_smoke()


# B12's plan at every ensemble chip_smoke.py drives (phase 3c and 4e, m = 1):
# B7's staged kernel with its plan for one system, 4 warps a block up to
# bw = 32 and 16 past it, 4 stages
@pytest.mark.parametrize("bsz,n,bw", [_SMOKE.ENSEMBLE_T1, (_SMOKE.ENSEMBLE_MEMBERS, _SMOKE.ENSEMBLE_NX ** 2,
                                                            _SMOKE.ENSEMBLE_NX), _SMOKE.ENSEMBLE_SMALL])
def test_band_solve_plan_gives_the_ensembles_the_staged_kernel(bsz, n, bw):
    warps = 4 if bw <= 32 else 16
    plan = kband.band_solve_plan(n, bw, 1)
    assert plan == kband.BandSolvePlan("staged", warps, 1, 4, kband._solve_bytes(bw, 1, warps, 4))
    assert plan.bytes <= kband.BAND_SMEM
