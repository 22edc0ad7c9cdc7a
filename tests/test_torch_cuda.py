"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips where ``torch.cuda.is_available()`` is false.

The module imports neither JAX nor the JAX package, so it also runs on a
host with a card and no JAX (add ``--noconftest`` there, since
``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: normwise ``max|kernel - plain| <= 1e-4 * max|plain|`` — both
fp32, but the kernels fuse multiply-adds and block the sweeps differently
from the plain versions; measured <= 3e-6 at n = 2000 on an H100.  The
band factors and the batched factor and solve round every operation as
their plain versions do and are held to bitwise equality; the batched
band solve to 1e-5, as its unbatched twin measured <= 7.8e-7.  The
legacy unblocked factor and panel (B17, B16) round every operation as
their plain versions do and are held to bitwise equality, in fp32 and in
bf16, and a zero pivot's NaN and inf positions to the plain version's; the fused step and the trailing update (B14, B15) sum their products
in another order than cuBLAS and are held to 1e-5 in fp32 and to 2e-2
(a few bf16 units) in bf16.  A
packed factor is compared as its L (strictly lower) and its U (upper)
apart, each against its own largest entry: U's diagonal is ~n/2 and L's
entries ~1/n, so one norm over both would not see L.  The paged decode
attention (B13) is held to 1e-5 in fp32 and 1e-2 in bf16 (its sums run in
another order; ``chip_smoke.py`` measured <= 2.4e-6 and <= 3.9e-3 on an
H100, on clusters of every size).  The band solve B7 splits each row's
sum over helper warps and is held to 1e-4 like the dense solves.
"""
import numpy as np
import pytest
import torch

from repro_torch import solvers, train
from repro_torch.serve import SolveService
from repro_torch.core.factorization import (
    banded_inverted_solve,
    dense_block_inverses,
    dense_inverted_solve,
    factorize_banded,
)
from repro_torch.core.banded import banded_solve_blocked
from repro_torch.core.health import relative_residual
from repro_torch.kernels import _build, banded, batched_lu, ebv_lu, ops, paged_attn, ref, trsm

pytestmark = pytest.mark.cuda
TOL = 1e-4


def dd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def rhs(n, m, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)


def close(got, want, tol=TOL):
    torch.cuda.synchronize()
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = float(want.abs().max()) if want.numel() else 0.0
    if scale == 0.0:  # nothing to scale by (L of a 1 x 1 factor): exactly equal
        assert torch.equal(got, want)
        return
    err = float((got - want).abs().max() / scale)
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def close_lu(got, want, tol=TOL):
    close(got.tril(-1), want.tril(-1), tol)
    close(got.triu(), want.triu(), tol)


def band_dd(n, bw, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, 2 * bw + 1)).astype(np.float32)
    j = np.arange(n)[:, None] - bw + np.arange(2 * bw + 1)[None, :]
    a = np.where((j >= 0) & (j < n), a, 0.0).astype(np.float32)
    a[:, bw] = np.abs(a).sum(axis=1) - np.abs(a[:, bw]) + 1.0
    return a


def close_band_lu(got, want, bw, tol=TOL):
    # L (columns 0..bw-1) and U (bw..2bw) of the packed band apart
    close(got[:, :bw], want[:, :bw], tol)
    close(got[:, bw:], want[:, bw:], tol)


# (n, bw): tridiagonal; bw >= n; n not a multiple of the block; a slab that
# no longer fits one block's shared memory (bw = 64, C = 256 for the tiled
# factor: 491 KB skewed, 165 KB row-aligned); bw = 100 (the tiled factor's
# slab and the resident factor's whole band past shared memory); bw = 200
# (not even bw+1 rows fit: the device-memory walk)
BAND_SHAPES = [(50, 1), (16, 20), (257, 5), (300, 64), (400, 100), (450, 200)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# n = 1; one partial tile; exactly one tile (one step: no panel or update
# launch); one row past a tile; B = 160 and 224 at 257 and 600 (steps of
# 128); a ragged multi-step n; B = 121 and 127 at 243 and 255 (steps of 128)
@pytest.mark.parametrize("n", [40, 257, 600, 1000, 1, 127, 128, 129, 2049, 243, 255])
def test_lu_fused_kernel_matches_plain(n, card):
    a = torch.from_numpy(dd(n, n)).to(card)
    before = ebv_lu.lu_fused.launches
    got = ebv_lu.lu_fused(a)
    assert ebv_lu.lu_fused.launches == before + ebv_lu.fused_launches(n)  # as the C driver counted
    close_lu(got, ebv_lu.lu_fused_plain(a))
    close_lu(got, torch.from_numpy(ref.lu_ref(dd(n, n))))


@pytest.mark.parametrize("n,block", [(600, 50), (300, 30), (200, 6)])
def test_lu_fused_kernel_matches_plain_at_a_narrow_block(n, block, card):
    # steps of 48, 28 and 4 columns: the width rounded down to a multiple of
    # 4, so that the update's 16-byte copies start aligned at every step
    a = torch.from_numpy(dd(n, n)).to(card)
    before = ebv_lu.lu_fused.launches
    got = ebv_lu.lu_fused(a, block=block)
    assert ebv_lu.lu_fused.launches == before + ebv_lu.fused_launches(n, block)
    close_lu(got, ebv_lu.lu_fused_plain(a, block=block))
    close_lu(got, torch.from_numpy(ref.lu_ref(dd(n, n))))


def test_lu_fused_leaves_its_input_alone(card):
    a = torch.from_numpy(dd(256, 1)).to(card)  # N == n: no padding copy
    before = a.clone()
    ebv_lu.lu_fused(a)
    torch.cuda.synchronize()
    assert torch.equal(a, before)


@pytest.mark.parametrize("m", [None, 3, 64, 300])
@pytest.mark.parametrize("n", [40, 257, 600])
def test_solve_kernels_match_plain(n, m, card):
    lu = torch.from_numpy(ref.lu_ref(dd(n, n + 2)).astype(np.float32)).to(card)
    b = torch.from_numpy(rhs(n, m)).to(card)
    linv, uinv = dense_block_inverses(lu, block=256)
    counts = (trsm.solve_vmem.launches, trsm.solve_tiled.launches, trsm.solve_inverted.launches)
    close(trsm.solve_vmem(lu, b), trsm.solve_vmem_plain(lu, b))
    close(trsm.solve_tiled(lu, b), trsm.solve_tiled_plain(lu, b))
    close(trsm.solve_inverted(lu, linv, uinv, b), dense_inverted_solve(lu, linv, uinv, b))
    after = (trsm.solve_vmem.launches, trsm.solve_tiled.launches, trsm.solve_inverted.launches)
    # as the C entries counted: solve_vmem's and the non-finite pass, one launch
    # per step of solve_tiled and the pass, two a step of solve_inverted
    assert [y - x for x, y in zip(counts, after)] == [
        2, trsm.tiled_launches(n), trsm.inverted_launches(n, linv.shape[1])]


@pytest.fixture(scope="module")
def factors_on_card():
    """Packed LU on the card per n, made once per module."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = ebv_lu.lu_fused(torch.from_numpy(dd(n, n + 5)).to("cuda"))
        return cache[n]

    return get


# B2 across its plan (32 rows a block up to n = 4224): n = 1 and 2 (one block
# of n rows); 33 and 40 (a full block and a ragged one); 257 and 600 (9 and
# 19 blocks, every row resident); 2000 (63 blocks, 256 columns streamed, a
# streamed diagonal tile copied) and 2048 (the dispatch cap); 2700 and 4000
# (85 and 125 blocks, 44 % resident at 4000); RHS widths from a vector to
# five groups of 60 columns (300)
@pytest.mark.parametrize("m", [None, 1, 3, 64, 300])
@pytest.mark.parametrize("n", [1, 2, 33, 40, 257, 600, 2000, 2048, 2700, 4000])
def test_solve_vmem_is_one_launch_of_its_plan(n, m, card, factors_on_card):
    lu = factors_on_card(n)
    b = torch.from_numpy(rhs(n, m, 3 * n + (m or 0))).to(card)
    before = trsm.solve_vmem.launches
    got = trsm.solve_vmem(lu, b)
    assert trsm.solve_vmem.launches - before == 2  # one cooperative launch and the pass, as the C entry counted
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert trsm.solve_vmem.last_plan == tuple(trsm.solve_vmem_plan(n, m or 1, sms))[:6]
    assert got.shape == b.shape
    close(got, trsm.solve_vmem_plain(lu, b))


# past 132 blocks of 32 rows: R = 61 rows a block in two strips, the depth
# of the products split over lanes, 8-10 % of the factor resident
@pytest.mark.parametrize("m", [None, 64])
def test_solve_vmem_past_32_rows_a_block(m, card, factors_on_card):
    lu = factors_on_card(8000)
    b = torch.from_numpy(rhs(8000, m, 11)).to(card)
    before = trsm.solve_vmem.launches
    got = trsm.solve_vmem(lu, b)
    assert trsm.solve_vmem.launches - before == 2
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert trsm.solve_vmem.last_plan == tuple(trsm.solve_vmem_plan(8000, m or 1, sms))[:6]
    close(got, trsm.solve_vmem_plain(lu, b))


# Past about 240 rows a block no room is left for a copy of a streamed
# diagonal tile: n = 30000 copies it at m = 1 with nothing resident and
# reads it from L2 at m = 64; n = 32000 reads it from L2 at both, with its
# last 167 columns resident at m = 1.  The matrix is made on the card; the
# reference is the same two sweeps by torch.linalg.solve_triangular (the
# plain version's column loop takes minutes at this n).
@pytest.mark.parametrize("m", [None, 64])
@pytest.mark.parametrize("n", [30000, 32000])
def test_solve_vmem_past_the_diagonal_tiles_room(n, m, card):
    gen = torch.Generator(device=card).manual_seed(n)
    a = torch.rand((n, n), generator=gen, device=card) * 2 - 1
    a.diagonal().copy_(a.abs().sum(dim=1) + 1)
    lu = ebv_lu.lu_fused(a)
    del a
    b = torch.randn((n,) if m is None else (n, m), generator=gen, device=card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = trsm.solve_vmem_plan(n, m or 1, sms)
    assert plan.theta > 0 and plan.copy == (n == 30000 and m is None)
    before = trsm.solve_vmem.launches
    got = trsm.solve_vmem(lu, b)
    assert trsm.solve_vmem.launches - before == 2
    assert trsm.solve_vmem.last_plan == tuple(plan)[:6]
    bm = b if m else b[:, None]
    y = torch.linalg.solve_triangular(lu, bm, upper=False, unitriangular=True)
    want = torch.linalg.solve_triangular(lu, y, upper=True)
    close(got, want if m else want[:, 0])


# n = 1; n under one 128-tile; ragged n = 2049 (one row past 16 tiles of 128,
# a 1-row last tile of 256); n = 8000 (63 tiles of 128, 32 of 256, a 64-row
# last one): each with the RHS widths on both sides of a narrow tile (4
# columns) and a wide one (64), and past it
@pytest.mark.parametrize("m", [1, 33, 64, 300])
@pytest.mark.parametrize("n", [1, 100, 2049, 8000])
def test_tiled_and_inverted_kernels_across_the_split(n, m, card, factors_on_card):
    lu = factors_on_card(n)
    b = torch.from_numpy(rhs(n, m, n + m)).to(card)
    before = trsm.solve_tiled.launches
    close(trsm.solve_tiled(lu, b, block=128), trsm.solve_tiled_plain(lu, b, block=128))
    assert trsm.solve_tiled.launches - before == trsm.tiled_launches(n, 128)
    for block in (128, 256, 512):  # 512: the kernel stages the inverses' depth in two passes
        linv, uinv = dense_block_inverses(lu, block=block)
        before = trsm.solve_inverted.launches
        close(trsm.solve_inverted(lu, linv, uinv, b), dense_inverted_solve(lu, linv, uinv, b))
        assert trsm.solve_inverted.launches - before == trsm.inverted_launches(n, linv.shape[1])


def test_dense_solves_take_an_empty_rhs_without_a_launch(card):
    lu = torch.from_numpy(ref.lu_ref(dd(40, 3)).astype(np.float32)).to(card)
    linv, uinv = dense_block_inverses(lu, block=16)
    b = torch.zeros((40, 0), device=card)
    wrappers = (trsm.solve_vmem, trsm.solve_tiled, trsm.solve_inverted)
    before = [w.launches for w in wrappers]
    outs = (trsm.solve_vmem(lu, b), trsm.solve_tiled(lu, b), trsm.solve_inverted(lu, linv, uinv, b))
    assert [w.launches for w in wrappers] == before
    for x in outs:
        assert x.shape == (40, 0) and x.dtype == b.dtype and x.device == b.device


def test_main_path_dispatches_the_kernels(card):
    a = torch.from_numpy(dd(300, 5)).to(card)
    b = torch.from_numpy(rhs(300, 2)).to(card)
    before = (ebv_lu.lu_fused.launches, trsm.solve_vmem.launches)
    x = ops.linear_solve(a, b)
    assert (ebv_lu.lu_fused.launches - before[0], trsm.solve_vmem.launches - before[1]) == (
        ebv_lu.fused_launches(300), 2)
    torch.cuda.synchronize()
    assert float(torch.linalg.norm(a @ x - b) / torch.linalg.norm(b)) < 1e-5


@pytest.mark.parametrize("screen", ["health", "fault plan"])
def test_a_kernel_that_fails_raises_instead_of_escalating(screen, card, monkeypatch):
    # a screened dispatch on the card must not hand a broken kernel's work
    # to the plain version of the next candidate
    def broken():
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(_build, "library", broken)
    a = torch.from_numpy(dd(64, 7)).to(card)
    with solvers.record_escalations() as esc, pytest.raises(RuntimeError, match="failed to load") as ei:
        if screen == "health":
            ops.lu(a, health=True)
        else:
            with solvers.inject(slow_dispatch_us=1.0, op="factor"):
                ops.lu(a)
    assert not isinstance(ei.value, solvers.SolveFailure) and esc == []


@pytest.mark.parametrize("n,bw", BAND_SHAPES)
def test_band_factor_kernels_match_plain(n, bw, card):
    a = torch.from_numpy(band_dd(n, bw, n + bw)).to(card)
    plain = banded.banded_lu_plain(a, bw=bw)
    counts = (banded.banded_lu_blocked.launches, banded.banded_lu_tiled.launches)
    got_blocked = banded.banded_lu_blocked(a, bw=bw)
    got_tiled = banded.banded_lu_tiled(a, bw=bw)
    assert (banded.banded_lu_blocked.launches - counts[0],
            banded.banded_lu_tiled.launches - counts[1]) == (1, banded.tiled_launches(n, bw))
    close_band_lu(got_blocked, plain, bw)
    close_band_lu(got_tiled, plain, bw)
    close_band_lu(got_blocked, torch.from_numpy(ref.banded_lu_ref(band_dd(n, bw, n + bw), bw)), bw)
    # the kernels round every operation as the plain version does
    assert torch.equal(got_blocked, plain) and torch.equal(got_tiled, plain)


def any_band(n, bw, seed, zero_pivot=False):
    """A diagonally dominant band whose entries outside the matrix are not
    zero (the factors update those past column n - 1 as the plain version
    does); ``zero_pivot``: the first pivot is 0."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, 2 * bw + 1)).astype(np.float32)
    a[:, bw] = np.abs(a).sum(axis=1) + 1.0
    if zero_pivot:
        a[0, bw] = 0.0
    return a


# B5 on its warp walk (bw <= 31) at n = bw + 1, 2bw + 3, 257 and 4000, and
# at bw = 32 and 200 on the ring and device-memory walks it keeps
@pytest.mark.parametrize("n_of", [lambda bw: bw + 1, lambda bw: 2 * bw + 3, lambda bw: 257,
                                  lambda bw: 4000], ids=["bw+1", "2bw+3", "257", "4000"])
@pytest.mark.parametrize("bw", [1, 2, 5, 11, 16, 31, 32, 200])
def test_band_factor_walks_are_bitwise_the_plain_factor(bw, n_of, card):
    n = n_of(bw)
    a = torch.from_numpy(any_band(n, bw, 7 * n + bw)).to(card)
    before = banded.banded_lu_blocked.launches
    got = banded.banded_lu_blocked(a, bw=bw)
    torch.cuda.synchronize()
    assert banded.banded_lu_blocked.launches - before == 1
    assert banded.banded_lu_blocked.last_path == banded.band_lu_walk(n, bw)
    assert torch.equal(got, banded.banded_lu_plain(a, bw=bw))


@pytest.mark.parametrize("n,bw", [(40, 1), (300, 5), (1000, 16), (64, 31), (300, 32)])
def test_band_factor_walk_on_a_zero_pivot_gives_the_plain_non_finite_pattern(n, bw, card):
    a = torch.from_numpy(any_band(n, bw, n + bw, zero_pivot=True)).to(card)
    got, want = banded.banded_lu_blocked(a, bw=bw), banded.banded_lu_plain(a, bw=bw)
    assert not bool(torch.isfinite(want).all())
    assert_same_non_finite(got, want)


def test_band_factor_warp_walk_takes_an_empty_band(card):
    before = banded.banded_lu_blocked.launches
    got = banded.banded_lu_blocked(torch.zeros((0, 11), device=card), bw=5)
    assert got.shape == (0, 11) and banded.banded_lu_blocked.launches == before
    assert banded.banded_lu_blocked.last_path == "warp walk"


# the cluster walk of the tiled factor (bands whose slab no block holds):
# n = bw - 1, bw + 1, several groups, and a ragged last group past 4096
@pytest.mark.parametrize("n_of", [lambda bw: bw - 1, lambda bw: bw + 1, lambda bw: 1000,
                                  lambda bw: 4096 + 7])
@pytest.mark.parametrize("bw", [169, 200, 256, 300])
def test_band_cluster_walk_is_bitwise_the_plain_factor(bw, n_of, card):
    n = n_of(bw)
    a = torch.from_numpy(band_dd(n, bw, n + bw)).to(card)
    before = banded.banded_lu_tiled.launches
    got = banded.banded_lu_tiled(a, bw=bw)
    assert banded.banded_lu_tiled.launches - before == banded.tiled_launches(n, bw) == 1
    plan = banded.tiled_plan(n, bw)
    path, k, g, rows, nbytes, active = banded.banded_lu_tiled.last_plan
    assert (path, k, g, rows, nbytes) == (1, *plan) and active >= 1
    torch.cuda.synchronize()
    assert torch.equal(got, banded.banded_lu_plain(a, bw=bw))


# every (K, g) whose CTA fits at the Poisson band's width
@pytest.mark.parametrize("k,g", [(4, 8), (8, 8), (8, 16), (16, 8), (16, 16)])
def test_band_cluster_walk_at_each_cluster_and_group(k, g, card):
    a = torch.from_numpy(band_dd(2000, 256, 77)).to(card)
    got = banded._lu_tiled(a, bw=256, plan=banded.band_cluster_plan(256, ctas=k, group=g))
    assert banded.banded_lu_tiled.last_plan[1:3] == (k, g)
    torch.cuda.synchronize()
    assert torch.equal(got, banded.banded_lu_plain(a, bw=256))


# the cluster walk on bands whose slab fits a block (forced up to bw = 32,
# where the slab steps are faster; launch/time_kernels.py:band_walk_crossover):
# the shootout band's width and two wider, g up to bw, a ragged last group
@pytest.mark.parametrize("k,g", [(2, 8), (2, 16), (4, 16), (16, 8), (16, 16)])
@pytest.mark.parametrize("bw", [16, 32, 64])
def test_band_cluster_walk_on_bands_the_slab_steps_take(bw, k, g, card):
    n = 1000 + bw + 3
    a = torch.from_numpy(band_dd(n, bw, 81)).to(card)
    assert banded.slab_fits(n, bw)
    got = banded._lu_tiled(a, bw=bw, plan=banded.band_cluster_plan(bw, ctas=k, group=g))
    assert banded.banded_lu_tiled.last_plan[:3] == (1, k, g)
    torch.cuda.synchronize()
    assert torch.equal(got, banded.banded_lu_plain(a, bw=bw))


# an empty band of the Poisson width, and one too wide for any cluster
@pytest.mark.parametrize("bw", [256, 600])
def test_band_cluster_walk_takes_an_empty_band(bw, card):
    a = torch.zeros((0, 2 * bw + 1), device=card)
    before = banded.banded_lu_tiled.launches
    assert banded.banded_lu_tiled(a, bw=bw).shape == (0, 2 * bw + 1)
    assert banded.banded_lu_tiled.launches - before == banded.tiled_launches(0, bw) == 0


# bands that no cluster holds (C5): the device-memory walk, one launch,
# bitwise the plain factor, and the registry's first choice for them
@pytest.mark.parametrize("n,bw", [(520, 500), (2000, 600), (600 + 5, 600)])
def test_band_tiled_factor_past_every_cluster_is_bitwise_the_plain_one(n, bw, card):
    a = torch.from_numpy(band_dd(n, bw, n + bw)).to(card)
    assert banded.tiled_plan(n, bw) == banded.GLOBAL_WALK
    before = banded.banded_lu_tiled.launches
    got = banded.banded_lu_tiled(a, bw=bw)
    assert banded.banded_lu_tiled.launches - before == banded.tiled_launches(n, bw) == 1
    assert banded.banded_lu_tiled.last_plan[0] == 2
    torch.cuda.synchronize()
    assert torch.equal(got, banded.banded_lu_plain(a, bw=bw))
    b = torch.from_numpy(rhs(n, 2, 66)).to(card)
    with solvers.record_dispatches() as log:
        x = ops.banded_linear_solve(a, b, bw=bw)
    assert [name for _, name in log] == ["cuda_tiled", "cuda"]
    assert float(relative_residual(a, b, x, bw=bw)) < 1e-5


@pytest.mark.parametrize("n,bw", BAND_SHAPES + [(16000, 5)])
def test_scalar_band_factor_kernel_is_bitwise_its_plain_version(n, bw, card):
    """B18, one launch (the warp walk up to bw = 31, the ring walk past it;
    device memory for bw = 200)."""
    a = torch.from_numpy(band_dd(n, bw, 5 * n + bw)).to(card)
    plain = banded.banded_lu_scalar_plain(a, bw=bw)
    before = banded.banded_lu_kernelized.launches
    got = banded.banded_lu_kernelized(a, bw=bw)
    assert banded.banded_lu_kernelized.launches - before == 1
    assert banded.banded_lu_kernelized.last_path == banded.band_lu_walk(n, bw)
    close_band_lu(got, plain, bw)
    assert torch.equal(got, plain)


def c7_band():
    """n = 12, bw = 2 with entries outside the matrix; pivot row 3's upper
    tail is set by the caller."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (12, 5)).astype(np.float32)
    a[:, 2] = np.abs(a).sum(1) + 1
    return a


def scalar_poisoned(n, bw, poison):
    """The NaN pivot of the solve service's poisoned band (row 5), or an
    inf, a NaN or two opposite infs in pivot row n // 3's upper tail."""
    a = band_dd(n, bw, 3 * n + bw)
    k = 5 if poison == "nan pivot" else n // 3
    at = {"nan pivot": [(bw, np.nan)], "inf tail": [(bw + 1 + k % bw, np.inf)],
          "nan tail": [(2 * bw, np.nan)], "two infs": [(bw + 1, np.inf), (2 * bw, -np.inf)]}[poison]
    for col, value in at:
        a[k, col] = value
    return a


# fault C7 on the card: B18's NaN and inf positions are its plain version's
# (the reference kernel's one-hot contraction) on every walk
@pytest.mark.parametrize("poison", ["nan pivot", "inf tail", "nan tail", "two infs"])
@pytest.mark.parametrize("n,bw", BAND_SHAPES + [(16000, 5)])
def test_scalar_band_factor_on_non_finite_values_gives_the_plain_pattern(n, bw, poison, card):
    a = torch.from_numpy(scalar_poisoned(n, bw, poison)).to(card)
    got, want = banded.banded_lu_kernelized(a, bw=bw), banded.banded_lu_scalar_plain(a, bw=bw)
    assert banded.banded_lu_kernelized.last_path == banded.band_lu_walk(n, bw)
    assert not bool(torch.isfinite(want).all())
    assert_same_non_finite(got, want)


@pytest.mark.parametrize("col,value", [(3, np.inf), (4, np.nan), (4, -np.inf), (3, -np.inf)])
def test_scalar_band_factor_on_the_c7_band_gives_the_plain_pattern(col, value, card):
    a = c7_band()
    a[3, col] = value
    a = torch.from_numpy(a).to(card)
    got, want = banded.banded_lu_kernelized(a, bw=2), banded.banded_lu_scalar_plain(a, bw=2)
    assert banded.banded_lu_kernelized.last_path == "warp walk"
    assert_same_non_finite(got, want)
    assert int((~torch.isfinite(want)).sum()) == 40


def test_scalar_band_factor_takes_an_empty_band(card):
    for bw in (5, 40):
        before = banded.banded_lu_kernelized.launches
        got = banded.banded_lu_kernelized(torch.zeros((0, 2 * bw + 1), device=card), bw=bw)
        assert got.shape == (0, 2 * bw + 1) and banded.banded_lu_kernelized.launches == before
        assert banded.banded_lu_kernelized.last_path == banded.band_lu_walk(0, bw)


def test_band_factors_leave_their_input_alone(card):
    a = torch.from_numpy(band_dd(300, 16, 3)).to(card)
    before = a.clone()
    banded.banded_lu_blocked(a, bw=16)
    banded.banded_lu_tiled(a, bw=16)
    banded.banded_lu_kernelized(a, bw=16)
    torch.cuda.synchronize()
    assert torch.equal(a, before)


@pytest.mark.parametrize("m,rhs_tile", [(None, 256), (3, 256), (64, 256), (33, 8)])
@pytest.mark.parametrize("n,bw", BAND_SHAPES)
def test_band_solve_kernels_match_plain(n, bw, m, rhs_tile, card):
    lu = banded.banded_lu_plain(torch.from_numpy(band_dd(n, bw, n)).to(card), bw=bw)
    b = torch.from_numpy(rhs(n, m)).to(card)
    f = factorize_banded(lu, bw=bw)
    counts = (banded.banded_solve_kernelized.launches, banded.banded_solve_inverted.launches)
    close(banded.banded_solve_kernelized(lu, b, bw=bw, rhs_tile=rhs_tile),
          banded_solve_blocked(lu, b, bw=bw))
    close(banded.banded_solve_inverted(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw),
          banded_inverted_solve(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw))
    assert banded.banded_solve_kernelized.launches - counts[0] == 2  # the solve and the pass
    assert banded.banded_solve_inverted.launches - counts[1] == (2 if f.linv.shape[0] == 1 else 6)


def poisson_band(nx):
    """The 5-point Laplacian of an nx x nx grid with diagonal 4.05 in
    row-aligned band form, bw = nx."""
    n, bw = nx * nx, nx
    a = np.zeros((n, 2 * bw + 1), np.float32)
    i = np.arange(n)
    a[:, bw] = 4.05
    a[:, bw - 1] = np.where(i % nx > 0, -1.0, 0.0)
    a[:, bw + 1] = np.where(i % nx < nx - 1, -1.0, 0.0)
    a[:, 0] = np.where(i >= nx, -1.0, 0.0)
    a[:, 2 * bw] = np.where(i < n - nx, -1.0, 0.0)
    return a


# B7's staged path at the Poisson band (a vector RHS, one block of a solver
# warp and 7 helpers) and the bw = 600 band C5 reopened to the tiled factor
@pytest.mark.parametrize("m", [None, 3, 64])
@pytest.mark.parametrize("n,bw", [(256 * 256, 256), (2000, 600)])
def test_band_solve_kernel_on_the_wide_bands(n, bw, m, card):
    a = poisson_band(256) if n == 256 * 256 else band_dd(n, bw, 61)
    lu = banded.banded_lu_plain(torch.from_numpy(a).to(card), bw=bw)
    b = torch.from_numpy(rhs(n, m, 62)).to(card)
    before = banded.banded_solve_kernelized.launches
    got = banded.banded_solve_kernelized(lu, b, bw=bw)
    assert banded.banded_solve_kernelized.launches - before == 2
    plan = banded.band_solve_plan(n, bw, m or 1)
    assert banded.banded_solve_kernelized.last_plan == (1, plan.warps, plan.cols, plan.stages, plan.bytes)
    close(got, banded_solve_blocked(lu, b, bw=bw))


# every warps-a-block and stage count the sweep times, a tile of columns
# narrower than a block's warps, and the per-warp path kept for bands too
# wide for two staged strips (and for B12)
@pytest.mark.parametrize("warps,stages", [(4, 2), (4, 3), (8, 2), (8, 4), (16, 3), (1, 2)])
@pytest.mark.parametrize("n,bw,m", [(257, 5, None), (1000, 16, 64), (1000 + 7, 100, 3), (450, 200, 9)])
def test_band_solve_kernel_at_each_plan(n, bw, m, warps, stages, card):
    lu = banded.banded_lu_plain(torch.from_numpy(band_dd(n, bw, n + bw)).to(card), bw=bw)
    b = torch.from_numpy(rhs(n, m, 63)).to(card)
    plan = banded.band_solve_plan(n, bw, m or 1, warps=warps, stages=stages)
    assert plan.path == "staged" and plan.cols <= warps
    got = banded._solve(lu, b, bw=bw, plan=plan)
    assert banded.banded_solve_kernelized.last_plan[:4] == (1, warps, plan.cols, stages)
    close(got, banded_solve_blocked(lu, b, bw=bw))
    warp = banded.BandSolvePlan("warp", 4, 4, 0, 0)
    close(banded._solve(lu, b, bw=bw, plan=warp), banded_solve_blocked(lu, b, bw=bw))
    assert banded.banded_solve_kernelized.last_plan[0] == 0


def test_a_band_solve_plan_no_block_holds_raises(card):
    lu = banded.banded_lu_plain(torch.from_numpy(band_dd(2000, 600, 64)).to(card), bw=600)
    b = torch.from_numpy(rhs(2000, None, 65)).to(card)
    before = banded.banded_solve_kernelized.launches
    with pytest.raises(RuntimeError, match="CUDA error"):  # three strips of a bw = 600 band: 241 KB
        banded._solve(lu, b, bw=600, plan=banded.BandSolvePlan("staged", 8, 1, 3, 0))
    assert banded.banded_solve_kernelized.launches == before


def test_band_kernels_take_an_empty_rhs_and_refuse_bw_0(card):
    lu = banded.banded_lu_plain(torch.from_numpy(band_dd(40, 2, 4)).to(card), bw=2)
    f = factorize_banded(lu, bw=2)
    b = torch.zeros((40, 0), device=card)
    assert banded.banded_solve_kernelized(lu, b, bw=2).shape == (40, 0)
    assert banded.banded_solve_inverted(f.linv, f.uinv, f.tlo, f.tup, b, n=40, bw=2).shape == (40, 0)
    diag = torch.ones((40, 1), device=card)
    for fn in (banded.banded_lu_blocked, banded.banded_lu_tiled):
        with pytest.raises(ValueError, match="bw >= 1"):
            fn(diag, bw=0)


@pytest.mark.parametrize("bw,factor", [(5, "cuda_blocked"), (16, "cuda_tiled")])
def test_banded_main_path_dispatches_the_kernels(bw, factor, card):
    a = torch.from_numpy(band_dd(2000, bw, 9)).to(card)
    b = torch.from_numpy(rhs(2000, 4)).to(card)
    wrapper = banded.banded_lu_blocked if factor == "cuda_blocked" else banded.banded_lu_tiled
    before = (wrapper.launches, banded.banded_solve_kernelized.launches)
    with solvers.record_dispatches() as log:
        x = ops.banded_linear_solve(a, b, bw=bw)
    assert [name for _, name in log] == [factor, "cuda"]
    per_call = 1 if factor == "cuda_blocked" else banded.tiled_launches(2000, bw)
    assert (wrapper.launches - before[0],
            banded.banded_solve_kernelized.launches - before[1]) == (per_call, 2)
    assert float(relative_residual(a, b, x, bw=bw)) < 1e-5


def test_a_band_kernel_that_fails_raises_instead_of_escalating(card, monkeypatch):
    def broken():
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(_build, "library", broken)
    a = torch.from_numpy(band_dd(64, 3, 7)).to(card)
    with solvers.record_escalations() as esc, pytest.raises(RuntimeError, match="failed to load") as ei:
        ops.banded_lu(a, bw=3, health=True)
    assert not isinstance(ei.value, solvers.SolveFailure) and esc == []


# ---------------------------------------------------------------------------
# the batched kernels (B9-B12)
# ---------------------------------------------------------------------------
def dd_stack(bsz, n, seed=0):
    return np.stack([dd(n, seed + i) for i in range(bsz)])


def band_stack(bsz, n, bw, seed=0):
    return np.stack([band_dd(n, bw, seed + i) for i in range(bsz)])


# (B, n): one system; a few; n = 240, the largest system staged in shared
# memory; past it a cluster per system (batched_lu_plan): n = 241 and 384
# (the optimizer's order at whisper-tiny width), odd n, n = 1000 and the
# reference's cap 1024 (rows streamed below theta), 32 systems of 4 CTAs,
# 100 systems of 2 (more clusters than the card holds at once); 133 systems,
# one block each in device memory; granite-moe-1b-a400m's two EbV groups
# (order 24, the stacked norm scales; order 1024, embed and unembed)
@pytest.mark.parametrize("bsz,n", [(1, 8), (5, 64), (3, 240), (2, 241), (2, 384), (1, 241), (3, 385),
                                   (5, 1000), (8, 1024), (32, 256), (100, 384), (133, 384), (2, 24),
                                   (2, 1024)])
def test_batched_factor_kernel_is_bitwise_its_plain_version(bsz, n, card):
    a = torch.from_numpy(dd_stack(bsz, n, n)).to(card)
    before = batched_lu.batched_lu_vmem.launches
    got = batched_lu.batched_lu_vmem(a)
    assert batched_lu.batched_lu_vmem.launches == before + 2  # the factor and the non-finite pass
    torch.cuda.synchronize()
    assert torch.equal(got, batched_lu.batched_lu_plain(a))
    close_lu(got[-1], torch.from_numpy(ref.lu_ref(dd(n, n + bsz - 1))))
    # the C entry chose the plan its Python mirror names
    want = batched_lu.batched_lu_plan(bsz, n, torch.cuda.get_device_properties(card).multi_processor_count,
                                      batched_lu.cluster_room(card))
    kind, ctas, theta, nbytes, active = batched_lu.batched_lu_vmem.last_plan
    assert (("staged", "global", "cluster")[kind], ctas) == (want.kind, want.ctas)
    if want.kind == "cluster":
        assert (theta, nbytes) == (want.walk.theta, want.walk.bytes) and active >= 1


def test_batched_factor_leaves_its_input_alone(card):
    a = torch.from_numpy(dd_stack(3, 64, 1)).to(card)
    before = a.clone()
    batched_lu.batched_lu_vmem(a)
    torch.cuda.synchronize()
    assert torch.equal(a, before)


# (B, n, m): a vector per system; tiles of unequal width before the
# equalization (70 columns in three tiles of 24); the optimizer's order;
# granite-moe-1b-a400m's EbV groups (order 24 over d = 1024 columns, order
# 1024 over the padded vocabulary's 49280)
@pytest.mark.parametrize("bsz,n,m", [(5, 64, None), (3, 100, 3), (2, 128, 70), (1, 33, 1),
                                     (2, 384, 40), (2, 24, 1024), (2, 1024, 49280)])
def test_batched_solve_kernel_is_bitwise_its_plain_version(bsz, n, m, card):
    lu = batched_lu.batched_lu_plain(torch.from_numpy(dd_stack(bsz, n, n)).to(card))
    b = torch.from_numpy(np.stack([rhs(n, m, 7 + i) for i in range(bsz)])).to(card)
    before = batched_lu.batched_lu_solve_vmem.launches
    got = batched_lu.batched_lu_solve_vmem(lu, b)
    assert batched_lu.batched_lu_solve_vmem.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == b.shape and torch.equal(got, batched_lu.batched_lu_solve_plain(lu, b))
    close(got, torch.from_numpy(ref.batched_solve_ref(lu.cpu().numpy(), b.cpu().numpy())))
    solve_plan_matches(card, bsz, n, m or 1)


def solve_plan_matches(card, bsz, n, m, path=None):
    """The C entry launched the plan its Python mirror names."""
    want = batched_lu.batched_solve_plan(bsz, n, m, torch.cuda.get_device_properties(card).multi_processor_count,
                                         batched_lu.solve_cluster_room(card), path)
    kind, cols, ctas, nbytes, active = batched_lu.batched_lu_solve_vmem.last_plan
    assert (("none", "wide", "cluster")[kind], cols, ctas, nbytes) == tuple(want)
    assert active >= 1 or kind == 1


def solve_on(card, lu, b, path):
    """B10 on the plan's own path (``path`` None) or on the one forced."""
    if path is None:
        return batched_lu.batched_lu_solve_vmem(lu, b)
    bsz, n, m = b.shape if b.ndim == 3 else (*b.shape, 1)
    plan = batched_lu.batched_solve_plan(bsz, n, m, torch.cuda.get_device_properties(card).multi_processor_count,
                                         batched_lu.solve_cluster_room(card), path)
    return batched_lu._solve(lu, b, plan)


# both paths and the plan's own choice at each side of its split: n = 1, a
# ragged strip, one past a strip, the optimizer's order, odd strips, the
# reference's cap; m = a vector, a few columns, past 32 and 64, wide
@pytest.mark.parametrize("path", [None, "wide", "cluster"])
@pytest.mark.parametrize("m", [1, 5, 33, 64, 1000])
@pytest.mark.parametrize("n", [1, 31, 33, 384, 1000, 1024])
def test_batched_solve_paths_are_bitwise_the_plain_version(n, m, path, card):
    bsz = 2
    lu = batched_lu.batched_lu_vmem(torch.from_numpy(dd_stack(bsz, n, n)).to(card))
    b = torch.from_numpy(np.stack([rhs(n, m, 11 + i) for i in range(bsz)])).to(card)
    before = batched_lu.batched_lu_solve_vmem.launches
    got = solve_on(card, lu, b, path)
    assert batched_lu.batched_lu_solve_vmem.launches == before + 1
    solve_plan_matches(card, bsz, n, m, path)
    torch.cuda.synchronize()
    assert got.shape == b.shape and torch.equal(got, batched_lu.batched_lu_solve_plain(lu, b))


# the batch from one system to more than the card's SMs, on each path
@pytest.mark.parametrize("path", [None, "wide", "cluster"])
@pytest.mark.parametrize("bsz,n,m", [(1, 384, 7), (8, 1024, 1), (8, 1024, 16), (32, 256, 1),
                                     (140, 64, 3), (133, 100, 1)])
def test_batched_solve_batches_are_bitwise_the_plain_version(bsz, n, m, path, card):
    lu = batched_lu.batched_lu_vmem(torch.from_numpy(dd_stack(bsz, n, n + 5)).to(card))
    b = torch.from_numpy(np.stack([rhs(n, m, 40 + i) for i in range(bsz)])).to(card)
    before = batched_lu.batched_lu_solve_vmem.launches
    got = solve_on(card, lu, b, path)
    assert batched_lu.batched_lu_solve_vmem.launches == before + 1
    solve_plan_matches(card, bsz, n, m, path)
    torch.cuda.synchronize()
    assert torch.equal(got, batched_lu.batched_lu_solve_plain(lu, b))


# past n = 56320 a cluster's CTA holds fewer than 16 columns, so the plan
# narrows the tile (16 columns in two tiles of 8 at n = 58080); the plain
# column loop takes minutes at this order, so the reference is the two
# sweeps by torch.linalg.solve_triangular on a well-conditioned packed factor
def test_batched_solve_narrows_a_clusters_tile_at_large_n(card):
    n, m = 58080, 16
    gen = torch.Generator(device=card).manual_seed(n)
    lu = torch.rand((1, n, n), generator=gen, device=card).mul_(2.0 / n).sub_(1.0 / n)
    lu[0].diagonal().fill_(1.0)
    b = torch.randn((1, n, m), generator=gen, device=card)
    before = batched_lu.batched_lu_solve_vmem.launches
    got = batched_lu.batched_lu_solve_vmem(lu, b)
    assert batched_lu.batched_lu_solve_vmem.launches == before + 1
    solve_plan_matches(card, 1, n, m)
    assert batched_lu.batched_lu_solve_vmem.last_plan[:3] == (2, 8, 16)
    y = torch.linalg.solve_triangular(lu[0], b[0], upper=False, unitriangular=True)
    close(got[0], torch.linalg.solve_triangular(lu[0], y, upper=True))


def test_a_cluster_the_card_cannot_hold_raises(card):
    """Clusters of 32 CTAs: the launch is refused, and nothing falls back
    to another kernel or to the plain version."""
    lu = batched_lu.batched_lu_plain(torch.from_numpy(dd_stack(1, 256, 3)).to(card))
    b = torch.from_numpy(rhs(256, 1, 4)[None]).to(card)
    before = batched_lu.batched_lu_solve_vmem.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        batched_lu._solve(lu, b, batched_lu.batched_solve_plan(1, 256, 1, path="cluster", ctas=32))
    a = torch.from_numpy(band_dd(1000, 256, 5)).to(card)
    tiled = banded.banded_lu_tiled.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        banded._lu_tiled(a, bw=256, plan=banded.band_cluster_plan(256, ctas=32, group=8))
    assert (batched_lu.batched_lu_solve_vmem.launches, banded.banded_lu_tiled.launches) == (before, tiled)


def test_batched_solve_leaves_its_inputs_alone(card):
    lu = batched_lu.batched_lu_plain(torch.from_numpy(dd_stack(2, 64, 2)).to(card))
    b = torch.from_numpy(np.stack([rhs(64, 5, 3), rhs(64, 5, 4)])).to(card)
    lu0, b0 = lu.clone(), b.clone()
    batched_lu.batched_lu_solve_vmem(lu, b)
    torch.cuda.synchronize()
    assert torch.equal(lu, lu0) and torch.equal(b, b0)


@pytest.mark.parametrize("n,bw", BAND_SHAPES)
def test_batched_band_factor_kernel_is_bitwise_its_plain_version(n, bw, card):
    a = torch.from_numpy(band_stack(3, n, bw, n + bw)).to(card)
    before = banded.batched_banded_lu_vmem.launches
    got = banded.batched_banded_lu_vmem(a, bw=bw)
    assert banded.batched_banded_lu_vmem.launches == before + 1
    assert banded.batched_banded_lu_vmem.last_path == banded.band_lu_walk(n, bw)
    torch.cuda.synchronize()
    assert torch.equal(got, banded.banded_lu_plain(a, bw=bw))
    # each system's factor is the unbatched kernel's
    assert torch.equal(got[1], banded.banded_lu_blocked(a[1], bw=bw))


# B11 on the warp walk (bw <= 31), one warp a system: one system, a few,
# and more systems than the card has SMs; bands with entries outside the
# matrix; the ring walk past it (bw = 32)
@pytest.mark.parametrize("bsz", [1, 3, 200])
@pytest.mark.parametrize("bw", [1, 5, 16, 31, 32])
def test_batched_band_factor_warp_walk_is_bitwise_its_plain_version(bw, bsz, card):
    n = 257 if bsz == 200 else 1000 + bw
    a = torch.from_numpy(np.stack([any_band(n, bw, 19 * n + bw + i) for i in range(bsz)])).to(card)
    before = banded.batched_banded_lu_vmem.launches
    got = banded.batched_banded_lu_vmem(a, bw=bw)
    assert banded.batched_banded_lu_vmem.launches - before == 1
    assert banded.batched_banded_lu_vmem.last_path == banded.band_lu_walk(n, bw)
    torch.cuda.synchronize()
    assert torch.equal(got, banded.banded_lu_plain(a, bw=bw))


# the warp walk keeps the plain factor's NaN and inf positions system by system
@pytest.mark.parametrize("bw", [2, 5, 31])
def test_batched_band_factor_warp_walk_on_non_finite_systems(bw, card):
    n = 300
    a = np.stack([any_band(n, bw, n + bw + i, zero_pivot=i == 1) for i in range(4)])
    a[2, 7, bw] = np.nan
    a[3, 9, bw + 2] = np.inf
    a = torch.from_numpy(a).to(card)
    got, want = banded.batched_banded_lu_vmem(a, bw=bw), banded.banded_lu_plain(a, bw=bw)
    assert banded.batched_banded_lu_vmem.last_path == "warp walk"
    assert bool(torch.isfinite(want[0]).all()) and not bool(torch.isfinite(want[1:]).all())
    assert_same_non_finite(got, want)


@pytest.mark.parametrize("bsz,n,bw", [(0, 300, 5), (3, 0, 5), (0, 300, 40)])
def test_batched_band_factor_takes_an_empty_stack(bsz, n, bw, card):
    before = banded.batched_banded_lu_vmem.launches
    got = banded.batched_banded_lu_vmem(torch.zeros((bsz, n, 2 * bw + 1), device=card), bw=bw)
    assert got.shape == (bsz, n, 2 * bw + 1) and banded.batched_banded_lu_vmem.launches == before
    assert banded.batched_banded_lu_vmem.last_path == banded.band_lu_walk(n, bw)


def test_batched_band_factor_leaves_its_input_alone(card):
    a = torch.from_numpy(band_stack(2, 300, 16, 3)).to(card)
    before = a.clone()
    banded.batched_banded_lu_vmem(a, bw=16)
    torch.cuda.synchronize()
    assert torch.equal(a, before)


def band_solve_report(plan):
    """The C entry's report of a band solve launched by ``plan``."""
    if plan.path == "staged":
        return (1, plan.warps, plan.cols, plan.stages, plan.bytes)
    return (0, 0, plan.cols, 0, 0)


def assert_systems_are_b7(got, lu, b, bw, systems=None):
    """Each system of B12's ``got`` is bitwise B7 on that system alone,
    under the same plan."""
    torch.cuda.synchronize()
    for s in range(lu.shape[0]) if systems is None else systems:
        want = banded.banded_solve_kernelized(lu[s], b[s], bw=bw)
        torch.cuda.synchronize()
        assert torch.equal(got[s], want), f"system {s} differs from B7 on it alone"


# one system, a few and more than the card's SMs; every band shape (n (2bw+1)
# a multiple of 4 or not: the systems' bands start off 16-byte boundaries)
@pytest.mark.parametrize("bsz", [1, 3, 200])
@pytest.mark.parametrize("m", [None, 3, 40])
@pytest.mark.parametrize("n,bw", BAND_SHAPES)
def test_batched_band_solve_kernel_matches_plain(n, bw, m, bsz, card):
    lu = banded.banded_lu_plain(torch.from_numpy(band_stack(bsz, n, bw, n)).to(card), bw=bw)
    b = torch.from_numpy(np.stack([rhs(n, m, 5 + i) for i in range(bsz)])).to(card)
    lu0, b0 = lu.clone(), b.clone()
    before = banded.batched_banded_solve_vmem.launches
    got = banded.batched_banded_solve_vmem(lu, b, bw=bw)
    assert banded.batched_banded_solve_vmem.launches == before + 2
    assert banded.batched_banded_solve_vmem.last_plan == band_solve_report(banded.band_solve_plan(n, bw, m or 1))
    close(got, banded_solve_blocked(lu, b, bw=bw), 1e-5)
    assert torch.equal(lu, lu0) and torch.equal(b, b0)
    assert_systems_are_b7(got, lu, b, bw)


# the Poisson ensemble's shape (16 warps a block) and a band past the staged
# kernel's reach (bw = 900: two strips take 240 KB), on the per-warp kernel
@pytest.mark.parametrize("m", [None, 3])
@pytest.mark.parametrize("bsz,n,bw,path", [(3, 4096, 64, "staged"), (2, 2000, 900, "warp")])
def test_batched_band_solve_on_wide_bands(bsz, n, bw, path, m, card):
    lu = banded.banded_lu_plain(torch.from_numpy(band_stack(bsz, n, bw, 7 * n)).to(card), bw=bw)
    b = torch.from_numpy(np.stack([rhs(n, m, 70 + i) for i in range(bsz)])).to(card)
    plan = banded.band_solve_plan(n, bw, m or 1)
    assert plan.path == path
    before = banded.batched_banded_solve_vmem.launches
    got = banded.batched_banded_solve_vmem(lu, b, bw=bw)
    assert banded.batched_banded_solve_vmem.launches == before + 2
    assert banded.batched_banded_solve_vmem.last_plan == band_solve_report(plan)
    close(got, banded_solve_blocked(lu, b, bw=bw), 1e-5)
    assert_systems_are_b7(got, lu, b, bw)


# a plan forced onto the per-warp kernel, as the sweeps force it
def test_batched_band_solve_on_a_forced_warp_plan(card):
    n, bw = 257, 5
    lu = banded.banded_lu_plain(torch.from_numpy(band_stack(5, n, bw, 11)).to(card), bw=bw)
    b = torch.from_numpy(np.stack([rhs(n, 6, 80 + i) for i in range(5)])).to(card)
    warp = banded.BandSolvePlan("warp", 4, 4, 0, 0)
    got = banded.batched_banded_solve_vmem(lu, b, bw=bw, plan=warp)
    assert banded.batched_banded_solve_vmem.last_plan == (0, 0, 4, 0, 0)
    close(got, banded_solve_blocked(lu, b, bw=bw), 1e-5)
    for s in range(5):
        assert torch.equal(got[s], banded._solve(lu[s], b[s], bw=bw, plan=warp))


@pytest.mark.parametrize("bsz,n,m", [(0, 300, None), (3, 0, None), (3, 300, 0), (0, 300, 4)])
def test_batched_band_solve_takes_an_empty_stack(bsz, n, m, card):
    lu = torch.zeros((bsz, n, 11), device=card)
    b = torch.zeros((bsz, n) if m is None else (bsz, n, m), device=card)
    before = banded.batched_banded_solve_vmem.launches
    got = banded.batched_banded_solve_vmem(lu, b, bw=5)
    assert got.shape == b.shape and banded.batched_banded_solve_vmem.launches == before


def many_small_stack(bsz, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (bsz, n, n)).astype(np.float32)
    a[:, np.arange(n), np.arange(n)] = np.abs(a).sum(axis=2) + 1.0
    return a


# C8: more systems than a grid's y extent (65,535), in one launch each
def test_batched_solves_take_more_systems_than_a_grid_axis(card):
    bsz = 70_000
    lu = batched_lu.batched_lu_plain(torch.from_numpy(many_small_stack(bsz, 4, 90)).to(card))
    b = torch.from_numpy(np.random.default_rng(91).standard_normal((bsz, 4)).astype(np.float32)).to(card)
    before = batched_lu.batched_lu_solve_vmem.launches
    got = batched_lu.batched_lu_solve_vmem(lu, b)
    assert batched_lu.batched_lu_solve_vmem.launches == before + 1
    solve_plan_matches(card, bsz, 4, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, batched_lu.batched_lu_solve_plain(lu, b))

    n, bw = 8, 1
    rng = np.random.default_rng(92)
    band = rng.uniform(-1.0, 1.0, (bsz, n, 3)).astype(np.float32)
    band[:, 0, 0] = band[:, -1, 2] = 0.0
    band[:, :, 1] = np.abs(band).sum(axis=2) + 1.0
    lub = banded.banded_lu_plain(torch.from_numpy(band).to(card), bw=bw)
    bb = torch.from_numpy(rng.standard_normal((bsz, n)).astype(np.float32)).to(card)
    before = banded.batched_banded_solve_vmem.launches
    got = banded.batched_banded_solve_vmem(lub, bb, bw=bw)
    assert banded.batched_banded_solve_vmem.launches == before + 2
    assert banded.batched_banded_solve_vmem.last_plan == band_solve_report(banded.band_solve_plan(n, bw, 1))
    close(got, banded_solve_blocked(lub, bb, bw=bw), 1e-5)
    assert_systems_are_b7(got, lub, bb, bw, (0, 1, 65_534, 65_535, 65_536, bsz - 1))


# C9: a tridiagonal band of S = 65,537 diagonal blocks of C = 32 rows, past
# the grid's z extent, in six launches, against B7 on the same factor
def test_inverted_band_solve_past_a_grid_axis_of_blocks(card):
    n, bw = 2_097_157, 1
    lu = banded.banded_lu_blocked(torch.from_numpy(band_dd(n, bw, 93)).to(card), bw=bw)
    f = factorize_banded(lu, bw=bw)
    assert f.linv.shape[:2] == (65_537, 32)
    b = torch.from_numpy(rhs(n, None, 94)).to(card)
    before = banded.banded_solve_inverted.launches
    got = banded.banded_solve_inverted(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw)
    assert banded.banded_solve_inverted.launches - before == 6
    close(got, banded.banded_solve_kernelized(lu, b, bw=bw), 1e-5)


def test_batched_main_paths_dispatch_the_kernels(card):
    a = torch.from_numpy(dd_stack(4, 100, 3)).to(card)
    b = torch.from_numpy(np.stack([rhs(100, 2, i) for i in range(4)])).to(card)
    ab = torch.from_numpy(band_stack(3, 500, 5, 4)).to(card)
    bb = torch.from_numpy(np.stack([rhs(500, None, i) for i in range(3)])).to(card)
    wrappers = (batched_lu.batched_lu_vmem, batched_lu.batched_lu_solve_vmem,
                banded.batched_banded_lu_vmem, banded.batched_banded_solve_vmem)
    before = [w.launches for w in wrappers]
    with solvers.record_dispatches() as log:
        x = ops.linear_solve(a, b)
        xb = ops.banded_linear_solve(ab, bb, bw=5)
    assert [name for _, name in log] == ["cuda_vmem"] * 4
    # the dense factor and the band solve each with their non-finite pass
    assert [w.launches - c for w, c in zip(wrappers, before)] == [2, 1, 1, 2]
    assert float(relative_residual(a, b, x)) < 1e-5
    assert float(relative_residual(ab, bb, xb, bw=5)) < 1e-5


def test_the_optimizer_step_runs_the_batched_kernels(card):
    # two order-16 systems (left and right covariance) and an AdamW leaf;
    # the step on the card matches the same step on the CPU
    rng = np.random.default_rng(3)
    shapes = {"w1": (16, 40), "w2": (64, 16), "bias": (16,)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    steps = {}
    for dev in ("cpu", card):
        ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dev)) for k, v in params.items()}
        opt = train.EbvPreconditioned(list(ps.values()), lr=1e-2)
        for k, p in ps.items():
            p.grad = torch.from_numpy(grads[k]).to(dev)
        before = (batched_lu.batched_lu_vmem.launches, batched_lu.batched_lu_solve_vmem.launches)
        with solvers.record_dispatches() as log:
            opt.step()
        steps[str(dev)] = {k: p.detach().cpu() for k, p in ps.items()}
        assert [name for _, name in log] == ["cuda_vmem", "cuda_vmem"]
        if dev == card:
            assert (batched_lu.batched_lu_vmem.launches - before[0],
                    batched_lu.batched_lu_solve_vmem.launches - before[1]) == (2, 1)
    for k in shapes:
        close(steps["cuda"][k], steps["cpu"][k])


# ---------------------------------------------------------------------------
# the legacy dense kernels (B14-B17) and the paths that reach them
# ---------------------------------------------------------------------------
LEGACY_F32_TOL, LEGACY_BF16_TOL = 1e-5, 2e-2


def legacy_panel(m, b, seed, dtype):
    p = dd(m, seed)[:, :b].copy()
    p[:b, :b] = dd(b, seed + 1)
    return torch.from_numpy(p).to(dtype)


def assert_walk_plan(wrapper, m, ncols, dtype, card):
    """The C entry launched the plan its Python mirror names."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    want = ebv_lu.legacy_walk_plan(m, ncols, dtype, sms)
    assert wrapper.last_plan == (want.parts, want.theta, want.bytes)


# odd and even n; n = 2 and 3 (one block); the reference's cap less one
# (rows streamed below theta = 1519 in fp32)
@pytest.mark.parametrize("n", [2, 3, 64, 263, 500, 1001, 2000, 4095])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lu_vmem_kernel_is_bitwise_its_plain_version(n, dtype, card):
    a = torch.from_numpy(dd(n, n)).to(dtype).to(card)
    keep = a.clone()
    before = ebv_lu.lu_vmem.launches
    got = ebv_lu.lu_vmem(a)
    torch.cuda.synchronize()
    assert ebv_lu.lu_vmem.launches - before == 1  # one cooperative launch
    assert torch.equal(got, ebv_lu.lu_vmem_plain(a)) and torch.equal(a, keep)
    assert_walk_plan(ebv_lu.lu_vmem, n, n, dtype, card)


# each side of the resident/streamed split: every row in shared memory up to
# n = 2641 (fp32) and 3698 (bf16), rows streamed below theta = 1 above
@pytest.mark.parametrize("n,dtype", [(2641, torch.float32), (2642, torch.float32),
                                     (3698, torch.bfloat16), (3699, torch.bfloat16)])
def test_lu_vmem_kernel_on_each_side_of_the_resident_split(n, dtype, card):
    a = torch.from_numpy(dd(n, n + 1)).to(dtype).to(card)
    before = ebv_lu.lu_vmem.launches
    got = ebv_lu.lu_vmem(a)
    torch.cuda.synchronize()
    assert ebv_lu.lu_vmem.launches - before == 1
    assert torch.equal(got, ebv_lu.lu_vmem_plain(a))
    assert_walk_plan(ebv_lu.lu_vmem, n, n, dtype, card)


def assert_same_non_finite(got, want):
    """NaN where the plain version has NaN, and every other value (inf
    among them) equal."""
    torch.cuda.synchronize()
    gnan, wnan = torch.isnan(got), torch.isnan(want)
    assert torch.equal(gnan, wnan)
    assert torch.equal(got.masked_fill(gnan, 0), want.masked_fill(wnan, 0))


# a zero first pivot; rows p-1 and p equal, so pivot p turns exactly zero at
# step p (the plain version's masked steps then spread NaN left of the rows
# and above the columns the infinities reach)
@pytest.mark.parametrize("n,p", [(263, 0), (263, 5), (1001, 700), (4095, 2000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lu_vmem_on_a_zero_pivot_gives_the_plain_non_finite_pattern(n, p, dtype, card):
    a = dd(n, n + p)
    if p == 0:
        a[0, 0] = 0.0
    else:
        a[p] = a[p - 1]
    a = torch.from_numpy(a).to(dtype).to(card)
    before = ebv_lu.lu_vmem.launches
    got = ebv_lu.lu_vmem(a)  # returns: no wait of the walk depends on a value
    want = ebv_lu.lu_vmem_plain(a)
    assert ebv_lu.lu_vmem.launches - before == 1
    assert not bool(torch.isfinite(want).all())
    assert_same_non_finite(got, want)


def test_the_cooperative_walk_at_the_reference_cap(card):
    a = torch.from_numpy(dd(4096, 5)).to(card)
    before = ebv_lu.lu_vmem.launches
    got = ebv_lu.lu_vmem(a)
    torch.cuda.synchronize()
    assert ebv_lu.lu_vmem.launches - before == 1
    assert torch.equal(got, ebv_lu.lu_vmem_plain(a))


@pytest.mark.parametrize("m,b", [(2000, 256), (8000, 256), (100, 32), (64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_panel_kernel_is_bitwise_its_plain_version(m, b, dtype, card):
    p = legacy_panel(m, b, m + b, dtype).to(card)
    before = ebv_lu.panel.launches
    got = ebv_lu.panel(p)
    torch.cuda.synchronize()
    assert ebv_lu.panel.launches - before == 1
    assert torch.equal(got, ebv_lu.panel_plain(p))
    assert_walk_plan(ebv_lu.panel, m, b, dtype, card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_step_kernel_matches_plain(dtype, card):
    # the driver's first step at n = 2000: width 1744 padded to 1792, ct = 128
    a = torch.from_numpy(dd(2000, 7)).to(dtype).to(card)
    pan = ebv_lu.panel(a[:, :256])
    top = torch.nn.functional.pad(a[:256, 256:], (0, 48))
    trail = torch.nn.functional.pad(a[256:, 256:], (0, 48))
    before = ebv_lu.fused_step.launches
    u12, new = ebv_lu.fused_step(pan, top, trail, col_tile=128)
    pu12, pnew = ebv_lu.fused_step_plain(pan, top, trail)
    assert ebv_lu.fused_step.launches - before == 2  # the U12 solve, then the product
    tol = LEGACY_F32_TOL if dtype == torch.float32 else LEGACY_BF16_TOL
    assert u12.dtype == new.dtype == dtype
    assert torch.equal(u12, pu12)  # the solve rounds every operation as the plain version does
    close(new.float(), pnew.float(), tol)


def fused_step_inputs(m, b, w, dtype, card, seed):
    p = dd(m, seed)[:, :b].copy()
    p[:b, :b] = dd(b, seed + 1)
    pan = ebv_lu.panel(torch.from_numpy(p).to(dtype).to(card))
    g = torch.Generator(device=card).manual_seed(seed)
    top, trail = (torch.randn(s, generator=g, device=card).to(dtype) for s in ((b, w), (m - b, w)))
    return pan, top, trail


# ragged tiles of 16 columns and strips of 32 pivots; a last strip of 4; b < 32;
# m = b (no trailing rows: the solve alone); the driver's first step at n = 8000
@pytest.mark.parametrize("m,b,w", [(300, 100, 33), (100, 7, 5), (64, 36, 16), (64, 64, 24), (40, 1, 3),
                                   (8000, 256, 7744)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_step_kernel_at_ragged_shapes(m, b, w, dtype, card):
    pan, top, trail = fused_step_inputs(m, b, w, dtype, card, m + b + w)
    before = ebv_lu.fused_step.launches
    u12, new = ebv_lu.fused_step(pan, top, trail, col_tile=w)
    pu12, pnew = ebv_lu.fused_step_plain(pan, top, trail)
    assert ebv_lu.fused_step.launches - before == (2 if m > b else 1)
    assert torch.equal(u12, pu12) and new.shape == pnew.shape
    if m > b:
        close(new.float(), pnew.float(), LEGACY_F32_TOL if dtype == torch.float32 else LEGACY_BF16_TOL)


# C6: a U12 column holding a non-finite value (an inf in A12, or an inf in
# L11 meeting an exact zero of U12) is NaN throughout, in U12 and in A22,
# as the plain version's masked axpys make it
@pytest.mark.parametrize("poison", ["a12_inf", "l11_zero_times_inf"])
@pytest.mark.parametrize("m,b,w", [(2000, 256, 1792), (300, 100, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_step_turns_a_non_finite_column_nan_as_the_plain_version(m, b, w, poison, dtype, card):
    pan, top, trail = fused_step_inputs(m, b, w, dtype, card, 2 * m + b)
    if poison == "a12_inf":
        top[2, 1] = float("inf")
    else:
        top[0, 0] = 0.0
        pan[1, 0] = float("inf")
    u12, new = ebv_lu.fused_step(pan, top, trail, col_tile=w)
    pu12, pnew = ebv_lu.fused_step_plain(pan, top, trail)
    assert bool(torch.isnan(pu12[:, 1 if poison == "a12_inf" else 0]).all())
    assert bool(torch.isnan(pnew[:, 1 if poison == "a12_inf" else 0]).all())
    assert_same_non_finite(u12, pu12)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(new), torch.isnan(pnew))
    finite = ~torch.isnan(pnew)
    if bool(finite.any()):
        close(new[finite].float(), pnew[finite].float(),
              LEGACY_F32_TOL if dtype == torch.float32 else LEGACY_BF16_TOL)


# the blocked factor's first trailing block at n = 2000; ragged edges in rows,
# columns and depth (no 16-byte rows at w = 33 and 65); one element; a
# narrow tall block
@pytest.mark.parametrize("m,k,w", [(1792, 256, 1792), (128, 32, 64), (100, 7, 33), (129, 16, 65), (1, 1, 1),
                                   (1000, 256, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_kernel_matches_plain(m, k, w, dtype, card):
    g = torch.Generator(device=card).manual_seed(m + k)
    l21, u12, a22 = (torch.randn(s, generator=g, device=card).to(dtype) for s in ((m, k), (k, w), (m, w)))
    keep = a22.clone()
    before = ebv_lu.update.launches
    got = ebv_lu.update(l21, u12, a22, row_tile=m, col_tile=w)
    assert ebv_lu.update.launches - before == 1 and torch.equal(a22, keep)
    tol = LEGACY_F32_TOL if dtype == torch.float32 else LEGACY_BF16_TOL
    close(got.float(), ebv_lu.update_plain(l21, u12, a22).float(), tol)


@pytest.mark.parametrize("impl,n", [("cuda_vmem", 300), ("cuda_blocked", 300), ("cuda_blocked", 1000)])
def test_forced_legacy_impls_launch_their_kernels(impl, n, card):
    a = torch.from_numpy(dd(n, 9)).to(card)
    b = torch.from_numpy(rhs(n, 2)).to(card)
    counters = (ebv_lu.lu_vmem, ebv_lu.panel, ebv_lu.fused_step)
    before = [w.launches for w in counters]
    with solvers.record_dispatches() as log:
        x = ops.lu_solve(ops.lu(a, impl=impl), b)
    torch.cuda.synchronize()
    assert [name for _, name in log][0] == impl
    blocks = -(-n // 256)
    # a fused step is two launches: the U12 solve and the trailing product
    want = [1, 0, 0] if impl == "cuda_vmem" else [0, blocks, 2 * (blocks - 1)]
    assert [w.launches - c for w, c in zip(counters, before)] == want
    assert float(relative_residual(a, b, x)) < 1e-5


def test_the_escalation_chain_on_the_card(card):
    a = dd(64, 14)
    a[0, 0] = np.nan
    with pytest.raises(solvers.SolveFailure) as err:
        ops.lu(torch.from_numpy(a).to(card), health=True)
    assert [c["backend"] for c in err.value.chain] == [
        "cuda_fused", "torch", "cuda_vmem", "pivoted", "cuda_blocked"]
    solvers.clear_demotions()
    band = band_dd(300, 5, 15)
    band[7, 5] = np.nan
    before = banded.banded_lu_kernelized.launches
    with pytest.raises(solvers.SolveFailure) as err:
        ops.banded_lu(torch.from_numpy(band).to(card), bw=5, health=True)
    assert [c["backend"] for c in err.value.chain] == [
        "cuda_blocked", "cuda_tiled", "torch", "cuda_scalar", "torch_scalar"]
    assert banded.banded_lu_kernelized.launches == before + 1
    solvers.clear_demotions()


def test_the_tiers_run_the_kernels(card):
    a = torch.from_numpy(dd(512, 10)).to(card)
    b = torch.from_numpy(rhs(512, 3)).to(card)
    before = (ebv_lu.lu_fused.launches, trsm.solve_inverted.launches)
    with solvers.record_dispatches() as log:
        x = ops.linear_solve(a, b, tolerance=1e-5)
    torch.cuda.synchronize()
    assert [name for _, name in log] == ["bf16_ir"]
    # the first answer and at least one refinement sweep, each a full inverted solve
    assert ebv_lu.lu_fused.launches > before[0]
    assert trsm.solve_inverted.launches >= before[1] + 2 * trsm.inverted_launches(512, 256)
    assert float(relative_residual(a, b, x)) <= 1e-5
    rng = np.random.default_rng(11)
    low = (rng.standard_normal((256, 32)) @ rng.standard_normal((32, 256)) / 32).astype(np.float32)
    al = torch.from_numpy(low).to(card)
    bl = al @ torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(card)
    xl = ops.linear_solve(al, bl, rank=32, tolerance=1e-3)
    assert float(relative_residual(al, bl, xl)) <= 1e-3


def test_a_service_flush_on_the_card(card):
    svc = SolveService()
    mats = {n: dd(n, n) for n in (300, 700)}
    band = torch.from_numpy(band_dd(2000, 5, 3)).to(card)
    reqs = []
    for i in range(4):
        for n, a in mats.items():
            reqs.append((a, rhs(n, 1 if i % 2 == 0 else 4, 30 + i), 0))
        reqs.append((band, torch.from_numpy(rhs(2000, None, 40 + i)).to(card), 5))
    before = ebv_lu.lu_fused.launches
    tickets = [svc.submit(a, b, bw=bw) for a, b, bw in reqs]
    out = svc.flush()
    torch.cuda.synchronize()
    assert ebv_lu.lu_fused.launches > before
    assert (svc.stats.factor_dispatches, svc.stats.solve_dispatches) == (3, 3)
    for tk, (a, b, bw) in zip(tickets, reqs):
        at = a if isinstance(a, torch.Tensor) else torch.from_numpy(a).to(card)
        bt = b if isinstance(b, torch.Tensor) else torch.from_numpy(b).to(card)
        assert out[tk].device.type == "cuda"
        assert float(relative_residual(at, bt, out[tk], bw=bw)) < 1e-5
    tk = svc.submit(mats[300], rhs(300, None, 50))
    svc.flush()
    assert svc.stats.factor_dispatches == 3 and svc.stats.cache_hits > svc.stats.cache_misses
    svc.result(tk)


# ---------------------------------------------------------------------------
# the paged decode attention (B13) and the serving path
# ---------------------------------------------------------------------------
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def paged_inputs(b, h, kv, dh, page, np_, pool, dtype, card, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(card, dtype)
    kp = torch.from_numpy(rng.standard_normal((pool, page, kv, dh)).astype(np.float32)).to(card, dtype)
    vp = torch.from_numpy(rng.standard_normal((pool, page, kv, dh)).astype(np.float32)).to(card, dtype)
    table = rng.integers(1, pool, (b, np_)).astype(np.int32)
    table[0, 0] = -1          # a hole inside the live length
    table[-1, np_ // 2] = -1  # another, mid-row
    table[:, -1] = -1         # holes at and past the end
    lengths = rng.integers(1, np_ * page + 1, b).astype(np.int32)
    lengths[0] = np_ * page - page // 2  # ends mid-page
    return q, kp, vp, torch.from_numpy(table).to(card), torch.from_numpy(lengths).to(card)


# (B, H, KV, Dh, page, NP, pool): llama3-8b's served shape (rep 4); rep 1;
# the reduced config; a row too long for its scores in shared memory;
# whisper-tiny's served shape (8 slots of 448 positions, H = KV = 6, Dh 64);
# granite-moe-1b-a400m's (8 slots of 768 positions, H = 16, KV = 8: rep 2, Dh 64)
PAGED_SHAPES = [(4, 32, 8, 128, 16, 37, 149), (4, 8, 8, 128, 16, 37, 149), (3, 4, 2, 16, 8, 8, 30),
                (2, 4, 1, 64, 16, 600, 1300), (8, 6, 6, 64, 16, 28, 225), (8, 16, 8, 64, 16, 48, 385)]


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(shape, dtype, card):
    args = paged_inputs(*shape, dtype, card, seed=sum(shape))
    before = paged_attn.paged_decode_attention.launches
    got = paged_attn.paged_decode_attention(*args)
    assert paged_attn.paged_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[1] * shape[3])
    close(got, paged_attn.paged_decode_attention_plain(*args), PAGED_TOL[dtype])


# the served shape (llama3-8b, 4 rows of 36 pages), the decode-heavy one
# (32 rows of 256 pages) and granite-moe-1b-a400m's (8 rows of 48 pages,
# H = 16, KV = 8: rep 2, Dh 64): holes, a row of length 0, lengths off a
# page boundary, a page id past the pool; every cluster size, one launch a
# call
def paged_edge_inputs(b, h, kv, dh, np_, dtype, card, seed):
    q, kp, vp, table, lengths = paged_inputs(b, h, kv, dh, 16, np_, b * np_ + 1, dtype, card, seed)
    lengths[1] = 0
    lengths[2] = 16 * (np_ // 3) + 1
    table[3, 0] = kp.shape[0] + 5  # clamped to the last page
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("b,h,kv,dh,np_", [(4, 32, 8, 128, 36), (32, 32, 8, 128, 256), (8, 16, 8, 64, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_at_each_cluster_size(b, h, kv, dh, np_, ctas, dtype, card):
    args = paged_edge_inputs(b, h, kv, dh, np_, dtype, card, seed=b + ctas)
    plan = paged_attn.paged_plan(b, h, kv, dh, np_, 16, args[0].element_size(),
                                 torch.cuda.get_device_properties(card).multi_processor_count, ctas=ctas)
    before = paged_attn.paged_decode_attention.launches
    got = paged_attn._attend(*args, plan)
    assert paged_attn.paged_decode_attention.launches == before + 1
    k, groups, pages, smem, nbytes, active = paged_attn.paged_decode_attention.last_plan
    assert (k, groups, pages, bool(smem), nbytes) == tuple(plan) and active >= 1
    close(got, paged_attn.paged_decode_attention_plain(*args), PAGED_TOL[dtype])


def test_paged_attention_plan_reads_only_shapes(card):
    """The plan the wrapper launches depends on the shapes alone: 4 CTAs a
    cluster at the served shape, 2 at 32 rows, whatever the lengths."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, np_, want in ((4, 36, 4 if sms >= 128 else None), (32, 256, 2)):
        args = paged_edge_inputs(b, 32, 8, 128, np_, torch.bfloat16, card, seed=7)
        for lengths in (args[4], torch.zeros_like(args[4])):
            paged_attn.paged_decode_attention(*args[:4], lengths)
            assert paged_attn.paged_decode_attention.last_plan[0] == (
                want or paged_attn.paged_plan(b, 32, 8, 128, np_, 16, 2, sms).ctas)


def test_a_paged_attention_launch_that_fails_raises(card, monkeypatch):
    args = paged_inputs(*PAGED_SHAPES[2], torch.float32, card)

    class Refusing:  # a library whose launch reports cudaErrorInvalidConfiguration
        def ebv_paged_decode_attention(self, *a):
            return 9

        def ebv_error_string(self, code):
            return b"invalid configuration argument"

    before = paged_attn.paged_decode_attention.launches
    monkeypatch.setattr(_build, "library", lambda: Refusing())
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        paged_attn.paged_decode_attention(*args)
    assert paged_attn.paged_decode_attention.launches == before

    def broken():
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="failed to load"):
        paged_attn.paged_decode_attention(*args)


def test_a_paged_serve_on_the_card_equals_the_dense_one(card):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenRequest

    cfg = get_config("llama3_8b").reduced()
    model = lm.init_params(0, cfg, device=card)
    rng = np.random.default_rng(42)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32), n, seed=i)
            for i, (s, n) in enumerate(zip([3, 9, 5, 12, 2, 7], [9, 2, 5, 3, 11, 4]))]
    dense = Engine(model, cfg, max_len=64, slots=4, bucket=4)
    want = dense.serve(reqs)
    paged = Engine(model, cfg, max_len=64, slots=4, bucket=4, paged=True, page_size=8)
    before = paged_attn.paged_decode_attention.launches
    got = paged.serve(reqs)
    assert paged_attn.paged_decode_attention.launches - before == \
        cfg.num_layers * paged.stats.decode_dispatches
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_a_whisper_paged_serve_on_the_card_equals_the_dense_one(card):
    # the encdec family: one bucket a call, per-slot cross K/V beside the pool
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenRequest

    cfg = get_config("whisper_tiny").reduced()
    model = lm.init_params(0, cfg, device=card)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32), n, seed=i)
            for i, (s, n) in enumerate([(5, 4), (8, 2), (3, 6), (11, 9), (2, 5)])]
    dense = Engine(model, cfg, max_len=64, slots=2, bucket=4)
    want = dense.serve(reqs)
    paged = Engine(model, cfg, max_len=64, slots=2, bucket=4, paged=True, page_size=16)
    before = paged_attn.paged_decode_attention.launches
    got = paged.serve(reqs)
    assert paged_attn.paged_decode_attention.launches - before == \
        cfg.num_layers * paged.stats.decode_dispatches
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_a_moe_paged_decode_on_the_card_matches_the_dense_one(card):
    # the moe family: B13 sums in its own order, and a router near tie can
    # turn on that, so the paged steps are held to the dense ones teacher-
    # forced, in fp32, and the paged serve to B13's launches
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, GenRequest

    cfg = get_config("granite_moe_1b_a400m").reduced()
    model = lm.init_params(0, cfg, device=card)
    rng = np.random.default_rng(1)
    lengths, page, np_ = (5, 11, 3), 4, 8
    dcache = lm.init_caches(cfg, 3, page * np_, device=card)
    pcache = lm.init_paged_caches(cfg, 3, 3 * np_ + 1, page, device=card)
    table = (1 + torch.arange(3 * np_, device=card, dtype=torch.int32)).reshape(3, np_)
    for r, s0 in enumerate(lengths):
        raw, _ = lm.prefill(model, {"tokens": rng.integers(0, cfg.vocab_size, (1, s0)).astype(np.int32)}, cfg,
                            raw_kv=True)
        npg = -(-s0 // page)
        for key in ("k", "v"):
            fresh = raw["attn"][key][:, 0]
            dcache["attn"][key][:, r, :s0] = fresh
            pages = torch.nn.functional.pad(fresh, (0, 0, 0, 0, 0, npg * page - s0))
            pcache["attn"][f"{key}_pages"][:, table[r, :npg].long()] = pages.reshape(
                cfg.num_layers, npg, page, cfg.num_kv_heads, cfg.resolved_head_dim)
        ar = torch.arange(page * np_, device=card, dtype=torch.int32)
        dcache["attn"]["pos"][:, r] = torch.where(ar < s0, ar, -1)
    pos = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = paged_attn.paged_decode_attention.launches
    for step in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).to(card)
        _, want = lm.decode_step(model, dcache, tok, pos, cfg)
        _, got = lm.decode_step(model, pcache, tok, pos, cfg, page_table=table)
        close(got, want)
        pos += 1
    assert paged_attn.paged_decode_attention.launches - before == 6 * cfg.num_layers
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32), n, seed=i)
            for i, (s, n) in enumerate([(5, 4), (8, 2), (3, 6), (11, 9), (2, 5)])]
    paged = Engine(model, cfg, max_len=64, slots=2, bucket=4, paged=True, page_size=16)
    before = paged_attn.paged_decode_attention.launches
    got = paged.serve(reqs)
    assert paged_attn.paged_decode_attention.launches - before == \
        cfg.num_layers * paged.stats.decode_dispatches
    assert [len(g) for g in got] == [len(r.tokens) + r.max_new_tokens for r in reqs]


# ---------------------------------------------------------------------------
# faults C10-C12: the factors and solves on a non-finite value spread NaN as
# their plain versions' masked steps do (csrc/nonfinite.cuh), and the dense
# solves take any RHS width
# ---------------------------------------------------------------------------
def assert_same_positions(got, want, tol=TOL):
    """NaN, inf and -inf where the plain version has them, the finite
    entries within ``tol`` normwise (the kernels sum in other orders)."""
    torch.cuda.synchronize()
    got, want = got.double().cpu(), want.double().cpu()
    for where in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(where(got), where(want))
    fin = torch.isfinite(want)
    assert not bool(fin.all())
    close(got.masked_fill(~fin, 0), want.masked_fill(~fin, 0), tol)


def poisoned(a, where):
    a = a.copy()
    for idx, v in where:
        a[idx] = v
    return a


DENSE_POISONS = {"upper inf": [((2, 30), np.inf)], "lower inf": [((30, 2), np.inf)],
                 "diagonal nan": [((20, 20), np.nan)]}


@pytest.mark.parametrize("poison", DENSE_POISONS)
def test_fused_factor_on_a_non_finite_entry_gives_the_plain_pattern(poison, card):
    a = torch.from_numpy(poisoned(dd(40, 1), DENSE_POISONS[poison])).to(card)
    want = ebv_lu.lu_fused_plain(a, block=16)
    assert_same_positions(ebv_lu.lu_fused(a, block=16), want)


@pytest.mark.parametrize("where", [[((7, 300), np.inf)], [((300, 7), -np.inf)], [((250, 250), np.nan)],
                                   [((499, 3), np.inf)], [((130, 131), np.nan), ((400, 20), -np.inf)]])
def test_fused_factor_at_n500_on_non_finite_entries_gives_the_plain_pattern(where, card):
    a = torch.from_numpy(poisoned(dd(500, 5), where)).to(card)
    assert_same_positions(ebv_lu.lu_fused(a), ebv_lu.lu_fused_plain(a))


# the replay's two paths: bit masks where the plain strip is at most 64
# columns (n = 1000: B = 128, C2 = 32, 8 steps; block 50: C2 = 50), entry by
# entry past it (n = 251: B = C2 = 125, 3 steps; block 100: C2 = 100, 7 steps)
@pytest.mark.parametrize("n,block", [(1000, 256), (600, 50), (251, 256), (700, 100)])
def test_fused_factor_replay_paths_give_the_plain_pattern(n, block, card):
    for where in ([((n // 3, n // 2), np.nan)], [((0, 0), 0.0)], [((n - 1, 2), np.inf), ((5, n - 2), -np.inf)]):
        a = torch.from_numpy(poisoned(dd(n, 7), where)).to(card)
        assert_same_positions(ebv_lu.lu_fused(a, block=block), ebv_lu.lu_fused_plain(a, block=block))


def test_fused_factor_stays_finite_and_unchanged_without_a_non_finite_entry(card):
    a = torch.from_numpy(dd(600, 6)).to(card)
    got = ebv_lu.lu_fused(a, block=50)
    close_lu(got, ebv_lu.lu_fused_plain(a, block=50))


@pytest.mark.parametrize("stack,where", [
    ((24, 3), [((1, 2, 20), np.inf)]),
    ((384, 2), [((1, 5, 300), -np.inf), ((0, 200, 100), np.nan)]),
    ((256, 4), [((3, 0, 0), 0.0)]),
])
def test_batched_factor_on_non_finite_entries_equals_the_plain_pattern(stack, where, card):
    n, bsz = stack
    a = torch.from_numpy(poisoned(np.stack([dd(n, s) for s in range(bsz)]), where)).to(card)
    want = batched_lu.batched_lu_plain(a)
    assert_same_non_finite(batched_lu.batched_lu_vmem(a), want)
    assert not bool(torch.isfinite(want).all())


def _dense_solve_inputs(n, m, card, lu_at, b_at):
    lu = ebv_lu.lu_fused(torch.from_numpy(dd(n, 1)).to(card))
    b = torch.from_numpy(rhs(n, m, 3)).to(card)
    for idx in lu_at:
        lu[idx] = float("nan")
    for idx in b_at:
        b[idx] = float("inf")
    return lu, b


SOLVE_POISONS = {"factor nan": ([(5, 30)], []), "b inf in the last row": ([], [(39, 1)]),
                 "b inf above": ([], [(11, 0)])}


@pytest.mark.parametrize("poison", SOLVE_POISONS)
def test_dense_solves_on_a_non_finite_value_give_the_plain_pattern(poison, card):
    lu, b = _dense_solve_inputs(40, 3, card, *SOLVE_POISONS[poison])
    assert_same_positions(trsm.solve_vmem(lu, b), trsm.solve_vmem_plain(lu, b))
    assert_same_positions(trsm.solve_tiled(lu, b, block=16), trsm.solve_tiled_plain(lu, b, block=16))
    lus = torch.stack([lu, torch.eye(40, device=card) * 2, lu])
    bs = torch.stack([b, torch.ones_like(b), torch.zeros_like(b)])
    assert_same_non_finite(batched_lu.batched_lu_solve_vmem(lus, bs), batched_lu.batched_lu_solve_plain(lus, bs))


@pytest.mark.parametrize("n,m", [(2000, 1), (2000, 64), (8000, 1)])
def test_dense_solves_at_their_shapes_on_non_finite_values(n, m, card):
    lu, b = _dense_solve_inputs(n, m, card, [(100, n - 500)], [(n - 1, 0)])
    assert_same_positions(trsm.solve_tiled(lu, b), trsm.solve_tiled_plain(lu, b))
    if n <= 2000:
        assert_same_positions(trsm.solve_vmem(lu, b), trsm.solve_vmem_plain(lu, b))


@pytest.mark.parametrize("path", ["wide", "cluster"])
def test_batched_solve_paths_on_non_finite_values_equal_the_plain_pattern(path, card):
    n, m = 384, 8
    lu = batched_lu.batched_lu_vmem(torch.from_numpy(np.stack([dd(n, s) for s in range(2)])).to(card))
    b = torch.from_numpy(np.stack([rhs(n, m, s) for s in range(2)])).to(card)
    lu[0, 40, 300] = float("nan")
    b[1, n - 1, 3] = -float("inf")
    assert_same_non_finite(solve_on(card, lu, b, path), batched_lu.batched_lu_solve_plain(lu, b))


@pytest.mark.parametrize("n,bw,m,at", [(97, 5, 2, (10, 6)), (97, 5, 2, (50, 1)), (16000, 5, 1, (5000, 7)),
                                       (4096, 64, 1, (4000, 10)), (300, 16, 8, (299, 3))])
def test_band_solves_on_a_non_finite_factor_entry_give_the_plain_pattern(n, bw, m, at, card):
    clean = banded.banded_lu_blocked(torch.from_numpy(band_dd(n, bw, 4)).to(card), bw=bw)
    lu = clean.clone()
    lu[at] = float("inf")
    b = torch.from_numpy(rhs(n, m, 5)).to(card)
    want = banded_solve_blocked(lu, b, bw=bw)
    assert_same_positions(banded.banded_solve_kernelized(lu, b, bw=bw), want)
    lus, bs = torch.stack([lu, clean, lu]), torch.stack([b, b, b])
    assert_same_positions(banded.batched_banded_solve_vmem(lus, bs, bw=bw), banded_solve_blocked(lus, bs, bw=bw))


def test_band_solve_on_an_inf_in_b_follows_the_plain_blocking(card):
    n, bw = 200, 3
    lu = banded.banded_lu_blocked(torch.from_numpy(band_dd(n, bw, 6)).to(card), bw=bw)
    b = torch.from_numpy(rhs(n, 2, 7))
    b[150, 1] = float("inf")
    b = b.to(card)
    for block in (None, 16, 64):
        assert_same_positions(banded.banded_solve_kernelized(lu, b, bw=bw, block=block),
                              banded_solve_blocked(lu, b, bw=bw, block=block))


def test_dense_solves_take_more_columns_than_a_grid_axis_of_tiles(card):
    # C12: 65,537 column tiles of 64 on one grid axis; b, x and y 1.07 GB each
    n, m = 64, 4_194_305
    lu = ebv_lu.lu_fused(torch.from_numpy(dd(n, 8)).to(card))
    b = torch.randn((n, m), generator=torch.Generator(device=card).manual_seed(9), device=card)
    before = trsm.solve_tiled.launches
    x = trsm.solve_tiled(lu, b)
    assert trsm.solve_tiled.launches - before == trsm.tiled_launches(n) == 3
    assert trsm.solve_tiled.last_grid > 65_535  # the C entry's largest step grid
    close(x, trsm.solve_tiled_plain(lu, b), 1e-5)
    linv, uinv = dense_block_inverses(lu, block=32)
    before = trsm.solve_inverted.launches
    xi = trsm.solve_inverted(lu, linv, uinv, b)
    assert trsm.solve_inverted.launches - before == trsm.inverted_launches(n, 32)
    close(xi, dense_inverted_solve(lu, linv, uinv, b), 1e-5)


# B8: the products a thread per row up to 4 RHS columns, the tail recurrence
# one warp per group of RHS columns up to bw = 32 (the block kernel past
# it), the same sums in the same order as the tiles and the block kernel
# (banded._solve_inverted(..., tiles=True)), so bitwise equal to them, and
# within 1e-4 of the plain
# version (a sequential loop of batched products, rounded otherwise); S =
# 1, 2 and 128 diagonal blocks at each bw
B8_BANDS = {1: (32, 33, 4065), 5: (40, 41, 5081), 16: (128, 129, 16257), 31: (248, 249, 31497),
            64: (256, 257, 32513), 256: (256, 257, 32513)}


@pytest.mark.parametrize("blocks", [0, 1, 2])
@pytest.mark.parametrize("bw", list(B8_BANDS))
def test_inverted_band_solve_scan_paths(bw, blocks, card):
    n = B8_BANDS[bw][blocks]
    lu = banded.banded_lu_tiled(torch.from_numpy(band_dd(n, bw, bw + blocks)).to(card), bw=bw)
    f = factorize_banded(lu, bw=bw)
    assert f.linv.shape[0] == (1, 2, 128)[blocks]
    args = (f.linv, f.uinv, f.tlo, f.tup)
    for m in (1, 8, 64):
        b = torch.from_numpy(rhs(n, m, m)).to(card)
        got = banded.banded_solve_inverted(*args, b, n=n, bw=bw)
        assert torch.equal(got, banded._solve_inverted(*args, b, n=n, bw=bw, tiles=True))
        close(got, banded_inverted_solve(*args, b, n=n, bw=bw), 1e-4)


# past 512 RHS columns a scan block takes 2, 4 and then 8 columns
@pytest.mark.parametrize("m", [513, 1025, 2049])
@pytest.mark.parametrize("bw", [5, 16])
def test_inverted_band_solve_scan_takes_more_columns_a_block(bw, m, card):
    n = B8_BANDS[bw][2]
    lu = banded.banded_lu_tiled(torch.from_numpy(band_dd(n, bw, bw + m)).to(card), bw=bw)
    f = factorize_banded(lu, bw=bw)
    args = (f.linv, f.uinv, f.tlo, f.tup)
    b = torch.from_numpy(rhs(n, m, m)).to(card)
    got = banded.banded_solve_inverted(*args, b, n=n, bw=bw)
    assert torch.equal(got, banded._solve_inverted(*args, b, n=n, bw=bw, tiles=True))
    close(got, banded_inverted_solve(*args, b, n=n, bw=bw), 1e-4)


@pytest.mark.parametrize("bw", [5, 16, 64])
def test_inverted_band_solve_on_non_finite_values_gives_the_plain_pattern(bw, card):
    n = B8_BANDS[bw][2] // 4
    lu = banded.banded_lu_tiled(torch.from_numpy(band_dd(n, bw, 11)).to(card), bw=bw)
    f = factorize_banded(lu, bw=bw)
    s = f.linv.shape[0]
    b = torch.from_numpy(rhs(n, 3, 12)).to(card)
    tlo = f.tlo.clone()
    tlo[s // 2, -1, 0] = float("inf")  # a transfer block's tail row
    args = (f.linv, f.uinv, tlo, f.tup)
    assert_same_positions(banded.banded_solve_inverted(*args, b, n=n, bw=bw),
                          banded_inverted_solve(*args, b, n=n, bw=bw))
    b[n // 3, 1] = float("nan")
    args = (f.linv, f.uinv, f.tlo, f.tup)
    assert_same_positions(banded.banded_solve_inverted(*args, b, n=n, bw=bw),
                          banded_inverted_solve(*args, b, n=n, bw=bw))


# ---------------------------------------------------------------------------
# the training step (llama3_8b.reduced(), fp32): the card against the CPU
# ---------------------------------------------------------------------------
def train_steps(dev, name, microbatches, steps=3):
    """``steps`` train steps from the same seeded model and numpy batches on
    ``dev`` at the trainer's default learning rate: (the first batch's
    gradients, the trainer's leaves, the losses), all on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import loop

    cfg = get_config("llama3_8b").reduced()
    params = {k: torch.nn.Parameter(v.detach().to(dev))
              for k, v in lm.train_params(lm.init_params(0, cfg, device="cpu")).items()}
    opt = train.get_optimizer(name, list(params.values()),
                              train.warmup_cosine(loop.TrainConfig().learning_rate, 2, 10))
    step = loop.make_train_step(cfg, opt, microbatches=microbatches)
    rng = np.random.default_rng(7)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, 256, (4, 32)).astype(np.int32)).to(dev)}
               for _ in range(steps)]
    loss, _ = lm.train_loss(params, batches[0], cfg)
    grads = [g.cpu() for g in torch.autograd.grad(loss, list(params.values()))]
    losses = [float(step(params, b)["loss"]) for b in batches]
    return grads, {k: p.detach().cpu() for k, p in params.items()}, losses


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_train_steps_on_the_card_match_the_cpu(name, microbatches, card):
    # the first batch's gradients and each leaf after three steps normwise
    # 1e-4, the losses 1e-5: the card's products and the embedding's
    # backward sum in other orders than the CPU's (gradients measured
    # <= 1.5e-6).  Adam moves an entry by about lr * sign(g) however small
    # g is, so entries whose gradient is round-off-sized move apart by up
    # to 2 lr; at lr 1e-2 the leaves parted by up to 2.9e-3 after three
    # steps, at the trainer's default 3e-4 by up to 1.3e-5 on an H100
    # (chip_smoke.py phase 4j prints both)
    got_grads, got, got_losses = train_steps(card, name, microbatches)
    want_grads, want, want_losses = train_steps(torch.device("cpu"), name, microbatches)
    for g, w in zip(got_grads, want_grads):
        close(g, w, 1e-4)
    for k in want:
        close(got[k], want[k], 1e-4)
    close(torch.tensor(got_losses), torch.tensor(want_losses), 1e-5)


def test_the_ebv_train_step_runs_b9_and_b10_once_per_order_group(card):
    # order 2 (the two stacked norm scales, L = 2) and order 64 (embed and
    # unembed): two groups a step; B9 adds its non-finite pass from n = 3
    wrappers = (batched_lu.batched_lu_vmem, batched_lu.batched_lu_solve_vmem)
    before = [w.launches for w in wrappers]
    with solvers.record_dispatches() as log:
        train_steps(card, "ebv", 1, steps=2)
    assert [(p.op, p.n, p.batch, name) for p, name in log] == [
        ("factor", 2, 2, "cuda_vmem"), ("solve", 2, 2, "cuda_vmem"),
        ("factor", 64, 2, "cuda_vmem"), ("solve", 64, 2, "cuda_vmem")] * 2
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2 * (1 + 2), 2 * 2]


def test_the_bf16_logits_product_and_its_backward_match_the_upcast_products(card):
    # fp32 out of bf16 operands (torch.mm's out_dtype): the forward within
    # 1e-5 of the upcast product; the backward rounds the fp32 cotangent to
    # bf16 once, so its gradients are held to 2e-2 (a few bf16 units)
    from repro_torch.models import common

    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 40, 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(64, 300, generator=g) * 0.1).to(torch.bfloat16)
    ct = torch.randn(3, 40, 300, generator=g)
    out = {}
    for dev in ("cpu", card):
        xs, ws = x.to(dev, copy=True).requires_grad_(), w.to(dev, copy=True).requires_grad_()
        y = common.matmul_f32(xs, ws)
        assert y.dtype == torch.float32
        y.backward(ct.to(dev))
        assert xs.grad.dtype == ws.grad.dtype == torch.bfloat16
        out[str(dev)] = (y.detach(), xs.grad, ws.grad)
    close(out["cuda"][0], out["cpu"][0], 1e-5)
    close(out["cuda"][1], out["cpu"][1], 2e-2)
    close(out["cuda"][2], out["cpu"][2], 2e-2)
