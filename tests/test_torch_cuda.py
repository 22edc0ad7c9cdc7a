"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips where ``torch.cuda.is_available()`` is false.

The module imports neither JAX nor the JAX package, so it also runs on a
host with a card and no JAX (add ``--noconftest`` there, since
``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: normwise ``max|kernel - plain| <= 1e-4 * max|plain|`` — both
fp32, but the kernels fuse multiply-adds and block the sweeps differently
from the plain versions; measured <= 3e-6 at n = 2000 on an H100.  A
packed factor is compared as its L (strictly lower) and its U (upper)
apart, each against its own largest entry: U's diagonal is ~n/2 and L's
entries ~1/n, so one norm over both would not see L.
"""
import numpy as np
import pytest
import torch

from repro_torch import solvers
from repro_torch.core.factorization import (
    banded_inverted_solve,
    dense_block_inverses,
    dense_inverted_solve,
    factorize_banded,
)
from repro_torch.core.banded import banded_solve_blocked
from repro_torch.core.health import relative_residual
from repro_torch.kernels import _build, banded, ebv_lu, ops, ref, trsm

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
    err = float((got - want).abs().max() / want.abs().max())
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


@pytest.mark.parametrize("n", [40, 257, 600, 1000])
def test_lu_fused_kernel_matches_plain(n, card):
    a = torch.from_numpy(dd(n, n)).to(card)
    before = ebv_lu.lu_fused.launches
    got = ebv_lu.lu_fused(a)
    assert ebv_lu.lu_fused.launches == before + ebv_lu.fused_launches(n)  # as the C driver counted
    close_lu(got, ebv_lu.lu_fused_plain(a))
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
    assert [y - x for x, y in zip(counts, after)] == [1, 1, 1]


def test_main_path_dispatches_the_kernels(card):
    a = torch.from_numpy(dd(300, 5)).to(card)
    b = torch.from_numpy(rhs(300, 2)).to(card)
    before = (ebv_lu.lu_fused.launches, trsm.solve_vmem.launches)
    x = ops.linear_solve(a, b)
    assert (ebv_lu.lu_fused.launches - before[0], trsm.solve_vmem.launches - before[1]) == (
        ebv_lu.fused_launches(300), 1)
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


def test_band_factors_leave_their_input_alone(card):
    a = torch.from_numpy(band_dd(300, 16, 3)).to(card)
    before = a.clone()
    banded.banded_lu_blocked(a, bw=16)
    banded.banded_lu_tiled(a, bw=16)
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
    assert banded.banded_solve_kernelized.launches - counts[0] == 1
    assert banded.banded_solve_inverted.launches - counts[1] == (2 if f.linv.shape[0] == 1 else 6)


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
            banded.banded_solve_kernelized.launches - before[1]) == (per_call, 1)
    assert float(relative_residual(a, b, x, bw=bw)) < 1e-5


def test_a_band_kernel_that_fails_raises_instead_of_escalating(card, monkeypatch):
    def broken():
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(_build, "library", broken)
    a = torch.from_numpy(band_dd(64, 3, 7)).to(card)
    with solvers.record_escalations() as esc, pytest.raises(RuntimeError, match="failed to load") as ei:
        ops.banded_lu(a, bw=3, health=True)
    assert not isinstance(ei.value, solvers.SolveFailure) and esc == []
