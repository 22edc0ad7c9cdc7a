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
from repro_torch.core.factorization import dense_block_inverses, dense_inverted_solve
from repro_torch.kernels import _build, ebv_lu, ops, ref, trsm

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
