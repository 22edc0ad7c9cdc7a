"""The port's core (``repro_torch.core``) against the JAX package's core.

Inputs are drawn once with numpy and fed to both packages.  Schedule lists
are compared exactly.  Numeric results are compared normwise:
``max|port - ref| <= TOL * max|ref|`` with ``TOL = 1e-5``.  Reason: both
sides compute in fp32, but XLA and torch order their sums and products
differently, so nothing is bitwise; the round-off of an O(n)-step
elimination at these sizes measures ~1e-6 of the largest entry, and the
float64 oracle of ``repro_torch.kernels.ref`` anchors both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro.core import ebv as jebv
from repro.core import factorization as jfz
from repro.core import health as jhealth
from repro.core import pivoted as jpivoted
from repro.core import solve as jsolve
from repro_torch.core import blocked, ebv, factorization, health, pivoted, solve
from repro_torch.kernels import ref

TOL = 1e-5


def dd(n, seed=0):
    """Diagonally dominant fp32 matrix by the reference's rule
    (``core/ebv.py:make_diagonally_dominant``), drawn with numpy."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def rhs(n, m=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / np.abs(want).max()
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def close_lu(port, want, tol=TOL):
    """A packed factor as its L (strictly lower) and U (upper) apart, each
    against its own largest entry: U's diagonal is ~n/2 and L's entries
    ~1/n, so one norm over both would not see L."""
    port, want = np.asarray(port), np.asarray(want)
    close(np.tril(port, -1), np.tril(want, -1), tol)
    close(np.triu(port), np.triu(want), tol)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 33, 64, 257])
def test_pairing_schedules_equal_reference(n):
    assert ebv.equalized_pairing(n) == jebv.equalized_pairing(n)
    assert ebv.pair_lengths(n) == jebv.pair_lengths(n)
    assert ebv.equalized_tile_schedule(n) == jebv.equalized_tile_schedule(n)
    assert ebv.tile_schedule_work(n) == jebv.tile_schedule_work(n)


@pytest.mark.parametrize("count", [1, 2, 5, 8, 63])
def test_fold_index_equals_reference_on_ints_and_tensors(count):
    got = [ebv.fold_index(i, count) for i in range(count)]
    assert got == [jebv.fold_index(i, count) for i in range(count)]
    assert ebv.fold_index(torch.arange(count), count).tolist() == np.asarray(
        jebv.fold_index(jnp.arange(count), count)).tolist()


@pytest.mark.parametrize("blocks,executors", [(8, 4), (9, 3), (16, 8), (5, 2)])
def test_owner_schedules_equal_reference(blocks, executors):
    assert blocked.cyclic_owners(blocks, executors) == jblocked.cyclic_owners(blocks, executors)
    assert blocked.ebv_folded_owners(blocks, executors) == jblocked.ebv_folded_owners(blocks, executors)


@pytest.mark.parametrize("block", [8, 16, 24, 32, 40, 64, 96, 128, 256])
def test_sub_block_width_equals_reference(block):
    assert blocked.sub_block_width(block) == jblocked.sub_block_width(block)


@pytest.mark.parametrize("n,block", [(40, 256), (257, 256), (600, 256), (97, 32), (131, 64)])
def test_fused_block_size_keeps_the_padding_rule(n, block):
    # where neither budget binds, the port picks the reference's B exactly
    assert blocked.fused_block_size(n, block) == jblocked.fused_block_size(n, block)


@pytest.mark.parametrize("n", [256, 500, 2000, 8000])
def test_fused_block_size_fits_one_block_of_shared_memory(n):
    B = blocked.fused_block_size(n, 256)
    assert B * (B + 1) * 4 <= blocked.FACTOR_SMEM_BYTES
    assert B == 128  # 256 halves once: the (B, B+1) tile must fit 227 KB


def test_pad_identity_tail_matches_reference():
    a = dd(5, 3)
    close(blocked.pad_identity_tail(t(a), 8), jblocked.pad_identity_tail(jnp.asarray(a), 8), tol=0)


def test_ebv_step_and_lu_match_reference_and_oracle():
    a = dd(48, 4)
    close(ebv.ebv_step(t(a), 3), jebv.ebv_step(jnp.asarray(a), 3))
    lu = ebv.ebv_lu(t(a))
    close_lu(lu, jebv.ebv_lu(jnp.asarray(a)))
    close_lu(lu, ref.lu_ref(a))


def test_unpack_and_reconstruct_match_reference():
    a = dd(40, 5)
    lu = ref.lu_ref(a).astype(np.float32)
    l, u = ebv.unpack_lu(t(lu))
    jl, ju = jebv.unpack_lu(jnp.asarray(lu))
    close(l, jl, tol=0)
    close(u, ju, tol=0)
    close(ebv.reconstruct(t(lu)), jebv.reconstruct(jnp.asarray(lu)))
    close(ebv.reconstruct(t(lu)), a)


@pytest.mark.parametrize("n,block", [(96, 32)])
def test_blocked_lu_matches_reference(n, block):
    a = dd(n, n)
    close_lu(blocked.blocked_lu(t(a), block=block), jblocked.blocked_lu(jnp.asarray(a), block=block))


@pytest.mark.parametrize("n,block", [(64, 32), (40, 256)])
def test_fused_blocked_lu_matches_reference(n, block):
    a = dd(n, n + 1)
    port = blocked.fused_blocked_lu(t(a), block=block)
    close_lu(port, jblocked.fused_blocked_lu(jnp.asarray(a), block=block))
    close_lu(port, ref.lu_ref(a))


def test_fused_blocked_lu_leaves_its_input_alone():
    a = t(dd(64, 9))
    before = a.clone()
    blocked.fused_blocked_lu(a, block=64)
    assert torch.equal(a, before)


def test_strip_helpers_match_reference():
    rng = np.random.default_rng(11)
    d = dd(32, 12)
    lu = ref.lu_ref(d).astype(np.float32)
    strip = rng.standard_normal((32, 7)).astype(np.float32)
    close(blocked.strip_trsm(t(lu), t(strip)), jblocked.strip_trsm(jnp.asarray(lu), jnp.asarray(strip)))
    close(blocked.strip_utrsm(t(lu), t(strip)), jblocked.strip_utrsm(jnp.asarray(lu), jnp.asarray(strip)))
    panel = dd(64, 13)[:, :16]
    close(blocked.factor_diag_strip(t(panel), 8), jblocked.factor_diag_strip(jnp.asarray(panel), 8))
    below = rng.standard_normal((24, 16)).astype(np.float32)
    close(blocked.solve_below_strip(t(panel), t(below), 8),
          jblocked.solve_below_strip(jnp.asarray(panel), jnp.asarray(below), 8))
    close(blocked.panel_factor(t(panel)), jblocked.panel_factor(jnp.asarray(panel)))


@pytest.mark.parametrize("m", [None, 4])
def test_substitutions_match_reference(m):
    a = dd(50, 14)
    lu = ref.lu_ref(a).astype(np.float32)
    b = rhs(50, m)
    close(solve.forward_substitution(t(lu), t(b)), jsolve.forward_substitution(jnp.asarray(lu), jnp.asarray(b)))
    close(solve.backward_substitution(t(lu), t(b)), jsolve.backward_substitution(jnp.asarray(lu), jnp.asarray(b)))
    x = solve.lu_solve(t(lu), t(b))
    close(x, jsolve.lu_solve(jnp.asarray(lu), jnp.asarray(b)))
    close(x, ref.solve_ref(lu, b))


@pytest.mark.parametrize("method,jmethod", [("ebv", "ebv"), ("ebv_blocked", "ebv_blocked"), ("torch", "jnp")])
def test_linear_solve_methods_match_reference(method, jmethod):
    a, b = dd(72, 15), rhs(72, 2)
    got = solve.linear_solve(t(a), t(b), method=method, block=32)
    close(got, jsolve.linear_solve(jnp.asarray(a), jnp.asarray(b), method=jmethod, block=32))


def test_stacked_rhs_roundtrip_and_linear_solve_many():
    a = dd(40, 16)
    bs = [rhs(40, None, 1), rhs(40, 3, 2), rhs(40, 1, 3)]
    stacked, widths, squeezes = solve.stack_rhs([t(b) for b in bs])
    assert stacked.shape == (40, 5) and widths == [1, 3, 1] and squeezes == [True, False, False]
    back = solve.split_rhs(stacked, widths, squeezes)
    assert all(torch.equal(x, t(b)) for x, b in zip(back, bs))
    many = solve.linear_solve_many(t(a), [t(b) for b in bs], method="ebv")
    want = jsolve.linear_solve_many(jnp.asarray(a), [jnp.asarray(b) for b in bs], method="ebv")
    for got, w in zip(many, want):
        close(got, w)


def test_make_diagonally_dominant_follows_reference_rule():
    a = ebv.make_diagonally_dominant(7, 33, device="cpu")
    assert a.dtype == torch.float32 and a.shape == (33, 33)
    # diagonal = sum of the drawn |row| (off-diagonal plus the drawn
    # diagonal, itself in [0, 1]) + 1
    off = a.abs().sum(dim=1) - a.diagonal().abs()
    assert bool((a.diagonal() >= off + 1.0 - 1e-4).all())
    assert bool((a.diagonal() <= off + 2.0 + 1e-4).all())
    assert float((a - torch.diag(a.diagonal())).abs().max()) <= 1.0
    band = ebv.make_diagonally_dominant(torch.Generator().manual_seed(3), 20, sparse_band=2, device="cpu")
    i = torch.arange(20)
    assert bool((band[(i[:, None] - i[None, :]).abs() > 2] == 0).all())
    again = ebv.make_diagonally_dominant(7, 33, device="cpu")
    assert torch.equal(a, again)  # the seed fixes the draw


@pytest.mark.parametrize("kind", ["healthy", "singular"])
def test_factor_health_matches_reference(kind):
    a = dd(32, 17)
    if kind == "singular":
        a[0, 0] = 0.0
    lu = np.asarray(jblocked.fused_blocked_lu(jnp.asarray(a), block=32))
    rec = health.factor_health(t(lu), ref_max=float(np.abs(a).max()))
    jrec = jhealth.factor_health(jnp.asarray(lu), ref_max=float(np.abs(a).max()))
    assert rec.verdict() == jrec.verdict() == (kind == "healthy")
    assert bool(rec.finite) == bool(jrec.finite)
    if kind == "healthy":
        close(float(rec.min_pivot), float(jrec.min_pivot))
        close(float(rec.growth), float(jrec.growth))
    assert rec.report().startswith("healthy") == (kind == "healthy")


def test_relative_residual_matches_reference():
    a, b = dd(30, 18), rhs(30, 2)
    x = np.linalg.solve(a.astype(np.float64), b.astype(np.float64)).astype(np.float32) * 1.1
    got = float(health.relative_residual(t(a), t(b), t(x)))
    close(got, float(jhealth.relative_residual(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x))))


def test_pivoted_lu_matches_reference():
    a = dd(24, 19)
    a[0, 0] = 0.0  # no-pivot elimination breaks here; pivoting does not
    b = rhs(24)
    f = pivoted.pivoted_lu(t(a))
    jf = jpivoted.pivoted_lu(jnp.asarray(a))
    assert f.perm.tolist() == np.asarray(jf.perm).tolist()
    close_lu(f.lu, jf.lu)
    close(pivoted.pivoted_solve(f, t(b)), np.linalg.solve(a.astype(np.float64), b))


@pytest.mark.parametrize("n,block", [(64, 32), (100, 48)])
def test_block_inverses_and_inverted_solve_match_reference(n, block):
    a = dd(n, 20)
    lu = ref.lu_ref(a).astype(np.float32)
    linv, uinv = factorization.dense_block_inverses(t(lu), block=block)
    jlinv, juinv = jfz.dense_block_inverses(jnp.asarray(lu), block=block)
    close(linv, jlinv)
    close(uinv, juinv)
    b = rhs(n, 5)
    x = factorization.dense_inverted_solve(t(lu), linv, uinv, t(b))
    close(x, jfz.dense_inverted_solve(jnp.asarray(lu), jlinv, juinv, jnp.asarray(b), block=min(block, n)))
    close(x, ref.solve_ref(lu, b))


@pytest.mark.parametrize("m,tile", [(1, 512), (3, 512), (64, 512), (513, 512), (300, 256), (1000, 256)])
def test_equalized_rhs_tile_equals_reference(m, tile):
    assert factorization.equalized_rhs_tile(m, tile) == jfz.equalized_rhs_tile(m, tile)


def test_factorize_dense_artifact_fields():
    lu = t(ref.lu_ref(dd(70, 21)).astype(np.float32))
    art = factorization.factorize_dense(lu, block=32)
    assert art.enriched and art.block == 32 and art.linv.shape == (3, 32, 32)
    assert art.shape == (70, 70) and art.n == 70 and art.ndim == 2
    assert factorization.packed_of(art) is lu and factorization.packed_of(lu) is lu
    raw = factorization.factorize_dense(lu, enrich=False)
    assert not raw.enriched and factorization.dense_artifact(raw).enriched
    assert factorization.factorize_dense(art) is art
