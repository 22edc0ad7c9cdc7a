"""The banded slice of the port against the JAX package, on the CPU.

The same numpy bands go through ``repro`` and ``repro_torch``.  The JAX
side runs its Pallas kernels in interpret mode (as
``tests/test_banded_blocked.py`` does) and its pure-jnp paths as they are;
the port's kernel wrappers, given CPU tensors, run their plain versions.

Tolerances: layout moves (skew, to/from band) are exact.  Factors are
compared as L (columns 0..bw-1) and U (bw..2bw) apart, each normwise
``max|port - ref| <= 1e-5 * max|ref|``; solutions and enrichments the
same.  Both sides are fp32, but XLA's CPU code fuses ``a - l*u`` into one
rounding where PyTorch rounds twice, and the two affine scans associate
differently, so they agree to ~1e-6, never bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.core import banded as jband
from repro.core import factorization as jfz
from repro.core import health as jhealth
from repro.kernels import banded as jkband
from repro.kernels import ops as jops
from repro_torch import convert, solvers
from repro_torch.core import banded as band
from repro_torch.core import factorization as fz
from repro_torch.core import health
from repro_torch.kernels import banded as kband
from repro_torch.kernels import ops, ref
from repro_torch.solvers import backends

TOL = 1e-5

# test_banded_blocked.py's sweep plus n = 600, bw = 16
SWEEP = [
    (64, 4, None),   # divisible, auto block
    (97, 3, 32),     # n not a multiple of the block
    (33, 1, 16),     # tridiagonal
    (16, 20, None),  # bw >= n
    (200, 8, 64),
    (128, 16, None),
    (60, 7, 13),     # odd block
    (600, 16, None),
]
SOLVE_SWEEP = [(97, 3, 32), (16, 20, None), (60, 7, 13), (600, 16, None)]


def band_dd(n, bw, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, 2 * bw + 1)).astype(np.float32)
    j = np.arange(n)[:, None] - bw + np.arange(2 * bw + 1)[None, :]
    a = np.where((j >= 0) & (j < n), a, 0.0).astype(np.float32)
    a[:, bw] = np.abs(a).sum(axis=1) - np.abs(a[:, bw]) + 1.0
    return a


def rhs(n, m=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)


def close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def close_lu(port, want, bw, tol=TOL):
    port, want = np.asarray(port), np.asarray(want)
    close(port[:, :bw], want[:, :bw], tol)
    close(port[:, bw:], want[:, bw:], tol)


def cpu(x):
    return convert.tensor_from_numpy(x, device="cpu")


def counterpart(name: str) -> str:
    if name.startswith("pallas"):
        return "cuda" + name.removeprefix("pallas")
    if name.startswith("xla"):
        return "torch" + name.removeprefix("xla")
    return name


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()
    yield
    solvers.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c,bw,blocks", [(8, 2, 3), (16, 5, 2), (4, 6, 5), (32, 1, 2)])
def test_skew_layout_round_trip_is_exact(c, bw, blocks):
    ap = np.random.default_rng(c + bw).normal(size=(c * blocks, 2 * bw + 1)).astype(np.float32)
    g = band.band_to_skewed(cpu(ap), bw, c)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jband.band_to_skewed(jnp.asarray(ap), bw, c)))
    np.testing.assert_array_equal(band.skewed_to_band(g, bw, c).numpy(), ap)


@pytest.mark.parametrize("n,bw", [(12, 2), (9, 4), (5, 7)])
def test_to_and_from_band_are_exact(n, bw):
    dense = np.random.default_rng(n).normal(size=(n, n)).astype(np.float32)
    got = band.to_banded(cpu(dense), bw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jband.to_banded(jnp.asarray(dense), bw)))
    np.testing.assert_array_equal(band.from_banded(got).numpy(),
                                  np.asarray(jband.from_banded(jnp.asarray(got.numpy()))))


def test_block_size_and_skew_rows_are_the_reference_integers():
    shapes = [(n, bw, block) for n, bw, block in SWEEP] + [
        (500, 5, None), (4000, 5, None), (16000, 5, None), (16384, 16, None),
        (65536, 256, None), (3, 9, None), (40, 39, 8)]
    for n, bw, block in shapes:
        c = band.band_block_size(n, bw, block)
        assert c == jband.band_block_size(n, bw, block)
        assert band.skew_rows(n, bw, c) == jband.skew_rows(n, bw, c)
        if c < bw:  # the C < bw branches are reached only when n < bw
            assert n < bw


def test_skew_pad_and_window_steps_match_the_reference_exactly():
    n, bw, c = 40, 6, 16
    a = band_dd(n, bw, 3)
    g, s = band.skew_pad(cpu(a), bw, c)
    jg, js = jband.skew_pad(jnp.asarray(a), bw, c)
    assert s == js
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    own, carry = band.band_step_slabs(g, c, block=c, bw=bw)
    jown, jcarry = jband.band_step_slabs(jg, c, block=c, bw=bw)
    np.testing.assert_array_equal(own.numpy(), np.asarray(jown))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
    window = band.band_window_from_slabs(own, carry, bw)
    np.testing.assert_array_equal(window.numpy(),
                                  np.asarray(jband.band_window_from_slabs(jown, jcarry, bw)))
    close(band.factor_band_window(window, c, bw),
          jband.factor_band_window(jnp.asarray(window.numpy()), c, bw))


# ---------------------------------------------------------------------------
# band LU: kernels B5 / B6 (plain on the CPU), the mirror and the scalar path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,bw,block", SWEEP)
def test_band_lu_matches_the_reference_kernels(n, bw, block):
    a = band_dd(n, bw, n + bw)
    ja = jnp.asarray(a)
    want = np.asarray(jkband.banded_lu_blocked(ja, bw=bw, block=block, interpret=True))
    close_lu(np.asarray(jkband.banded_lu_tiled(ja, bw=bw, block=block, interpret=True)), want, bw)
    close_lu(np.asarray(jband.banded_lu(ja, bw=bw)), want, bw)
    port = {
        "cuda_blocked": kband.banded_lu_blocked(cpu(a), bw=bw, block=block),
        "cuda_tiled": kband.banded_lu_tiled(cpu(a), bw=bw, block=block),
        "mirror": band.banded_lu_blocked(cpu(a), bw=bw, block=block),
        "scalar": band.banded_lu(cpu(a), bw=bw),
    }
    for got in port.values():
        close_lu(got, want, bw)
    # the port's factor does not depend on the block size or the path
    assert all(torch.equal(got, port["mirror"]) for got in port.values())
    close_lu(port["mirror"], ref.banded_lu_ref(a, bw), bw, tol=1e-4)


def test_band_lu_never_writes_the_callers_band():
    a = cpu(band_dd(50, 3, 1))
    before = a.clone()
    kband.banded_lu_blocked(a, bw=3)
    kband.banded_lu_tiled(a, bw=3)
    assert torch.equal(a, before)


def test_make_banded_dd_is_diagonally_dominant_band_form():
    a = band.make_banded_dd(7, 40, 3, device="cpu")
    assert a.shape == (40, 7) and a.device.type == "cpu"
    j = torch.arange(40)[:, None] - 3 + torch.arange(7)[None, :]
    assert bool((a[(j < 0) | (j >= 40)] == 0).all())
    off = a.abs().sum(1) - a[:, 3].abs()
    assert bool((a[:, 3] > off).all())


# ---------------------------------------------------------------------------
# band solve: kernel B7 (plain on the CPU), the mirror and the scalar path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [None, 5])
@pytest.mark.parametrize("n,bw,block", SOLVE_SWEEP)
def test_band_solve_matches_the_reference_kernel(n, bw, block, m):
    lu = np.asarray(jband.banded_lu_blocked(jnp.asarray(band_dd(n, bw, n)), bw=bw, block=block))
    b = rhs(n, m, seed=n + bw)
    want = np.asarray(jkband.banded_solve_kernelized(jnp.asarray(lu), jnp.asarray(b), bw=bw,
                                                     block=block, interpret=True))
    close(kband.banded_solve_kernelized(cpu(lu), cpu(b), bw=bw, block=block), want)
    close(kband.banded_solve_kernelized(cpu(lu), cpu(b), bw=bw, block=block, rhs_tile=2), want)
    close(band.banded_solve_blocked(cpu(lu), cpu(b), bw=bw, block=block), want)
    if m is None:
        close(band.banded_solve(cpu(lu), cpu(b), bw=bw), want)
    close(want, ref.banded_solve_ref(lu, b, bw), tol=1e-4)


def test_rhs_tile_split_of_the_reference_kernel_matches_the_port():
    n, bw = 120, 4
    lu = np.asarray(jband.banded_lu_blocked(jnp.asarray(band_dd(n, bw, 2)), bw=bw))
    b = rhs(n, 12, seed=4)
    want = np.asarray(jkband.banded_solve_kernelized(jnp.asarray(lu), jnp.asarray(b), bw=bw,
                                                     rhs_tile=4, interpret=True))
    close(kband.banded_solve_kernelized(cpu(lu), cpu(b), bw=bw, rhs_tile=4), want)


# ---------------------------------------------------------------------------
# enrichment and kernel B8
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,bw,block", [(97, 3, 32), (600, 16, None), (60, 7, 13)])
def test_enrichment_and_inverted_solve_match_the_reference(n, bw, block):
    lu = np.asarray(jband.banded_lu_blocked(jnp.asarray(band_dd(n, bw, n + 1)), bw=bw, block=block))
    jf = jfz.factorize_banded(jnp.asarray(lu), bw=bw, block=block)
    f = fz.factorize_banded(cpu(lu), bw=bw, block=block)
    assert (f.block, f.bw, f.structure) == (jf.block, jf.bw, jf.structure)
    g, c, s = fz.banded_skewed_layout(cpu(lu), bw=bw, block=block)
    jg, jc, js = jfz.banded_skewed_layout(jnp.asarray(lu), bw=bw, block=block)
    assert (c, s) == (jc, js)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    for name in ("linv", "uinv", "tlo", "tup"):
        close(getattr(f, name), np.asarray(getattr(jf, name)))
    b = rhs(n, 5, seed=3)
    want = np.asarray(jkband.banded_solve_inverted(jf.linv, jf.uinv, jf.tlo, jf.tup, jnp.asarray(b),
                                                   n=n, bw=bw, interpret=True))
    close(kband.banded_solve_inverted(f.linv, f.uinv, f.tlo, f.tup, cpu(b), n=n, bw=bw), want)
    close(fz.banded_inverted_solve(f.linv, f.uinv, f.tlo, f.tup, cpu(b[:, 0]), n=n, bw=bw), want[:, 0])


def test_inverted_solve_takes_a_band_wider_than_the_matrix():
    # bw >= n leaves one block (C = n < bw) and no coupling; the reference's
    # inverted sweep fails to concatenate its tail states there, so the
    # port is held to the reference's blocked solve
    n, bw = 16, 20
    a, b = band_dd(n, bw, 15), rhs(n, 3, seed=16)
    want = np.asarray(jops.banded_solve(jops.banded_lu(jnp.asarray(a), bw=bw), jnp.asarray(b), bw=bw,
                                        impl="xla"))
    f = ops.banded_lu(cpu(a), bw=bw, enrich=True)
    assert f.linv.shape == (1, n, n) and f.tlo.shape == (1, n, bw)
    close(ops.banded_solve(f, cpu(b), bw=bw, impl="cuda_inverted"), want)


@pytest.mark.parametrize("enriched", [False, True])
def test_reference_banded_artifact_carried_across_solves_to_reference_answer(enriched):
    n, bw = 300, 6
    a, b = band_dd(n, bw, 8), rhs(n, 4, seed=9)
    jf = jops.banded_lu(jnp.asarray(a), bw=bw, enrich=enriched)
    want = np.asarray(jops.banded_solve(jf, jnp.asarray(b), bw=bw))
    conv = (lambda x: None if x is None else np.asarray(x))
    f = convert.factorization_from_numpy(
        np.asarray(jf.packed), conv(jf.linv), conv(jf.uinv), conv(jf.tlo), conv(jf.tup),
        block=jf.block, tier=jf.tier, structure="banded", bw=jf.bw, device="cpu")
    assert f.enriched == enriched and (f.block, f.bw) == (jf.block, jf.bw)
    close(ops.banded_solve(f, cpu(b), bw=bw), want)
    close(ops.banded_solve(f, cpu(b), bw=bw, impl="cuda_inverted"), want)


def test_convert_rejects_inconsistent_banded_artifacts():
    eye = np.eye(4, dtype=np.float32)[None]
    packed = np.ones((4, 3), np.float32)
    with pytest.raises(ValueError):  # half an enrichment
        convert.factorization_from_numpy(packed, eye, eye, eye, None, block=4, structure="banded",
                                         bw=1, device="cpu")
    with pytest.raises(ValueError):  # a band without its bw
        convert.factorization_from_numpy(packed, block=4, structure="banded", device="cpu")


# ---------------------------------------------------------------------------
# health and residual
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("poison", [False, True])
def test_banded_health_and_residual_match_the_reference(poison):
    n, bw = 80, 5
    a = band_dd(n, bw, 11)
    lu = np.array(jband.banded_lu_blocked(jnp.asarray(a), bw=bw))  # a writable copy
    if poison:
        lu[7, bw] = 1e-12
        lu[9, 2] = np.nan
    ref_max = float(np.abs(a).max())
    got = health.factor_health(cpu(lu), ref_max=ref_max, bw=bw)
    want = jhealth.factor_health(jnp.asarray(lu), ref_max=ref_max, bw=bw)
    for field in ("min_pivot", "growth", "ref_max"):
        close(float(getattr(got, field)), float(getattr(want, field)))
    assert bool(got.finite) == bool(want.finite) and got.verdict() == bool(want.verdict())
    b = rhs(n, 3, seed=2)
    x = np.asarray(jband.banded_solve_blocked(jnp.asarray(lu), jnp.asarray(b), bw=bw))
    if not poison:
        close(float(health.relative_residual(cpu(a), cpu(b), cpu(x), bw=bw)),
              float(jhealth.relative_residual(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x), bw=bw)),
              tol=1e-3)
    dense = band.from_banded(cpu(a))
    close(health.banded_matvec(cpu(a), cpu(b), bw=bw), (dense.double() @ cpu(b).double()).numpy())


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------
FACTOR_SHAPES = [(500, 5), (4000, 5), (16000, 5), (16384, 16), (65536, 256), (2000, 64), (64, 3)]


@pytest.mark.parametrize("n,bw", FACTOR_SHAPES)
def test_factor_selection_follows_the_reference_where_the_split_agrees(n, bw):
    want = jsolvers.select(jsolvers.Problem(op="factor", structure="banded", n=n, bw=bw),
                           cache=jsolvers.AutotuneCache()).name
    got = solvers.select(solvers.Problem(op="factor", structure="banded", n=n, bw=bw)).name
    ported_rule = backends.banded_static_impl(bw)
    assert got == ported_rule
    if counterpart(want) == ported_rule:
        assert got == counterpart(want)


def test_the_ported_split_departs_from_the_reference_where_measured():
    # the card's crossover lies between bw = 8 (cuda_blocked faster) and
    # bw = 12 (cuda_tiled faster), whatever n; the reference splits by bytes
    assert jsolvers.backends.banded_static_impl(16000, 5, None, 4) == "pallas_blocked"
    assert jsolvers.backends.banded_static_impl(2000, 16, None, 4) == "pallas_blocked"
    assert backends.banded_static_impl(5) == "cuda_blocked"
    assert backends.banded_static_impl(backends.BANDED_TILED_MIN_BW - 1) == "cuda_blocked"
    assert backends.banded_static_impl(8) == "cuda_blocked"
    assert backends.banded_static_impl(12) == backends.banded_static_impl(16) == "cuda_tiled"
    assert backends.banded_static_impl(256) == "cuda_tiled"
    names = lambda n, bw: [b.name for b in sorted(
        solvers.candidates(solvers.Problem(op="factor", structure="banded", n=n, bw=bw)),
        key=lambda b: -b.priority(solvers.Problem(op="factor", structure="banded", n=n, bw=bw)))]
    assert names(2000, 16)[0] == "cuda_tiled" and names(16000, 5)[0] == "cuda_blocked"


@pytest.mark.parametrize("kw", [dict(rhs=1), dict(rhs=64), dict(rhs=1, enriched=False),
                                dict(rhs=8, dtype="float64")])
def test_solve_selection_is_the_counterpart_of_the_reference_slot(kw):
    want = jsolvers.select(jsolvers.Problem(op="solve", structure="banded", n=4000, bw=5, **kw),
                           cache=jsolvers.AutotuneCache()).name
    got = solvers.select(solvers.Problem(op="solve", structure="banded", n=4000, bw=5, **kw)).name
    if kw.get("dtype") == "float64":  # the cuda_* slots declare fp32 only
        assert got == "torch" and counterpart(want) == "cuda"
    else:
        assert got == counterpart(want) == "cuda"


def test_the_cuda_slots_declare_fp32_only():
    for op, kw in (("factor", {}), ("solve", dict(rhs=1))):
        p = solvers.Problem(op=op, structure="banded", n=100, bw=3, dtype="float64", **kw)
        names = {b.name for b in solvers.candidates(p)}
        assert names and not any(nm.startswith("cuda") for nm in names)
    wide = solvers.Problem(op="solve", structure="banded", n=100, bw=3, rhs=2)
    assert "torch_scalar" not in {b.name for b in solvers.candidates(wide)}


@pytest.mark.parametrize("impl", ["cuda_blocked", "cuda_tiled", "torch", "torch_scalar"])
def test_forced_factor_impls_match_the_reference(impl):
    n, bw = 96, 5
    a = band_dd(n, bw, 4)
    want = np.asarray(jops.banded_lu(jnp.asarray(a), bw=bw, impl=impl.replace("cuda", "pallas")
                                     .replace("torch", "xla")).packed)
    with solvers.record_dispatches() as log:
        f = ops.banded_lu(cpu(a), bw=bw, impl=impl)
    assert [name for _, name in log] == [impl] and f.structure == "banded" and f.bw == bw
    close_lu(f.packed, want, bw)


@pytest.mark.parametrize("impl", ["cuda", "cuda_inverted", "torch_inverted", "torch", "torch_scalar"])
def test_forced_solve_impls_match_the_reference(impl):
    n, bw = 96, 5
    a, b = band_dd(n, bw, 5), rhs(n, 3, seed=6)
    jf = jops.banded_lu(jnp.asarray(a), bw=bw, enrich=True)
    want = np.asarray(jops.banded_solve(jf, jnp.asarray(b), bw=bw, impl="xla"))
    f = ops.banded_lu(cpu(a), bw=bw, enrich=True)
    with solvers.record_dispatches() as log:
        x = ops.banded_solve(f, cpu(b), bw=bw, impl=impl)
    assert [name for _, name in log] == [impl]
    close(x, want)


def test_unported_slots_and_operands_raise_naming_their_slice():
    a = cpu(band_dd(32, 2, 1))
    with pytest.raises(NotImplementedError, match="B18"):
        ops.banded_lu(a, bw=2, impl="cuda_scalar")
    with pytest.raises(NotImplementedError, match="multi-device"):
        ops.banded_lu(a, bw=2, impl="spike")
    with pytest.raises(NotImplementedError, match="multi-device"):
        ops.banded_lu(a, bw=2, mesh=object())
    with pytest.raises(NotImplementedError, match="batched"):
        ops.banded_lu(a[None].expand(2, 32, 5), bw=2)
    with pytest.raises(NotImplementedError, match="batched"):
        solvers.get_backend("solve", "batched_banded", "cuda_vmem")
    with pytest.raises(ValueError, match="unknown impl"):  # the reference's old "pallas" alias
        ops.banded_lu(a, bw=2, impl="pallas")


def test_health_escalation_walks_the_band_backends_like_the_reference():
    a = band_dd(64, 3, 12)
    a[0, 3] = 0.0  # a zero first pivot: outside the no-pivot class
    with jsolvers.record_escalations() as jesc, pytest.raises(jsolvers.SolveFailure):
        jops.banded_lu(jnp.asarray(a), bw=3, health=True)
    with solvers.record_escalations() as esc, pytest.raises(solvers.SolveFailure):
        ops.banded_lu(cpu(a), bw=3, health=True)
    ported = {b.name for b in solvers.backends_for("factor", "banded")}
    assert [e[1] for e in esc] == [counterpart(e[1]) for e in jesc if counterpart(e[1]) in ported]


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,bw", [(500, 5), (600, 16), (16, 20)])
def test_banded_linear_solve_matches_the_reference(n, bw):
    a = band_dd(n, bw, 21)
    for m in (None, 3):
        b = rhs(n, m, seed=22)
        with solvers.record_dispatches() as log:
            x = ops.banded_linear_solve(cpu(a), cpu(b), bw=bw, verify_residual=True)
        assert [name for _, name in log] == [backends.banded_static_impl(bw), "cuda"]
        close(x, jops.banded_linear_solve(jnp.asarray(a), jnp.asarray(b), bw=bw))
        close(x, ref.banded_solve_ref(ref.banded_lu_ref(a, bw), b, bw), tol=1e-4)
    with solvers.record_dispatches() as log:
        ops.banded_linear_solve(cpu(a), cpu(rhs(n)), bw=bw, impl="torch")
    assert [name for _, name in log] == ["torch", "torch"]


def test_verify_residual_raises_on_a_band_outside_the_no_pivot_class():
    a = band_dd(48, 2, 13)
    a[0, 2] = 0.0  # zero first pivot: the factor is not finite
    b = rhs(48, seed=14)
    with pytest.raises(jsolvers.SolveFailure):
        jops.banded_linear_solve(jnp.asarray(a), jnp.asarray(b), bw=2, verify_residual=True)
    with solvers.record_escalations() as esc, pytest.raises(solvers.SolveFailure) as ei:
        ops.banded_linear_solve(cpu(a), cpu(b), bw=2, verify_residual=True)
    assert [c["backend"] for c in ei.value.chain] == ["composed"] and esc[-1][2] is None
