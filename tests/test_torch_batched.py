"""The batched slice of the port against the JAX package, on the CPU.

The same numpy stacks go through ``repro`` and ``repro_torch``.  The JAX
side runs its batched Pallas kernels in interpret mode (as
``tests/test_batched_lu.py`` does) and its vmapped jnp paths as they are;
the port's kernel wrappers, given CPU tensors, run their plain versions.

Tolerance: normwise ``max|port - ref| <= 1e-5 * max|ref|`` (factors as L
and U apart, each against its own largest entry; solutions, enrichments
and health records the same).  Both sides are fp32, but XLA's CPU code
fuses ``a - l*u`` into one rounding where PyTorch rounds twice, so they
agree to ~1e-6, never bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.core import batched as jbatched
from repro.kernels import banded as jkband
from repro.kernels import batched_lu as jkbatched
from repro.kernels import ops as jops
from repro_torch import convert, solvers
from repro_torch.core import batched
from repro_torch.core import health
from repro_torch.kernels import banded as kband
from repro_torch.kernels import batched_lu as kbatched
from repro_torch.kernels import ops, ref
from repro_torch.solvers import cache

TOL = 1e-5


def dd_stack(bsz, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (bsz, n, n)).astype(np.float32)
    idx = np.arange(n)
    a[:, idx, idx] = np.abs(a).sum(axis=2) + 1.0
    return a


def band_stack(bsz, n, bw, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (bsz, n, 2 * bw + 1)).astype(np.float32)
    j = np.arange(n)[:, None] - bw + np.arange(2 * bw + 1)[None, :]
    a = np.where((j >= 0) & (j < n), a, 0.0).astype(np.float32)
    a[..., bw] = np.abs(a).sum(axis=-1) - np.abs(a[..., bw]) + 1.0
    return a


def rhs(bsz, n, m=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((bsz, n) if m is None else (bsz, n, m)).astype(np.float32)


def close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def close_lu(port, want, tol=TOL):
    port, want = np.asarray(port), np.asarray(want)
    close(np.tril(port, -1), np.tril(want, -1), tol)
    close(np.triu(port), np.triu(want), tol)


def close_band_lu(port, want, bw, tol=TOL):
    port, want = np.asarray(port), np.asarray(want)
    close(port[..., :bw], want[..., :bw], tol)
    close(port[..., bw:], want[..., bw:], tol)


def cpu(x):
    return convert.tensor_from_numpy(x, device="cpu")


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    monkeypatch.setenv("REPRO_SOLVERS_CACHE", str(tmp_path / "absent_ref.json"))
    solvers.invalidate()
    jsolvers.invalidate()
    yield
    solvers.invalidate()
    jsolvers.invalidate()


# ---------------------------------------------------------------------------
# B9 / B10 against the reference's batched grid kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 64, 128])
@pytest.mark.parametrize("bsz", [1, 5])
def test_batched_factor_matches_reference_kernel(bsz, n):
    a = dd_stack(bsz, n, n + bsz)
    got = kbatched.batched_lu_vmem(cpu(a))
    close_lu(got, jkbatched.batched_lu_vmem(jnp.asarray(a)))
    close_lu(got, ref.batched_lu_ref(a))
    # the plain version is the unbatched EbV factor, system by system, bit for bit
    from repro_torch.core.ebv import ebv_lu
    assert torch.equal(got[-1], ebv_lu(cpu(a[-1])))


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [8, 64, 128])
@pytest.mark.parametrize("bsz", [1, 5])
def test_batched_solve_matches_reference_kernel(bsz, n, m):
    lu = ref.batched_lu_ref(dd_stack(bsz, n, n)).astype(np.float32)
    b = rhs(bsz, n, m, n + m)
    got = kbatched.batched_lu_solve_vmem(cpu(lu), cpu(b))
    close(got, jkbatched.batched_lu_solve_vmem(jnp.asarray(lu), jnp.asarray(b)))
    close(got, ref.batched_solve_ref(lu, b))
    if m == 1:  # a vector per system: (B, n)
        close(kbatched.batched_lu_solve_vmem(cpu(lu), cpu(b[..., 0])), got[..., 0])


# ---------------------------------------------------------------------------
# B11 / B12 against the reference's batched band kernels
# ---------------------------------------------------------------------------
BAND_SWEEP = [(3, 64, 4, None), (2, 97, 3, 32), (1, 16, 20, None), (4, 200, 8, 64)]


@pytest.mark.parametrize("bsz,n,bw,block", BAND_SWEEP)
def test_batched_band_factor_matches_reference_kernel(bsz, n, bw, block):
    a = band_stack(bsz, n, bw, n + bw)
    got = kband.batched_banded_lu_vmem(cpu(a), bw=bw, block=block)
    close_band_lu(got, jkband.batched_banded_lu_vmem(jnp.asarray(a), bw=bw, block=block), bw)
    close_band_lu(got, ref.batched_banded_lu_ref(a, bw), bw)
    # the stacked plain factor is the unbatched one, system by system, bit for bit
    assert torch.equal(got[0], kband.banded_lu_plain(cpu(a[0]), bw=bw, block=block))


@pytest.mark.parametrize("m", [None, 3])
@pytest.mark.parametrize("bsz,n,bw,block", BAND_SWEEP)
def test_batched_band_solve_matches_reference_kernel(bsz, n, bw, block, m):
    lu = ref.batched_banded_lu_ref(band_stack(bsz, n, bw, n), bw).astype(np.float32)
    b = rhs(bsz, n, m, n + bw)
    got = kband.batched_banded_solve_vmem(cpu(lu), cpu(b), bw=bw, block=block)
    close(got, jkband.batched_banded_solve_vmem(jnp.asarray(lu), jnp.asarray(b), bw=bw,
                                                block=block))
    close(got, ref.batched_banded_solve_ref(lu, b, bw))


# ---------------------------------------------------------------------------
# core/batched against repro.core.batched
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["ebv", "ebv_blocked", "torch", "auto"])
def test_core_batched_linear_solve_matches_reference(method):
    a, b = dd_stack(4, 48, 3), rhs(4, 48, 2, 4)
    jmethod = "jnp" if method == "torch" else method
    want = jbatched.batched_linear_solve(jnp.asarray(a), jnp.asarray(b), method=jmethod, block=16)
    close(batched.batched_linear_solve(cpu(a), cpu(b), method=method, block=16), want)
    # a vector per system (jax 0.9's jnp.linalg.solve refuses (B, n, n) with
    # (B, n), so the reference solves the one-column stack)
    want_v = jbatched.batched_linear_solve(jnp.asarray(a), jnp.asarray(b[..., :1]), method=jmethod,
                                           block=16)[..., 0]
    close(batched.batched_linear_solve(cpu(a), cpu(b[..., 0]), method=method, block=16), want_v)


@pytest.mark.parametrize("method", ["ebv", "auto"])
def test_core_batched_linear_solve_many_matches_reference(method):
    a = dd_stack(3, 40, 5)
    bs = [rhs(3, 40, None, 6), rhs(3, 40, 2, 7), rhs(3, 40, 3, 8)]
    got = batched.batched_linear_solve_many(cpu(a), [cpu(b) for b in bs], method=method)
    want = jbatched.batched_linear_solve_many(jnp.asarray(a), [jnp.asarray(b) for b in bs],
                                              method=method)
    assert [tuple(x.shape) for x in got] == [tuple(w.shape) for w in want]
    for x, w in zip(got, want):
        close(x, w)


def test_core_batched_factor_and_solve_are_the_unbatched_ones_per_system():
    a, b = dd_stack(3, 33, 9), rhs(3, 33, 2, 10)
    from repro_torch.core.ebv import ebv_lu
    from repro_torch.core.solve import lu_solve
    lu = batched.batched_ebv_lu(cpu(a))
    x = batched.batched_lu_solve(lu, cpu(b))
    for i in range(3):
        assert torch.equal(lu[i], ebv_lu(cpu(a[i])))
        assert torch.equal(x[i], lu_solve(lu[i], cpu(b[i])))


def test_unknown_batched_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        batched.batched_linear_solve(cpu(dd_stack(2, 8)), cpu(rhs(2, 8)), method="nope")


# ---------------------------------------------------------------------------
# ops on stacks against repro.kernels.ops
# ---------------------------------------------------------------------------
def test_batched_linear_solve_default_path_matches_reference():
    a, b = dd_stack(5, 64, 11), rhs(5, 64, 3, 12)
    with solvers.record_dispatches() as log:
        x = ops.linear_solve(cpu(a), cpu(b))
        xv = ops.linear_solve(cpu(a), cpu(b[..., 0]))
    assert [(p.structure, p.batch, name) for p, name in log] == [
        ("batched_dense", 5, "cuda_vmem")] * 4
    close(x, jops.linear_solve(jnp.asarray(a), jnp.asarray(b)))
    close(xv, jops.linear_solve(jnp.asarray(a), jnp.asarray(b[..., 0])))
    close(x, np.linalg.solve(a.astype(np.float64), b.astype(np.float64)))


def test_batched_enriched_artifact_and_inverted_solve_match_reference():
    a, b = dd_stack(3, 100, 13), rhs(3, 100, 4, 14)
    f = ops.lu(cpu(a), block=32, enrich=True)
    jf = jops.lu(jnp.asarray(a), block=32, enrich=True)
    assert f.batched and f.enriched and f.block == jf.block == 32
    assert f.linv.shape == jf.linv.shape == (3, 4, 32, 32)
    close_lu(f.packed, jf.packed)
    close(f.linv, np.asarray(jf.linv))
    close(f.uinv, np.asarray(jf.uinv))
    with solvers.record_dispatches() as log:
        x = ops.lu_solve(f, cpu(b))
        xi = ops.lu_solve(f, cpu(b), impl="cuda_inverted")
    assert [name for _, name in log] == ["cuda_vmem", "cuda_inverted"]
    close(x, jops.lu_solve(jf, jnp.asarray(b)))
    close(xi, jops.lu_solve(jf, jnp.asarray(b), impl="pallas_inverted"))


@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"), ("cuda_fused", "pallas_fused")])
def test_forced_impls_map_to_their_batched_counterparts(impl, jimpl):
    a, b = dd_stack(3, 40, 15), rhs(3, 40, 2, 16)
    with solvers.record_dispatches() as log:
        x = ops.linear_solve(cpu(a), cpu(b), impl=impl, block=16)
    want_names = ["torch", "torch"] if impl == "torch" else ["cuda_vmem", "cuda_vmem"]
    assert [name for _, name in log] == want_names
    close(x, jops.linear_solve(jnp.asarray(a), jnp.asarray(b), impl=jimpl, block=16))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.lu(cpu(a), impl="nope")


def test_batched_health_record_is_the_worst_systems_and_matches_reference():
    a = dd_stack(4, 32, 17)
    a[2] *= 1e3  # the stack's max|A| comes from system 2; a weak pivot sits in system 1
    a[1, 5, 5] = 1e-3
    f, rec = ops.lu(cpu(a), health=True)
    jf, jrec = jops.lu(jnp.asarray(a), health=True)
    for field in ("min_pivot", "growth", "ref_max"):
        close(getattr(rec, field), np.asarray(getattr(jrec, field)))
    assert bool(rec.finite) == bool(jrec.finite) and rec.verdict() == jrec.verdict()
    per_system = [ops.lu(cpu(x), health=True)[1] for x in a]
    assert float(rec.min_pivot) == min(float(r.min_pivot) for r in per_system)


def test_batched_unhealthy_stack_escalates_to_the_plain_factor_and_fails():
    a = dd_stack(2, 16, 18)
    a[1, 0, 0] = 0.0  # a zero first pivot: inf/nan factors in every no-pivot backend
    with solvers.record_escalations() as esc, pytest.raises(solvers.SolveFailure):
        ops.lu(cpu(a), health=True)
    assert [(failed, nxt) for _, failed, nxt, _ in esc] == [("cuda_vmem", "torch"),
                                                           ("torch", None)]


def test_deep_batched_stacks_fold_and_stay_raw():
    a, b = dd_stack(6, 24, 19), rhs(6, 24, 2, 20)
    a4, b4 = a.reshape(2, 3, 24, 24), b.reshape(2, 3, 24, 2)
    lu4 = ops.lu(cpu(a4))
    jlu4 = jops.lu(jnp.asarray(a4))
    assert isinstance(lu4, torch.Tensor) and lu4.shape == (2, 3, 24, 24)
    close_lu(lu4, np.asarray(jlu4))
    x4 = ops.lu_solve(lu4, cpu(b4))
    assert x4.shape == (2, 3, 24, 2)
    close(x4, jops.lu_solve(jlu4, jnp.asarray(b4)))
    close(ops.linear_solve(cpu(a4), cpu(b4[..., 0])), np.linalg.solve(a4, b4)[..., 0])
    ab = band_stack(6, 50, 3, 21).reshape(3, 2, 50, 7)
    bb = rhs(6, 50, None, 22).reshape(3, 2, 50)
    xb = ops.banded_linear_solve(cpu(ab), cpu(bb), bw=3)
    assert xb.shape == (3, 2, 50)
    close(xb, jops.banded_linear_solve(jnp.asarray(ab), jnp.asarray(bb), bw=3))


def test_batched_banded_ops_match_reference():
    a, b = band_stack(3, 120, 6, 23), rhs(3, 120, 2, 24)
    with solvers.record_dispatches() as log:
        x = ops.banded_linear_solve(cpu(a), cpu(b), bw=6)
        xv = ops.banded_linear_solve(cpu(a), cpu(b[..., 0]), bw=6)
    assert [(p.structure, name) for p, name in log] == [("batched_banded", "cuda_vmem")] * 4
    close(x, jops.banded_linear_solve(jnp.asarray(a), jnp.asarray(b), bw=6))
    close(xv, jops.banded_linear_solve(jnp.asarray(a), jnp.asarray(b[..., 0]), bw=6))
    f = ops.banded_lu(cpu(a), bw=6, enrich=True)
    jf = jops.banded_lu(jnp.asarray(a), bw=6, enrich=True)
    assert f.batched and f.block == jf.block
    for field in ("linv", "uinv", "tlo", "tup"):
        close(getattr(f, field), np.asarray(getattr(jf, field)))
    with solvers.record_dispatches() as log:
        xi = ops.banded_solve(f, cpu(b), bw=6, impl="cuda_inverted")
        xt = ops.banded_solve(f, cpu(b), bw=6, impl="torch")
    assert [name for _, name in log] == ["cuda_inverted", "torch"]
    close(xi, jops.banded_solve(jf, jnp.asarray(b), bw=6, impl="pallas_inverted"))
    close(xt, x)
    _, rec = ops.banded_lu(cpu(a), bw=6, health=True)
    _, jrec = jops.banded_lu(jnp.asarray(a), bw=6, health=True)
    close(rec.min_pivot, np.asarray(jrec.min_pivot))
    close(rec.growth, np.asarray(jrec.growth))


def test_batched_verify_residual_gate():
    a, b = dd_stack(3, 30, 25), rhs(3, 30, 2, 26)
    x = ops.linear_solve(cpu(a), cpu(b), verify_residual=True)
    close(x, np.linalg.solve(a.astype(np.float64), b.astype(np.float64)))
    bad = a.copy()
    bad[1] = 0.0  # one singular system: NaN factors, so the gate fails the stack
    bad[1, np.arange(30), np.arange(30)] = 0.0
    with pytest.raises(solvers.SolveFailure):
        ops.linear_solve(cpu(bad), cpu(b), verify_residual=True)


def test_relative_residual_of_a_stack_is_its_worst_systems():
    a, b = dd_stack(3, 20, 27), rhs(3, 20, 2, 28)
    x = np.linalg.solve(a.astype(np.float64), b.astype(np.float64)).astype(np.float32)
    x[2] += 1e-3
    per = [float(health.relative_residual(cpu(a[i]), cpu(b[i]), cpu(x[i]))) for i in range(3)]
    assert float(health.relative_residual(cpu(a), cpu(b), cpu(x))) == max(per)
    ab, bb = band_stack(2, 40, 2, 29), rhs(2, 40, None, 30)
    xb = ops.banded_linear_solve(cpu(ab), cpu(bb), bw=2)
    per = [float(health.relative_residual(cpu(ab[i]), cpu(bb[i]), xb[i], bw=2)) for i in range(2)]
    assert float(health.relative_residual(cpu(ab), cpu(bb), xb, bw=2)) == max(per)


def test_reference_batched_factorization_carried_across():
    a, b = dd_stack(2, 70, 31), rhs(2, 70, 3, 32)
    jf = jops.lu(jnp.asarray(a), block=32, enrich=True)
    f = convert.factorization_from_numpy(np.asarray(jf.packed), np.asarray(jf.linv),
                                         np.asarray(jf.uinv), block=jf.block, device="cpu")
    assert f.batched and f.enriched
    want = np.asarray(jops.lu_solve(jf, jnp.asarray(b)))
    close(ops.lu_solve(f, cpu(b)), want)
    close(ops.lu_solve(f, cpu(b), impl="cuda_inverted"), want)
    ab, bb = band_stack(2, 64, 4, 33), rhs(2, 64, None, 34)
    jfb = jops.banded_lu(jnp.asarray(ab), bw=4, enrich=True)
    fb = convert.factorization_from_numpy(
        *(np.asarray(getattr(jfb, k)) for k in ("packed", "linv", "uinv", "tlo", "tup")),
        block=jfb.block, structure="banded", bw=4, device="cpu")
    close(ops.banded_solve(fb, cpu(bb), bw=4, impl="cuda_inverted"),
          jops.banded_solve(jfb, jnp.asarray(bb), bw=4))


# ---------------------------------------------------------------------------
# registry choices on an empty cache
# ---------------------------------------------------------------------------
def counterpart(ref_name: str) -> str:
    return {"pallas_vmem": "cuda_vmem", "xla": "torch", "pallas_inverted": "cuda_inverted"}[ref_name]


def selected(mod, **kw):
    p = mod.Problem(**kw)
    if mod is jsolvers:
        return jsolvers.select(p, cache=jsolvers.AutotuneCache()).name
    return solvers.select(p).name


@pytest.mark.parametrize("kw", [
    dict(op="factor", structure="batched_dense", n=64, batch=5),
    dict(op="factor", structure="batched_dense", n=64, batch=5, dtype="float64"),
    dict(op="solve", structure="batched_dense", n=64, batch=5, rhs=3),
    dict(op="solve", structure="batched_dense", n=1024, batch=8, rhs=1024),
    dict(op="solve", structure="batched_dense", n=64, batch=5, rhs=3, enriched=False),
    dict(op="factor", structure="batched_banded", n=16000, bw=5, batch=16),
    dict(op="solve", structure="batched_banded", n=16000, bw=5, batch=16, rhs=1),
    dict(op="solve", structure="batched_banded", n=500, bw=5, batch=4, rhs=2, dtype="float64"),
])
def test_batched_selection_is_the_counterpart_of_the_reference_slot(kw):
    assert selected(solvers, **kw) == counterpart(selected(jsolvers, **kw))


@pytest.mark.parametrize("kw", [
    # the optimizer's one group at whisper-tiny width: rhs 51968 > 4n
    dict(op="solve", structure="batched_dense", n=384, batch=2, rhs=51968),
    # past the reference's n <= 1024 cap
    dict(op="factor", structure="batched_dense", n=1100, batch=2),
    dict(op="solve", structure="batched_dense", n=1100, batch=2, rhs=1),
    # the Poisson ensemble: a 6.7 MB skewed band per system, over 6 MiB
    dict(op="factor", structure="batched_banded", n=4096, bw=64, batch=32),
    dict(op="solve", structure="batched_banded", n=4096, bw=64, batch=32, rhs=1, enriched=False),
])
def test_the_ported_batched_caps_depart_from_the_reference(kw):
    # the reference's VMEM caps send these to its vmapped mirror; the card's
    # kernels take them (solvers/backends.py, batched section)
    assert selected(jsolvers, **kw) == "xla"
    assert selected(solvers, **kw) == "cuda_vmem"


def test_batched_solve_cap_follows_one_columns_tile():
    # one RHS column on a cluster of 16 CTAs, each holding its strips' values
    # in shared memory (kernels/batched_lu.py:batched_solve_plan)
    fits = solvers.Problem(op="solve", structure="batched_dense", n=927744, batch=1, rhs=1)
    past = solvers.Problem(op="solve", structure="batched_dense", n=927745, batch=1, rhs=1)
    assert kbatched.batched_solve_plan(1, 927744, 1) == ("cluster", 1, 16, 232320)
    assert kbatched.batched_solve_fits(927744) and not kbatched.batched_solve_fits(927745)
    assert solvers.select(fits).name == "cuda_vmem" and solvers.select(past).name == "torch"


# C8: the batched solves take any number of systems (past the 65,535 of a
# grid's y extent too), so their slot's supports never looks at the batch
@pytest.mark.parametrize("kw", [
    dict(op="solve", structure="batched_dense", n=4, batch=70_000, rhs=1),
    dict(op="solve", structure="batched_banded", n=8, bw=1, batch=70_000, rhs=1),
])
def test_the_batched_solves_take_any_number_of_systems(kw):
    assert selected(solvers, **kw) == "cuda_vmem" == counterpart(selected(jsolvers, **kw))
    slot = solvers.get_backend(kw["op"], kw["structure"], "cuda_vmem")
    assert slot.supports(solvers.Problem(**kw)) and slot.supports(solvers.Problem(**{**kw, "batch": 1}))


def test_the_cache_key_ignores_the_batch_as_the_reference_does():
    p1 = solvers.Problem(op="factor", structure="batched_dense", n=64, batch=1)
    p8 = solvers.Problem(op="factor", structure="batched_dense", n=64, batch=8)
    assert cache._problem_key(p1) == cache._problem_key(p8)
    c = cache.AutotuneCache()
    c.record(p1, {"cuda_vmem": 50.0, "torch": 10.0})
    assert c.best(p8, ["cuda_vmem", "torch"]) == "torch"


def test_problem_from_stacks():
    p = solvers.Problem.from_arrays("solve", cpu(dd_stack(4, 10)), cpu(rhs(4, 10)))
    assert (p.structure, p.batch, p.n, p.rhs) == ("batched_dense", 4, 10, 1)
    p = solvers.Problem.from_arrays("factor", cpu(band_stack(3, 10, 2)), bw=2)
    assert (p.structure, p.batch, p.n, p.bw) == ("batched_banded", 3, 10, 2)
