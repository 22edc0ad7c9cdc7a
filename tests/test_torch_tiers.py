"""The accuracy tiers of the port (``core/refine.py``, ``core/randomized.py``,
the ``bf16_ir`` / ``bf16_ir_torch`` / ``rand_lu`` backends and the registry's
tolerance gate) against the JAX package: one test for each test of
``tests/test_accuracy_tiers.py`` that needs no MoE model.

Inputs are numpy arrays fed to both packages; the randomized tier's
Gaussian sketch is the reference's own draw (``jax.random.normal`` at its
default key), handed to the port as ``sketch=``.  Tolerances: solutions of
the fp32 tiers normwise to 1e-4 (each side refines to a residual of 1e-5
or 1e-6 on its own, in other summation orders); rank-k reconstructions
``l @ u`` to ``RANK_TOL = 1e-3`` (the CholeskyQR squares the sketch's
condition number, so fp32 round-off in the two frameworks' products
reaches ~3e-4 of the largest entry); residuals to the bounds the tiers
declare.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.core import randomized as jrand
from repro.core import refine as jrefine
from repro.kernels import ops as jops
from repro.solvers import cache as jcache
from repro_torch import solvers, train
from repro_torch.core import randomized, refine
from repro_torch.core.health import relative_residual
from repro_torch.kernels import ops
from repro_torch.serve import SolveService
from repro_torch.solvers.backends import (
    BF16_IR_RESIDUAL_FLOOR,
    IR_MAX_ITERS,
    RAND_LU_RESIDUAL_BOUND,
)

TOL = 1e-4
RANK_TOL = 1e-3


def dd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def lowrank(n, k, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, k)) @ rng.standard_normal((k, n)) / k).astype(np.float32)
    return a, (a @ rng.standard_normal(n).astype(np.float32)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def resid(a, x, b):
    return float(relative_residual(t(a), t(b), x))


def close(port, want, tol=TOL):
    port = np.asarray(port.double() if isinstance(port, torch.Tensor) else port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / np.abs(want).max()
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def ref_sketch(n, k, oversample=8):
    """The reference's default sketch of randomized_lu (key PRNGKey(0))."""
    p = min(oversample, n - k)
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n, k + p), dtype=jnp.float32))


def counterpart(name: str) -> str:
    if name.startswith("pallas_"):
        return "cuda_" + name.removeprefix("pallas_")
    if name.startswith("xla"):
        return "torch" + name.removeprefix("xla")
    return name.replace("_xla", "_torch")  # bf16_ir_xla, the mirror of bf16_ir


@pytest.fixture(autouse=True)
def no_cache(monkeypatch, tmp_path):
    """Absent cache files on both sides: selection is purely static."""
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    monkeypatch.setenv("REPRO_SOLVERS_CACHE", str(tmp_path / "absent_ref.json"))
    solvers.invalidate()
    jcache.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()
    yield
    solvers.invalidate()
    jcache.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()


def env_cache(monkeypatch, tmp_path, entries):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(path))
    solvers.invalidate()
    return path


# ---------------------------------------------------------------------------
# funnel: the tolerance gate
# ---------------------------------------------------------------------------
SLOTS = [("factor", "dense"), ("solve", "dense"), ("linear_solve", "dense"),
         ("linear_solve", "batched_dense")]


@pytest.mark.parametrize("tolerance", [0.0, 1e-9, 1e-6, 1e-4, 1e-3, 5e-2])
@pytest.mark.parametrize("op,structure", SLOTS)
def test_tolerance_gate_admits_the_reference_candidates(op, structure, tolerance):
    kw = dict(op=op, structure=structure, n=256, tolerance=tolerance,
              batch=4 if structure.startswith("batched") else 1)
    want = sorted(counterpart(b.name) for b in jsolvers.candidates(jsolvers.Problem(**kw))
                  if b.name != "distributed")
    got = sorted(b.name for b in solvers.candidates(solvers.Problem(**kw)))
    assert got == want


def test_default_tolerance_selects_exact_backends_only():
    for op, structure in SLOTS:
        p = solvers.Problem(op=op, structure=structure, n=256,
                            batch=4 if structure.startswith("batched") else 1)
        for b in solvers.candidates(p):
            assert b.residual_bound is None, f"approximate backend {b.name} admitted at 0.0"
    assert solvers.select(solvers.Problem(op="factor", structure="dense", n=256)).name == "cuda_fused"


def test_tolerance_gate_admits_by_declared_bound():
    loose = solvers.Problem(op="linear_solve", structure="dense", n=256, tolerance=1e-4)
    names = {b.name for b in solvers.candidates(loose)}
    assert {"bf16_ir", "bf16_ir_torch"} <= names and "rand_lu" not in names
    tight = solvers.Problem(op="linear_solve", structure="dense", n=256, tolerance=1e-9)
    assert all(b.residual_bound is None for b in solvers.candidates(tight))


def test_default_tolerance_results_bitwise_unchanged():
    a, b = dd(128), normal(128, 1)
    x_default = ops.linear_solve(t(a), t(b))
    assert torch.equal(x_default, ops.linear_solve(t(a), t(b), tolerance=0.0))
    close(x_default, np.asarray(jops.linear_solve(jnp.asarray(a), jnp.asarray(b))), 1e-5)


# ---------------------------------------------------------------------------
# bf16 + iterative refinement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [256, 1024])
def test_bf16_ir_converges_to_requested_residual(n):
    a, b = dd(n), normal(n, 1)
    tol = 1e-5
    x = ops.linear_solve(t(a), t(b), tolerance=tol, impl="bf16_ir")
    info = refine.last_refinement()
    assert resid(a, x, b) <= tol
    assert info["iterations"] is not None and info["iterations"] <= IR_MAX_ITERS
    jx = jops.linear_solve(jnp.asarray(a), jnp.asarray(b), tolerance=tol, impl="bf16_ir_xla")
    close(x, np.asarray(jx))
    assert info["iterations"] == jrefine.last_refinement()["iterations"]


def test_bf16_ir_auto_selected_when_tolerance_permits():
    a, b = dd(256), normal(256, 1)
    with solvers.record_dispatches() as log:
        x = ops.linear_solve(t(a), t(b), tolerance=1e-5)
    with jsolvers.record_dispatches() as jlog:
        jops.linear_solve(jnp.asarray(a), jnp.asarray(b), tolerance=1e-5)
    assert [name for _, name in log] == [counterpart(name) for _, name in jlog] == ["bf16_ir"]
    assert resid(a, x, b) <= 1e-5


def test_bf16_ir_torch_is_the_plain_twin():
    a, b = dd(200, 3), normal((200, 3), 4)
    x = ops.linear_solve(t(a), t(b), tolerance=1e-6, impl="bf16_ir")
    xt = ops.linear_solve(t(a), t(b), tolerance=1e-6, impl="bf16_ir_torch")
    assert torch.equal(x, xt)  # on the CPU both run the plain factor and correction
    assert resid(a, x, b) <= BF16_IR_RESIDUAL_FLOOR


def test_tier_dispatch_with_verify_residual_checks_the_bound():
    a, b = dd(96, 5), normal(96, 6)
    x = ops.linear_solve(t(a), t(b), tolerance=1e-5, verify_residual=True)
    assert resid(a, x, b) <= 1e-5


def test_verify_residual_fused_tier_escalates_between_twins():
    # tests/test_faults.py's twin escalation of the fused tier
    a, b = dd(128, 9), normal(128, 109)
    with jsolvers.inject(backend_raises=True, backend="bf16_ir", op="linear_solve"):
        with jsolvers.record_escalations() as jesc:
            jops.linear_solve(jnp.asarray(a), jnp.asarray(b), tolerance=1e-5)
    with solvers.inject(backend_raises=True, backend="bf16_ir", op="linear_solve"):
        with solvers.record_escalations() as esc:
            x = ops.linear_solve(t(a), t(b), tolerance=1e-5)
    assert [(e[1], e[2]) for e in esc] == [(counterpart(e[1]), counterpart(e[2])) for e in jesc]
    assert [(e[1], e[2]) for e in esc] == [("bf16_ir", "bf16_ir_torch")]
    assert resid(a, x, b) <= 1e-5


# ---------------------------------------------------------------------------
# the host refinement loop
# ---------------------------------------------------------------------------
def test_iterative_refinement_matches_the_reference_loop():
    a, b = dd(64, 7), normal((64, 2), 8)
    approx = a + 1e-2 * normal((64, 64), 9)  # a perturbed operator for the corrections
    correct_t = lambda r: torch.linalg.solve(t(approx), r)
    correct_j = lambda r: jnp.linalg.solve(jnp.asarray(approx), r)
    x, info = refine.iterative_refinement(t(a), t(b), correct_t(t(b)), correct_t, tolerance=1e-6)
    jx, jinfo = jrefine.iterative_refinement(jnp.asarray(a), jnp.asarray(b),
                                             correct_j(jnp.asarray(b)), correct_j, tolerance=1e-6)
    assert info.iterations == int(jinfo.iterations) and info.residual <= 1e-6
    close(x, np.asarray(jx), 1e-5)
    assert refine.last_refinement() == {"iterations": info.iterations, "residual": info.residual}


def test_a_stack_refines_each_system_and_reports_its_worst():
    a = np.stack([dd(32, 10), dd(32, 11)])
    b = normal((2, 32), 12)
    noise = np.stack([np.zeros((32, 32), np.float32), 5e-2 * normal((32, 32), 13)])
    approx = t(a + noise)
    correct = lambda r: torch.linalg.solve(approx, r)
    x, info = refine.iterative_refinement(t(a), t(b), correct(t(b)), correct, tolerance=1e-6)
    ones = [refine.iterative_refinement(t(a[i]), t(b[i]), correct(t(b))[i],
                                        lambda r, i=i: torch.linalg.solve(approx[i], r),
                                        tolerance=1e-6) for i in range(2)]
    assert info.iterations == max(o[1].iterations for o in ones) > ones[0][1].iterations == 0
    for i in range(2):
        close(x[i], ones[i][0].numpy(), 1e-6)


# ---------------------------------------------------------------------------
# the randomized rank-k tier
# ---------------------------------------------------------------------------
def test_randomized_lu_factors_and_solve():
    n, k = 192, 24
    a, b = lowrank(n, k)
    f = randomized.randomized_lu(t(a), rank=k, sketch=t(ref_sketch(n, k)))
    assert isinstance(f, randomized.RankKFactors) and f.rank == k
    # near-orthonormal basis; the Gram ridge blurs directions at the
    # operand's smallest kept singular value
    close(f.l.T @ f.l, np.eye(k), 5e-2)
    x = randomized.randomized_solve(f, t(b))
    assert resid(a, x, b) <= RAND_LU_RESIDUAL_BOUND
    jf = jrand.randomized_lu(jnp.asarray(a), rank=k)
    close(f.l @ f.u, np.asarray(jf.l @ jf.u), RANK_TOL)
    close(x, np.asarray(jrand.randomized_solve(jf, jnp.asarray(b))), 1e-3)


def test_rand_lu_through_public_ops():
    n, k = 256, 32
    a, b = lowrank(n, k, seed=1)
    x = ops.linear_solve(t(a), t(b), rank=k, tolerance=RAND_LU_RESIDUAL_BOUND)
    assert resid(a, x, b) <= RAND_LU_RESIDUAL_BOUND
    with solvers.record_dispatches() as log:
        f = ops.lu(t(a), rank=k, tolerance=RAND_LU_RESIDUAL_BOUND, sketch=t(ref_sketch(n, k)))
        x2 = ops.lu_solve(f, t(b), tolerance=RAND_LU_RESIDUAL_BOUND)
    assert isinstance(f, randomized.RankKFactors)
    assert [(p.op, name) for p, name in log] == [("factor", "rand_lu"), ("solve", "rand_lu")]
    assert resid(a, x2, b) <= RAND_LU_RESIDUAL_BOUND
    jf = jops.lu(jnp.asarray(a), rank=k, tolerance=RAND_LU_RESIDUAL_BOUND)
    close(f.l @ f.u, np.asarray(jf.l @ jf.u), RANK_TOL)


def test_rank_factors_pass_the_health_screen_and_a_generator_seeds_the_sketch():
    a, _ = lowrank(128, 16, seed=2)
    f1, rec = ops.lu(t(a), rank=16, tolerance=1e-3, health=True,
                     generator=torch.Generator().manual_seed(5))
    f2 = ops.lu(t(a), rank=16, tolerance=1e-3, generator=torch.Generator().manual_seed(5))
    assert rec.verdict() and torch.equal(f1.l, f2.l) and torch.equal(f1.u, f2.u)
    with pytest.raises(ValueError, match="2-D"):
        ops.lu(t(np.stack([a, a])), rank=4)


# ---------------------------------------------------------------------------
# cache-key integrity
# ---------------------------------------------------------------------------
def test_loose_measured_win_never_serves_tight_problem(monkeypatch, tmp_path):
    entry = {"op": "linear_solve", "structure": "dense", "n": 256, "bw": 0, "dtype": "float32",
             "tolerance": 1e-3, "devices": 1, "device": "cpu",
             "times_us": {"bf16_ir": 1.0, "torch": 9e9}}
    env_cache(monkeypatch, tmp_path, [entry])
    loose = solvers.Problem(op="linear_solve", structure="dense", n=256, tolerance=1e-3)
    assert solvers.select(loose).name == "bf16_ir"
    tight = solvers.Problem(op="linear_solve", structure="dense", n=256)
    assert solvers.get_cache().lookup(tight) is None
    assert not any(b.name == "bf16_ir" for b in solvers.candidates(tight))
    a, b = dd(256), normal(256, 1)
    with solvers.record_dispatches() as log:
        ops.linear_solve(t(a), t(b))
    assert [p.op for p, _ in log] == ["factor", "solve"]
    other = solvers.Problem(op="linear_solve", structure="dense", n=256, dtype="bfloat16",
                            tolerance=1e-3)
    assert solvers.get_cache().lookup(other) is None


def test_pre_tolerance_cache_rows_load_as_exact(monkeypatch, tmp_path):
    entry = {"op": "factor", "structure": "dense", "n": 256, "bw": 0, "dtype": "float32",
             "device": "cpu", "times_us": {"torch": 1.0, "cuda_fused": 9e9}}
    env_cache(monkeypatch, tmp_path, [entry])
    assert solvers.select(solvers.Problem(op="factor", structure="dense", n=256)).name == "torch"


def test_coalescing_width_records_match_the_reference(tmp_path):
    p = solvers.Problem(op="solve", structure="dense", n=512)
    jp = jsolvers.Problem(op="solve", structure="dense", n=512)
    cache, jc = solvers.AutotuneCache(), jsolvers.AutotuneCache()
    widths = {8: 100.0, 32: 1000.0, 128: 5000.0}
    cache.record_widths(p, widths)
    jc.record_widths(jp, widths)
    assert cache.lookup(p)["width_us"] == jc.lookup(jp)["width_us"]
    for n in (512, 300, 2000, 4000):
        assert cache.best_width(solvers.Problem(op="solve", structure="dense", n=n)) == \
            jc.best_width(jsolvers.Problem(op="solve", structure="dense", n=n))
    cache.save(str(tmp_path / "c.json"))
    assert solvers.AutotuneCache.load(str(tmp_path / "c.json")).best_width(p) == 8


# ---------------------------------------------------------------------------
# serve: the tiered factorization cache and the coalescing-width cap
# ---------------------------------------------------------------------------
def test_service_tier_never_reverse():
    """An approximate cached factor serves looser requests, never a tighter
    one; a tight factor serves looser requests.

    The reference's test also asks the exact answer for a residual of 1e-4.
    Its operand is rank 16 of order 128, numerically singular, and the
    exact tier's no-pivot LU of it reaches only 1.4e-3 there (the test
    fails in the reference for that reason).  Here the exact answer is held
    to the exact tier's own solve of the same operand instead."""
    n, k = 128, 16
    a, b = lowrank(n, k, seed=3)
    svc = SolveService(device="cpu")
    svc.solve(a, b, tolerance=RAND_LU_RESIDUAL_BOUND, rank=k)
    fp = next(iter(svc._lru))
    assert sorted(svc._lru[fp]) == [RAND_LU_RESIDUAL_BOUND]
    assert svc.stats.approx_solves >= 1
    misses, factors_before = svc.stats.cache_misses, svc.stats.factor_dispatches
    x = svc.solve(a, b)
    assert svc.stats.cache_misses == misses + 1
    assert svc.stats.factor_dispatches > factors_before
    assert sorted(svc._lru[fp]) == [0.0, RAND_LU_RESIDUAL_BOUND]
    assert torch.equal(x, ops.lu_solve(ops.lu(t(a)), t(b)))  # the exact tier's answer
    hits = svc.stats.cache_hits
    svc.solve(a, b, tolerance=5e-2)
    assert svc.stats.cache_hits == hits + 1


def test_service_rank_request_validates_tolerance():
    svc = SolveService(device="cpu")
    a, b = lowrank(64, 8)
    with pytest.raises(ValueError):
        svc.submit(a, b, rank=8)
    with pytest.raises(ValueError):
        svc.submit(a, b, bw=1, rank=8, tolerance=1e-2)


def test_service_tolerance_in_scheduler_bucket():
    n = 64
    a, b = dd(n), normal(n, 1)
    svc = SolveService(device="cpu")
    t1 = svc.submit(a, b)
    t2 = svc.submit(a, b, tolerance=1e-2)
    buckets = sorted(svc._sched.buckets())
    assert buckets == [("dense", n, 0, "float32", 0.0), ("dense", n, 0, "float32", 1e-2)]
    out = svc.flush()
    assert svc.stats.factor_dispatches == 1
    close(out[t1], out[t2].numpy(), 1e-5)


def test_service_coalescing_width_cap(monkeypatch, tmp_path):
    n = 512
    entry = {"op": "solve", "structure": "dense", "n": n, "bw": 0, "dtype": "float32",
             "tolerance": 0.0, "devices": 1, "device": "cpu", "times_us": {"torch": 1.0},
             "width_us": {"8": 100.0, "32": 1000.0, "128": 5000.0}}
    env_cache(monkeypatch, tmp_path, [entry])
    a, b = dd(n), normal((n, 20), 1)
    svc = SolveService(device="cpu")
    x = svc.solve(a, b)
    assert svc.stats.width_capped_dispatches == 2  # 20 columns: 8 + 8 + 4
    assert svc.stats.solve_dispatches == 3
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    svc2 = SolveService(device="cpu")
    x_ref = svc2.solve(a, b)
    assert svc2.stats.width_capped_dispatches == 0
    assert torch.equal(x, x_ref)  # columns are independent in the substitution


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def _optimizer_step(solve_tolerance, d=64, nleaves=3):
    rng = np.random.default_rng(30)
    params = [torch.nn.Parameter(torch.from_numpy(0.02 * rng.standard_normal((d, d)).astype(np.float32)))
              for _ in range(nleaves)]
    for p in params:
        p.grad = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32))
    opt = train.EbvPreconditioned(params, lr=train.constant_lr(1e-3), b2=0.95,
                                  solve_tolerance=solve_tolerance)
    with solvers.record_dispatches() as log:
        opt.step()
    return params, opt, log


def test_optimizer_auto_tolerance_dispatches_approx_tier():
    params, opt, log = _optimizer_step("auto")
    assert opt.solve_tolerance == pytest.approx(max(1e-6, 0.05 * 0.1))
    assert [(p.op, p.structure, name) for p, name in log] == [
        ("linear_solve", "batched_dense", "bf16_ir")]
    for p in params:
        assert bool(torch.isfinite(p).all())


@pytest.mark.parametrize("tolerance", ["auto", 1e-3, 0.0])
def test_optimizer_solve_tolerance_keys_the_dispatch_like_the_reference(tolerance):
    # the reference's optimizer hands the same tolerance to linear_solve
    _, opt, log = _optimizer_step(tolerance)
    want = {"auto": 0.005, 1e-3: 1e-3, 0.0: 0.0}[tolerance]
    assert opt.solve_tolerance == pytest.approx(want)
    assert all(p.tolerance == pytest.approx(want) for p, _ in log)
    names = [name for _, name in log]
    assert names == (["cuda_vmem", "cuda_vmem"] if want == 0.0 else ["bf16_ir"])


def test_optimizer_default_stays_exact():
    _, opt, log = _optimizer_step(None, d=32, nleaves=1)
    assert opt.solve_tolerance == 0.0
    assert not any(name.startswith("bf16_ir") or name == "rand_lu" for _, name in log)
