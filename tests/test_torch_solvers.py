"""The port's dispatch registry (``repro_torch.solvers``) against the JAX
package's.

Slot choices are compared exactly, name for name, through the renaming
``pallas_*`` → ``cuda_*``, ``xla*`` → ``torch*``.  The port's autotune cache
is isolated per test through ``REPRO_TORCH_SOLVERS_CACHE``.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.kernels import ops as jops
from repro_torch import solvers
from repro_torch.core.pivoted import PivotedFactors
from repro_torch.core.health import relative_residual
from repro_torch.kernels import ops

CARD = "NVIDIA H100 80GB HBM3"


def counterpart(name: str) -> str:
    if name.startswith("pallas_"):
        return "cuda_" + name.removeprefix("pallas_")
    if name.startswith("xla"):
        return "torch" + name.removeprefix("xla")
    return name


def dd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    """An absent cache file (pure static selection) and no demotions."""
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()
    yield
    solvers.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()


SLOTS = [
    dict(op="factor", n=64),
    dict(op="factor", n=2048),
    dict(op="factor", n=8000),
    dict(op="factor", n=64, dtype="bfloat16"),
    dict(op="factor", n=64, dtype="float64"),
    dict(op="solve", n=500, rhs=1),
    dict(op="solve", n=2048, rhs=64),
    dict(op="solve", n=2049, rhs=1),
    dict(op="solve", n=4096, rhs=64),
    dict(op="solve", n=8000, rhs=1, enriched=False),
]


@pytest.mark.parametrize("kw", SLOTS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_select_picks_the_counterpart_of_the_reference_slot(kw):
    want = jsolvers.select(jsolvers.Problem(structure="dense", **kw), cache=jsolvers.AutotuneCache())
    for device in ("cpu", CARD):  # selection never looks at the device
        got = solvers.select(solvers.Problem(structure="dense", device=device, **kw))
        assert got.name == counterpart(want.name)


def test_default_slots_by_name():
    sel = lambda **kw: solvers.select(solvers.Problem(structure="dense", **kw)).name
    assert sel(op="factor", n=1000) == "cuda_fused"
    assert sel(op="solve", n=2048, rhs=1) == "cuda_vmem"
    assert sel(op="solve", n=4096, rhs=1) == "cuda_tiled"  # selection only: nothing runs
    assert sel(op="factor", n=100, dtype="bfloat16") == "torch"


def test_enriched_capability_gates_the_inverted_solves():
    raw = solvers.Problem(op="solve", structure="dense", n=300, rhs=4, enriched=False)
    names = {b.name for b in solvers.candidates(raw)}
    assert "cuda_inverted" not in names and "torch_inverted" not in names
    enriched = solvers.Problem(op="solve", structure="dense", n=300, rhs=4)
    assert {"cuda_inverted", "torch_inverted"} <= {b.name for b in solvers.candidates(enriched)}
    assert solvers.select(enriched).name == "cuda_vmem"  # inverted is reached forced or measured


def test_problem_from_tensors():
    a = torch.zeros(12, 12)
    p = solvers.Problem.from_arrays("solve", a, torch.zeros(12, 3))
    assert (p.n, p.rhs, p.dtype, p.device, p.enriched) == (12, 3, "float32", "cpu", False)
    assert solvers.Problem.from_arrays("factor", a.double()).dtype == "float64"
    assert solvers.Problem.from_arrays("factor", torch.zeros(2, 5, 5)).structure == "batched_dense"
    with pytest.raises(ValueError):
        solvers.Problem(op="nope", structure="dense", n=4)


def test_cache_is_isolated_by_env_and_keyed_by_device(monkeypatch, tmp_path):
    path = tmp_path / "port_cache.json"
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(path))
    solvers.invalidate()
    assert solvers.cache_path() == str(path)
    assert jsolvers.cache_path() != str(path)  # the reference keeps its own file
    cpu = solvers.Problem(op="factor", structure="dense", n=512, device="cpu")
    card = solvers.Problem(op="factor", structure="dense", n=512, device=CARD)
    cache = solvers.AutotuneCache()
    cache.record(cpu, {"cuda_fused": 900.0, "torch": 100.0})  # a CPU-measured win
    cache.save(str(path))
    solvers.invalidate()
    assert solvers.select(cpu).name == "torch"
    assert solvers.select(dataclasses.replace(cpu, n=1024)).name == "torch"  # nearest size
    assert solvers.select(card).name == "cuda_fused"  # never steers the card
    loaded = solvers.AutotuneCache.load(str(path))
    assert loaded.lookup(cpu)["device"] == "cpu" and loaded.lookup(card) is None


def test_unreadable_cache_warns_and_starts_empty(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cache = solvers.AutotuneCache.load(str(bad))
    assert cache.entries == [] and any("unreadable" in str(w.message) for w in caught)


def test_health_escalates_to_pivoted_like_the_reference():
    a = dd(64, 5)
    a[0, 0] = 0.0  # singular for no-pivot LU, fine with pivoting
    with jsolvers.record_escalations() as jesc:
        jops.lu(jnp.asarray(a), health=True)
    with solvers.record_escalations() as esc:
        f, rec = ops.lu(torch.from_numpy(a), health=True)
    assert isinstance(f, PivotedFactors) and rec.verdict()
    ported = {b.name for b in solvers.backends_for("factor", "dense")}
    want = [(counterpart(e[1]), e[3][:9]) for e in jesc if counterpart(e[1]) in ported]
    assert [(e[1], e[3][:9]) for e in esc] == want  # same failures, same order
    assert esc[-1][2] == "pivoted"
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(np.float32))
    x = ops.lu_solve(f, b)
    assert float(relative_residual(torch.from_numpy(a), b, x)) < 1e-4


def test_fault_injection_demotes_a_backend():
    a = torch.from_numpy(dd(48, 2))
    with solvers.inject(backend_raises=True, backend="cuda_fused", op="factor") as plan:
        with solvers.record_escalations() as esc:
            f, rec = ops.lu(a, health=True)
        assert [(e[1], e[2]) for e in esc] == [("cuda_fused", "torch")]
        assert "InjectedFault" in esc[0][3]
        assert any(k[1] == "cuda_fused" for k in solvers.demotions())
        assert [kind for _, _, kind in plan.applied] == ["backend_raises"]
    assert not solvers.demotions()  # leaving the plan clears the table
    assert rec.verdict()
    assert torch.allclose(f.packed, ops.lu(a, impl="torch").packed)


@pytest.mark.parametrize("device", ["cpu", CARD])
def test_only_injected_faults_escalate_on_the_card(device, monkeypatch):
    # on the card a backend's own error (a kernel that fails to build or
    # launch) propagates: the plain version of the next candidate never
    # stands in for the kernel.  An injected fault escalates everywhere.
    def broken(problem, *arrays, **kw):
        raise RuntimeError("kernel failed to launch")

    a = torch.from_numpy(dd(24, 13))
    problem = solvers.Problem(op="factor", structure="dense", n=24, device=device)
    accept = lambda problem, backend, result: None
    want = ops.lu(a, impl="torch").packed
    with solvers.inject(backend_raises=True, backend="cuda_fused", op="factor"):
        with solvers.record_escalations() as esc:
            assert torch.equal(solvers.dispatch(problem, a, validate=accept), want)
    assert [(e[1], e[2]) for e in esc] == [("cuda_fused", "torch")]
    slot = solvers.registry._REGISTRY[("factor", "dense")]
    monkeypatch.setitem(slot, "cuda_fused", dataclasses.replace(slot["cuda_fused"], call=broken))
    with solvers.record_escalations() as esc:
        if device == "cpu":
            assert torch.equal(solvers.dispatch(problem, a, validate=accept), want)
        else:
            with pytest.raises(RuntimeError, match="failed to launch") as ei:
                solvers.dispatch(problem, a, validate=accept)
            assert not isinstance(ei.value, solvers.SolveFailure)
    assert [(e[1], e[2]) for e in esc] == ([("cuda_fused", "torch")] if device == "cpu" else [])


def test_nan_pivot_fault_is_caught_by_the_screen():
    a = torch.from_numpy(dd(40, 3))
    with solvers.inject(nan_pivot_at=0, backend="cuda_fused", op="factor"):
        with solvers.record_escalations() as esc:
            f, rec = ops.lu(a, health=True)
    assert esc[0][1] == "cuda_fused" and "non-finite" in esc[0][3]
    assert rec.verdict() and torch.isfinite(f.packed).all()


def test_every_backend_failing_raises_a_structured_failure():
    a = torch.from_numpy(dd(32, 4))
    with solvers.inject(backend_raises=True, op="factor"):
        with pytest.raises(solvers.SolveFailure) as ei:
            ops.lu(a, health=True)
    # the reference's chain under the names of the port: pallas_fused, xla,
    # pallas_vmem, pivoted, pallas_blocked
    assert [c["backend"] for c in ei.value.chain] == ["cuda_fused", "torch", "cuda_vmem", "pivoted",
                                                       "cuda_blocked"]
    assert ei.value.problem.op == "factor"


def test_forced_impl_that_fails_validation_raises_without_escalating():
    a = dd(32, 6)
    a[0, 0] = 0.0
    with solvers.record_escalations() as esc:
        with pytest.raises(solvers.SolveFailure) as ei:
            ops.lu(torch.from_numpy(a), impl="torch", health=True)
    assert not esc and ei.value.chain[0]["backend"] == "torch"
    assert ei.value.health is not None and not ei.value.health.verdict()


def test_verify_residual_escalates_the_composed_path_to_pivoted():
    a = dd(64, 8)
    a[0, 0] = 0.0
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(64).astype(np.float32))
    with solvers.record_escalations() as esc:
        x = ops.linear_solve(torch.from_numpy(a), b, verify_residual=True)
    assert ("composed", "pivoted") in [(e[1], e[2]) for e in esc]
    assert float(relative_residual(torch.from_numpy(a), b, x)) <= solvers.VERIFY_RESIDUAL_DEFAULT_BOUND


def test_dispatch_hooks_record_and_detach():
    a = torch.from_numpy(dd(40, 9))
    b = torch.ones(40)
    with solvers.record_dispatches() as log:
        ops.linear_solve(a, b)
    assert [name for _, name in log] == ["cuda_fused", "cuda_vmem"]
    with solvers.record_dispatches() as log2:
        pass
    ops.lu(a)
    assert log2 == []


# a stack runs the batched slots since the batched slice, and the tiers and
# the legacy factors run since the fourth slice: what stays out of slice is
# the multi-device path (mesh=, the distributed and replicated slots)
@pytest.mark.parametrize("call", [
    lambda a: ops.lu(a.expand(2, 8, 8), mesh=object()),
    lambda a: ops.lu(a, mesh=object()),
    lambda a: ops.linear_solve(a, torch.ones(8), mesh=object()),
    lambda a: ops.lu(a, impl="distributed"),
    lambda a: ops.linear_solve(a, torch.ones(8), impl="distributed"),
    lambda a: ops.banded_lu(a[:, :3], bw=1, impl="replicated"),
    lambda a: ops.banded_lu(a[:, :3], bw=1, mesh=object()),
    lambda a: ops.banded_solve(a[:, :3], torch.ones(8), bw=1, mesh=object()),
], ids=["batched", "mesh", "linear-mesh", "distributed", "linear-distributed", "replicated-band",
        "band-mesh", "band-solve-mesh"])
def test_out_of_slice_requests_raise_not_implemented(call):
    with pytest.raises(NotImplementedError):
        call(torch.from_numpy(dd(8, 10)))


# the requests the first three slices refused, which the fourth slice runs
@pytest.mark.parametrize("call,kind", [
    (lambda a: ops.lu(a, tolerance=1e-3), "Factorization"),
    (lambda a: ops.lu(a, rank=4), "RankKFactors"),
    (lambda a: ops.linear_solve(a, torch.ones(8), tolerance=1e-3), "Tensor"),
    (lambda a: ops.lu(a, impl="cuda_vmem"), "Factorization"),
    (lambda a: ops.lu(a, impl="cuda_blocked"), "Factorization"),
    (lambda a: ops.lu_solve(ops.lu(a).packed.expand(2, 8, 8), torch.ones(2, 8), tolerance=1e-3),
     "Tensor"),
    (lambda a: ops.banded_lu(a[:, :3], bw=1, impl="cuda_scalar"), "Factorization"),
], ids=["tolerance", "rank", "linear-tolerance", "lu_vmem", "blocked", "batched-solve",
        "scalar-band"])
def test_requests_of_the_tiers_and_legacy_slice_run(call, kind):
    assert type(call(torch.from_numpy(dd(8, 10)))).__name__ == kind


def test_unknown_impl_is_a_value_error():
    with pytest.raises(ValueError, match="unknown impl"):
        ops.lu(torch.from_numpy(dd(8, 11)), impl="pallas_fused")


def test_slow_dispatch_fault_is_budgeted():
    a = torch.from_numpy(dd(16, 12))
    with solvers.inject(slow_dispatch_us=1000.0, op="factor", times=1) as plan:
        ops.lu(a)
        ops.lu(a)
    assert [kind for _, _, kind in plan.applied] == ["slow_dispatch"]
