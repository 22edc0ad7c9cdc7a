"""The port's solve service (``repro_torch.serve``) against the JAX
package's: one test for each test of ``tests/test_solve_service.py`` and for
each service test of ``tests/test_faults.py``, the same numpy operands fed
to both services, their answers and their stats compared.

Tolerances: answers normwise to ``TOL = 1e-5`` of the largest entry
across the frameworks (fp32, sums in other orders).  Inside the port a
coalesced answer is held to the per-request solve through the same
factors, normwise to ``TOL`` as well: the reference's tests ask for bit
equality there, which its own stacked solve misses by ~7.5e-9
(``test_mixed_matrices_grouped`` and ``test_banded_service_parity`` fail
in the reference for that; ROADMAP §C), and the port holds the contract
those tests state, within a tolerance.  Where both sides answer through
one code path (the same service, the same factors) results are compared
bit for bit.  The stats are compared field for field.
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.serve import solve_service as jservice
from repro_torch import solvers
from repro_torch.core.health import relative_residual
from repro_torch.kernels import ops
from repro_torch.serve import (
    DeadlineMiss,
    NotFlushed,
    SolveService,
    UnknownTicket,
    fingerprint,
)

TOL = 1e-5


def dd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def band_dd(n, bw, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, 2 * bw + 1)).astype(np.float32)
    j = np.arange(n)[:, None] - bw + np.arange(2 * bw + 1)[None, :]
    a = np.where((j >= 0) & (j < n), a, 0.0).astype(np.float32)
    a[:, bw] = np.abs(a).sum(axis=1) - np.abs(a[:, bw]) + 1.0
    return a


def rhs(n, seed=100, m=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, want, tol=TOL):
    port = np.asarray(port.double() if isinstance(port, torch.Tensor) else port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / np.abs(want).max()
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def same_stats(svc, jsvc):
    got, want = dataclasses.asdict(svc.stats), dataclasses.asdict(jsvc.stats)
    assert got == want


def cpu_service(**kw):
    return SolveService(device="cpu", **kw)


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    monkeypatch.setenv("REPRO_SOLVERS_CACHE", str(tmp_path / "absent_ref.json"))
    solvers.invalidate()
    jsolvers.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()
    yield
    solvers.invalidate()
    jsolvers.invalidate()
    solvers.clear_demotions()
    jsolvers.clear_demotions()


@pytest.fixture()
def dense_system():
    n = 96
    return dd(n, 0), [rhs(n, 100 + i) for i in range(8)]


def both(fn):
    """Run ``fn(service)`` on a port service and a reference service."""
    svc, jsvc = cpu_service(), jservice.SolveService()
    return svc, jsvc, fn(svc), fn(jsvc)


# ---------------------------------------------------------------------------
# tests/test_solve_service.py
# ---------------------------------------------------------------------------
def test_factor_once_solve_many_coalesced(dense_system):
    a, _ = dense_system
    n = a.shape[0]
    bs = [rhs(n, i) for i in range(64)]

    def run(svc):
        tickets = [svc.submit(a, b) for b in bs]
        assert svc.pending() == 64
        return tickets, svc.flush()

    svc, jsvc, (tickets, results), (jtickets, jresults) = both(run)
    st = svc.stats
    assert (st.factor_dispatches, st.solve_dispatches) == (1, 1)
    assert (st.cache_misses, st.cache_hits, st.coalesced_requests, st.solved_columns) == (1, 63, 64, 64)
    same_stats(svc, jsvc)
    factors = ops.lu(t(a))
    for tk, jt, b in zip(tickets, jtickets, bs):
        close(results[tk], ops.lu_solve(factors, t(b)).numpy())
        close(results[tk], np.asarray(jresults[jt]))


def test_cache_hit_miss_evict(dense_system):
    a, bs = dense_system
    n = a.shape[0]
    a2, a3 = dd(n, 1), dd(n, 2)

    def run(svc):
        svc.solve(a, bs[0])
        assert (svc.stats.cache_misses, svc.stats.cache_hits) == (1, 0)
        svc.solve(a, bs[1])
        assert (svc.stats.cache_misses, svc.stats.cache_hits) == (1, 1)
        svc.solve(a2, bs[2])
        svc.solve(a3, bs[3])  # evicts a
        assert svc.stats.cache_evictions == 1
        return svc.solve(a, bs[4])  # a misses again

    svc, jsvc = cpu_service(cache_entries=2), jservice.SolveService(cache_entries=2)
    x, jx = run(svc), run(jsvc)
    assert svc.stats.cache_misses == 4 and svc.stats.factor_dispatches == 4
    assert svc.stats.hit_rate == pytest.approx(1 / 5)
    same_stats(svc, jsvc)
    close(x, np.asarray(jx))


def test_mixed_matrices_grouped(dense_system):
    """Interleaved requests against two matrices coalesce into one solve
    dispatch per matrix.  Each coalesced answer is held to the per-request
    solve within ``TOL``, not bit for bit (see the module docstring)."""
    a, bs = dense_system
    a2 = dd(a.shape[0], 7)
    order = [(a, bs[0]), (a2, bs[1]), (a, bs[2]), (a2, bs[3]), (a, bs[4])]

    def run(svc):
        return [svc.submit(m, b) for m, b in order], svc.flush()

    svc, jsvc, (tickets, results), (jtickets, jresults) = both(run)
    assert (svc.stats.factor_dispatches, svc.stats.solve_dispatches) == (2, 2)
    same_stats(svc, jsvc)
    f1, f2 = ops.lu(t(a)), ops.lu(t(a2))
    for tk, jt, (m, b) in zip(tickets, jtickets, order):
        close(results[tk], ops.lu_solve(f1 if m is a else f2, t(b)).numpy())
        close(results[tk], np.asarray(jresults[jt]))


def test_matrix_rhs_requests_coalesce(dense_system):
    a, bs = dense_system
    n = a.shape[0]
    blk = rhs(n, 50, m=5)

    def run(svc):
        return svc.submit(a, bs[0]), svc.submit(a, blk), svc.flush()

    svc, jsvc, (t1, t2, out), (j1, j2, jout) = both(run)
    assert out[t1].shape == (n,) and out[t2].shape == (n, 5)
    assert svc.stats.solve_dispatches == 1 and svc.stats.solved_columns == 6
    same_stats(svc, jsvc)
    close(out[t2], ops.lu_solve(ops.lu(t(a)), t(blk)).numpy())
    close(out[t2], np.asarray(jout[j2]))
    close(out[t1], np.asarray(jout[j1]))


def test_banded_service_parity():
    """A band's coalesced answers against per-request solves through the
    same multi-RHS backend, within ``TOL`` (see the module docstring)."""
    n, bw = 128, 3
    arow = band_dd(n, bw, 3)
    bs = [rhs(n, 200 + i) for i in range(6)]

    def run(svc):
        return [svc.submit(arow, b, bw=bw) for b in bs], svc.flush()

    svc, jsvc, (tickets, results), (jtickets, jresults) = both(run)
    assert (svc.stats.factor_dispatches, svc.stats.solve_dispatches) == (1, 1)
    same_stats(svc, jsvc)
    lub = ops.banded_lu(t(arow), bw=bw)
    for tk, jt, b in zip(tickets, jtickets, bs):
        close(results[tk], ops.banded_solve(lub, t(b)[:, None], bw=bw)[:, 0].numpy())
        close(results[tk], np.asarray(jresults[jt]))


def test_fingerprint_sensitivity():
    a = np.eye(8, dtype=np.float32)
    assert fingerprint(a) == fingerprint(a.copy())
    b = a.copy()
    b[3, 4] = 1e-7
    assert fingerprint(a) != fingerprint(b)
    assert fingerprint(a) != fingerprint(a.astype(np.float64))
    assert fingerprint(a, bw=0) != fingerprint(a, bw=2)


@pytest.mark.parametrize("bw", [0, 2])
def test_fingerprint_hex_digests_equal_the_reference(bw):
    for x in (dd(40, 1), np.eye(8, dtype=np.float32), band_dd(30, 2, 4), dd(5, 2).astype(np.float64)):
        assert fingerprint(x, bw=bw) == jservice.fingerprint(x, bw=bw)
        assert fingerprint(torch.from_numpy(x), bw=bw) == jservice.fingerprint(x, bw=bw)


def test_deadline_orders_flush_groups(dense_system):
    a, bs = dense_system
    a2 = dd(a.shape[0], 9)
    svc = cpu_service()
    svc.submit(a, bs[0])
    svc.submit(a2, bs[1], deadline=1.0)
    fps = []
    orig = svc._factors_for

    def spy(req, tolerance):
        fps.append(req.fp)
        return orig(req, tolerance)

    svc._factors_for = spy
    svc.flush()
    assert fps == [fingerprint(a2), fingerprint(a)]  # the deadline group factors first


def test_flush_requeues_unprocessed_on_error(dense_system):
    a, bs = dense_system
    a2, a3 = dd(a.shape[0], 21), dd(a.shape[0], 22)
    svc = cpu_service()
    t1, t2, t3 = svc.submit(a, bs[0]), svc.submit(a2, bs[1]), svc.submit(a3, bs[2])
    bad_fp = fingerprint(a2)
    orig = svc._factors_for

    def boom(req, tolerance):
        if req.fp == bad_fp:
            raise RuntimeError("injected factor failure")
        return orig(req, tolerance)

    svc._factors_for = boom
    with pytest.raises(RuntimeError, match="injected factor failure"):
        svc.flush()
    assert svc.pending() == 2
    assert torch.equal(svc.result(t1), ops.lu_solve(ops.lu(t(a)), t(bs[0])))
    svc._factors_for = orig
    results = svc.flush()
    assert set(results) == {t2, t3}
    assert torch.equal(results[t3], ops.lu_solve(ops.lu(t(a3)), t(bs[2])))


def test_solve_convenience_retains_other_results(dense_system):
    a, bs = dense_system
    a2 = dd(a.shape[0], 11)
    svc = cpu_service()
    t_early = svc.submit(a, bs[0])
    x2 = svc.solve(a2, bs[1])
    assert torch.equal(x2, ops.lu_solve(ops.lu(t(a2)), t(bs[1])))
    assert torch.equal(svc.result(t_early), ops.lu_solve(ops.lu(t(a)), t(bs[0])))
    with pytest.raises(KeyError):
        svc.result(t_early)


# ---------------------------------------------------------------------------
# tests/test_faults.py: the service's degradation
# ---------------------------------------------------------------------------
def test_flush_isolates_poisoned_group_end_to_end():
    n1, n2, n3 = 48, 64, 80
    a1, a3 = dd(n1, 11), dd(n3, 13)
    a2 = dd(n2, 12)
    a2[0, 0] = np.nan
    b1, b2, b3 = rhs(n1, 111), rhs(n2, 112), rhs(n3, 113)

    undisturbed = cpu_service()
    ref1, ref3 = undisturbed.solve(a1, b1), undisturbed.solve(a3, b3)

    def run(svc):
        tickets = (svc.submit(a1, b1), svc.submit(a2, b2), svc.submit(a2, b2 * 2.0),
                   svc.submit(a3, b3))
        return tickets, svc.flush()

    svc, jsvc, ((t1, t2a, t2b, t3), res), (_, jres) = both(run)
    for tk in (t2a, t2b):
        assert isinstance(res[tk], solvers.SolveFailure)
        assert [c["backend"] for c in res[tk].chain] == [
            "cuda_fused", "torch", "cuda_vmem", "pivoted", "cuda_blocked"]
    assert torch.equal(res[t1], ref1) and torch.equal(res[t3], ref3)
    assert fingerprint(a2) not in svc._lru
    assert fingerprint(a2) in svc.quarantined_fingerprints()
    assert svc.stats.failed_requests == 2 and svc.stats.escalations > 0
    same_stats(svc, jsvc)
    solvers.clear_demotions()
    with solvers.record_escalations() as esc:
        t5 = svc.submit(a1, b1)
        res2 = svc.flush()
    assert not esc
    assert torch.equal(res2[t5], ref1)


# the reference's backend names and the port's counterparts
PORT_NAME = {"pallas_fused": "cuda_fused", "pallas_vmem": "cuda_vmem", "pallas_blocked": "cuda_blocked",
             "pallas_tiled": "cuda_tiled", "pallas_scalar": "cuda_scalar", "xla": "torch",
             "xla_scalar": "torch_scalar", "pivoted": "pivoted"}


def test_flush_isolates_poisoned_band_group_like_the_reference():
    """A NaN band fails every band factor's screen: its chain is the
    reference's name for name (the scalar kernel included), its tickets
    fail, it is quarantined, and its flush-mates answer as alone."""
    n, bw = 96, 3
    good, bad = band_dd(n, bw, 21), band_dd(n, bw, 22)
    bad[5, bw] = np.nan
    a = dd(48, 23)
    bg, bb, bd = rhs(n, 121), rhs(n, 122), rhs(48, 123)
    undisturbed = cpu_service()
    ref_good, ref_dense = undisturbed.solve(good, bg, bw=bw), undisturbed.solve(a, bd)

    def run(svc):
        tickets = (svc.submit(good, bg, bw=bw), svc.submit(bad, bb, bw=bw), svc.submit(a, bd))
        return tickets, svc.flush()

    svc, jsvc, ((tg, tb, td), res), ((_, jtb, _), jres) = both(run)
    assert isinstance(res[tb], solvers.SolveFailure) and isinstance(jres[jtb], jsolvers.SolveFailure)
    chain = [c["backend"] for c in res[tb].chain]
    assert chain == [PORT_NAME[c["backend"]] for c in jres[jtb].chain]
    assert chain == ["cuda_blocked", "cuda_tiled", "torch", "cuda_scalar", "torch_scalar"]
    assert torch.equal(res[tg], ref_good) and torch.equal(res[td], ref_dense)
    assert fingerprint(bad, bw=bw) in svc.quarantined_fingerprints()
    same_stats(svc, jsvc)


def test_quarantine_short_circuits_and_expires():
    n = 64
    bad = dd(n, 14)
    bad[0, 0] = np.nan
    b = rhs(n, 114)
    svc = cpu_service(quarantine_ttl=2)
    tk = svc.submit(bad, b)
    first = svc.flush()[tk]
    assert isinstance(first, solvers.SolveFailure)
    fd = svc.stats.factor_dispatches
    t2 = svc.submit(bad, b)
    again = svc.flush()[t2]
    assert again is first and svc.stats.factor_dispatches == fd
    assert svc.stats.quarantined == 1
    svc.flush()
    assert fingerprint(bad) in svc.quarantined_fingerprints()
    svc.flush()
    assert fingerprint(bad) not in svc.quarantined_fingerprints()


def test_deadline_shedding_with_clock():
    now = [0.0]
    svc = cpu_service(clock=lambda: now[0])
    a, b = dd(48, 15), rhs(48, 115)
    t_late = svc.submit(a, b, deadline=1.0)
    t_fine = svc.submit(a, b * 2.0, deadline=100.0)
    now[0] = 10.0
    res = svc.flush()
    assert isinstance(res[t_late], DeadlineMiss)
    assert (res[t_late].deadline, res[t_late].now) == (1.0, 10.0)
    assert not isinstance(res[t_fine], DeadlineMiss)
    assert svc.stats.shed_deadline == 1
    svc2 = cpu_service()
    tk = svc2.submit(a, b, deadline=1.0)
    assert not isinstance(svc2.flush()[tk], DeadlineMiss)


def test_result_distinguishes_unknown_and_unflushed():
    svc = cpu_service()
    tk = svc.submit(dd(32, 16), rhs(32, 116))
    with pytest.raises(NotFlushed):
        svc.result(tk)
    svc.flush()
    svc.result(tk)
    with pytest.raises(UnknownTicket):
        svc.result(tk)
    with pytest.raises(UnknownTicket):
        svc.result(10_000)
    assert issubclass(UnknownTicket, KeyError) and issubclass(NotFlushed, KeyError)


def test_solve_raises_terminal_failure():
    bad = dd(48, 17)
    bad[0, 0] = np.nan
    with pytest.raises(solvers.SolveFailure):
        cpu_service().solve(bad, rhs(48, 117))


def test_slow_dispatch_fault_trips_deadline_on_reflush():
    svc = cpu_service(clock=time.monotonic)
    a, b = dd(48, 18), rhs(48, 118)
    with solvers.inject(slow_dispatch_us=50_000, op="factor"):
        t1 = svc.submit(a, b, deadline=time.monotonic() + 1000.0)
        svc.flush()
    t2 = svc.submit(a, b * 3.0, deadline=time.monotonic() - 1.0)
    assert isinstance(svc.flush()[t2], DeadlineMiss)
    svc.result(t1)


def test_serve_quarantine_on_injected_solve_fault():
    n = 96
    a, b = dd(n, 19), rhs(n, 119)
    svc = cpu_service()
    with solvers.inject(backend_raises=True, op="solve"):
        tk = svc.submit(a, b)
        res = svc.flush()
    assert isinstance(res[tk], solvers.SolveFailure)
    assert fingerprint(a) in svc.quarantined_fingerprints()


def test_verify_residual_gates_every_coalesced_answer():
    a, b = dd(64, 20), rhs(64, 120, m=3)
    svc = cpu_service(verify_residual=True)
    x = svc.solve(a, b)
    assert float(relative_residual(t(a), t(b), x)) <= solvers.VERIFY_RESIDUAL_DEFAULT_BOUND
    bad = dd(64, 21)
    bad[0, 0] = 0.0  # pivoted serves it; its answer passes the gate as well
    x2 = svc.solve(bad, b)
    assert float(relative_residual(t(bad), t(b), x2)) <= solvers.VERIFY_RESIDUAL_DEFAULT_BOUND


# ---------------------------------------------------------------------------
# what the port adds: devices, the mesh refusal, tensors as operands
# ---------------------------------------------------------------------------
def test_numpy_operands_go_to_the_service_device_and_tensors_stay(monkeypatch):
    a, b = dd(32, 22), rhs(32, 122)
    svc = cpu_service()
    x = svc.solve(a, b)
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert torch.equal(cpu_service().solve(t(a), t(b)), x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolveService().submit(a, b)  # the card by default
    SolveService().submit(t(a), t(b))  # a tensor stays where it lies


def test_mesh_raises_naming_the_multi_device_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        SolveService(mesh=object())


def test_rank_tier_request_is_cached_and_polished():
    rng = np.random.default_rng(23)
    n, k = 96, 12
    a = (rng.standard_normal((n, k)) @ rng.standard_normal((k, n)) / k).astype(np.float32)
    bs = [(a @ rng.standard_normal(n)).astype(np.float32) for _ in range(3)]
    svc = cpu_service()
    tickets = [svc.submit(a, b, rank=k, tolerance=1e-3) for b in bs]
    res = svc.flush()
    assert sorted(svc._lru[fingerprint(a)]) == [1e-3]
    assert svc.stats.approx_solves == 1 and svc.stats.last_refine_iterations is not None
    for tk, b in zip(tickets, bs):
        assert float(relative_residual(t(a), t(b), res[tk])) <= 1e-3
