"""The legacy dense kernels of the port (B14-B17: ``update``, ``fused_step``,
``panel``, ``lu_vmem``), their driver behind ``ops.lu(impl="cuda_blocked")``
and the escalation funnel they complete, against the JAX package.

On the CPU each kernel wrapper runs its plain version; the reference's
Pallas kernels run in interpret mode, as its own tests run them.

Tolerances: fp32 on both sides with other summation orders, so packed
factors are held normwise, L (strictly lower) and U (upper) apart, each
against its own largest entry, to ``TOL = 1e-5``; against the float64
oracles in ``kernels/ref.py`` at the reference tests' own tolerances
(``tests/test_kernels.py``).  bf16 results are held to ``BF16_TOL = 2e-2``
normwise (a few bf16 units: both sides round every operation to bf16, in
other orders inside the products).  The escalation chains are compared
name for name under the map ``pallas_fused → cuda_fused``, ``xla →
torch``, ``pallas_vmem → cuda_vmem``, ``pallas_blocked → cuda_blocked``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.kernels import ebv_lu as jk
from repro.kernels import ops as jops
from repro_torch import solvers
from repro_torch.core import ebv
from repro_torch.core.pivoted import PivotedFactors
from repro_torch.kernels import ebv_lu, ops, ref
from repro_torch.solvers import backends

TOL = 1e-5
BF16_TOL = 2e-2


def dd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(port, want, tol=TOL):
    port = np.asarray(torch.as_tensor(port).double() if isinstance(port, torch.Tensor) else port,
                      np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / np.abs(want).max()
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def close_lu(port, want, tol=TOL):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    close(np.tril(port, -1), np.tril(want, -1), tol)
    close(np.triu(port), np.triu(want), tol)


def counterpart(name: str) -> str:
    if name.startswith("pallas_"):
        return "cuda_" + name.removeprefix("pallas_")
    if name.startswith("xla"):
        return "torch" + name.removeprefix("xla")
    return name


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


def tall_panel(m, b, seed):
    """The reference test's panel: a diagonally dominant (m, m) matrix's
    first b columns with a dominant top block."""
    p = dd(m, seed)[:, :b].copy()
    p[:b, :b] = dd(b, 1)
    return p


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels and the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 32, 129, 256])
def test_lu_vmem_matches_the_reference_kernel(n):
    a = dd(n, n)
    got = ebv_lu.lu_vmem(torch.from_numpy(a))
    close_lu(got, np.asarray(jk.lu_vmem(jnp.asarray(a))))
    np.testing.assert_allclose(got.double().numpy(), ref.lu_ref(a), atol=5e-5 * n)


def test_lu_vmem_plain_is_the_unblocked_factor_value_for_value():
    # the masked whole-matrix steps leave every finite entry outside the
    # trailing block as it was, so they give core.ebv.ebv_lu bit for bit
    a = torch.from_numpy(dd(97, 3))
    assert torch.equal(ebv_lu.lu_vmem_plain(a), ebv.ebv_lu(a))
    assert torch.equal(ebv_lu.lu_vmem(a), ebv_lu.lu_vmem_plain(a))


@pytest.mark.parametrize("m,b", [(32, 8), (64, 64), (96, 32), (128, 16)])
def test_panel_matches_the_reference_kernel(m, b):
    p = tall_panel(m, b, m + b)
    got = ebv_lu.panel(torch.from_numpy(p))
    close_lu(got, np.asarray(jk.panel(jnp.asarray(p))))
    np.testing.assert_allclose(got.double().numpy(), ref.panel_ref(p), atol=1e-3)


@pytest.mark.parametrize("m,b,w,ct", [(64, 16, 48, 16), (128, 32, 96, 32)])
def test_fused_step_matches_the_reference_kernel(m, b, w, ct):
    pan = np.array(jk.panel(jnp.asarray(tall_panel(m, b, m + w))))
    top, trail = normal((b, w), 4), normal((m - b, w), 5)
    u12, new = ebv_lu.fused_step(torch.from_numpy(pan), torch.from_numpy(top),
                                 torch.from_numpy(trail), col_tile=ct)
    ju12, jnew = jk.fused_step(jnp.asarray(pan), jnp.asarray(top), jnp.asarray(trail), col_tile=ct)
    close(u12, np.asarray(ju12))
    close(new, np.asarray(jnew))
    want_u12, want_new = ref.fused_step_ref(pan, top, trail)
    np.testing.assert_allclose(u12.double().numpy(), want_u12, atol=1e-3)
    np.testing.assert_allclose(new.double().numpy(), want_new, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_the_reference_kernel(dtype):
    m, b, w = 128, 32, 64
    l21, u12, a22 = normal((m, b), 6), normal((b, w), 7), normal((m, w), 8)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    # the bf16 inputs are the same values in both frameworks: round once in jax
    jl, ju, ja = (jnp.asarray(x).astype(jdt) for x in (l21, u12, a22))
    tl, tu, ta = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt) for x in (jl, ju, ja))
    got = ebv_lu.update(tl, tu, ta, row_tile=64, col_tile=32)
    assert got.dtype == tdt
    want = np.asarray(jk.update(jl, ju, ja, row_tile=64, col_tile=32).astype(jnp.float32))
    close(got.float(), want, TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_allclose(got.double().numpy(), ref.update_ref(
        np.asarray(jl.astype(jnp.float32)), np.asarray(ju.astype(jnp.float32)),
        np.asarray(ja.astype(jnp.float32))), atol=1e-4 if dtype == "float32" else 0.5)


def test_bf16_panel_rounds_every_operation_like_the_reference():
    p = tall_panel(64, 16, 9)
    jp = jnp.asarray(p).astype(jnp.bfloat16)
    tp = torch.from_numpy(np.array(jp.astype(jnp.float32))).to(torch.bfloat16)
    got = ebv_lu.panel(tp)
    assert got.dtype == torch.bfloat16
    close_lu(got.float().numpy(), np.asarray(jk.panel(jp).astype(jnp.float32)), BF16_TOL)


# ---------------------------------------------------------------------------
# the forced legacy impls through ops.lu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [64, 100, 128])
@pytest.mark.parametrize("impl", ["cuda_vmem", "cuda_blocked"])
def test_forced_legacy_impls_match_the_reference(impl, n):
    a = dd(n, n + 11)
    jimpl = {"cuda_vmem": "pallas_vmem", "cuda_blocked": "pallas_blocked"}[impl]
    with solvers.record_dispatches() as log:
        f = ops.lu(torch.from_numpy(a), impl=impl, block=32, col_tile=32)
    assert [name for _, name in log] == [impl]
    want = np.asarray(jops.lu(jnp.asarray(a), impl=jimpl, block=32, col_tile=32))
    close_lu(f.packed, want)
    np.testing.assert_allclose(f.packed.double().numpy(), ref.lu_ref(a), atol=5e-3)


@pytest.mark.parametrize("n,block,ct", [(64, 16, 16), (128, 32, 32), (128, 64, 16), (96, 32, 32)])
def test_blocked_driver_sweep_matches_the_reference(n, block, ct):
    # tests/test_kernels.py's pallas_blocked sweep
    a = dd(n, n + block + ct)
    got = ops.lu(torch.from_numpy(a), impl="cuda_blocked", block=block, col_tile=ct).packed
    close_lu(got, np.asarray(jops.lu(jnp.asarray(a), impl="pallas_blocked", block=block, col_tile=ct)))
    np.testing.assert_allclose(got.double().numpy(), ref.lu_ref(a), atol=5e-3)


def test_blocked_driver_and_the_plain_factor_agree():
    # tests/test_kernels.py's pallas-vs-xla check, here cuda_blocked vs torch
    a = torch.from_numpy(dd(128, 11))
    close_lu(ops.lu(a, impl="cuda_blocked", block=32, col_tile=32).packed,
             ops.lu(a, impl="torch", block=32).packed.numpy())


def test_blocked_driver_pads_an_odd_width_and_launches_2s_minus_1(monkeypatch):
    # n = 100, block 32: trailing widths 68 and 36 are no multiple of the
    # 32-column tile and pad to 96 and 64; the last, 4, is its own tile
    calls = []
    for name in ("panel", "fused_step"):
        real = getattr(ebv_lu, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, tuple(args[1].shape) if _name == "fused_step" else args[0].shape[1]))
            return _real(*args, **kw)

        monkeypatch.setattr(ebv_lu, name, spy)
    a = torch.from_numpy(dd(100, 12))
    got = ops.lu(a, impl="cuda_blocked", block=32, col_tile=32).packed
    assert [c[0] for c in calls] == ["panel", "fused_step"] * 3 + ["panel"]
    # 2S - 1 calls; on the card a fused step is two launches (solve, product)
    assert len(calls) == 7 and backends.blocked_launches(100, 32) == 4 + 2 * 3
    assert [c[1] for c in calls if c[0] == "fused_step"] == [(32, 96), (32, 64), (32, 4)]
    close_lu(got, ref.lu_ref(dd(100, 12)), 1e-5)


def test_blocked_driver_in_bf16_matches_the_reference():
    a = dd(64, 13)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(torch.bfloat16)
    with solvers.record_dispatches() as log:
        got = ops.lu(ta, impl="cuda_blocked", block=32, col_tile=32).packed
    assert log[0][0].dtype == "bfloat16" and got.dtype == torch.bfloat16
    want = np.asarray(jops.lu(ja, impl="pallas_blocked", block=32, col_tile=32).astype(jnp.float32))
    close_lu(got.float().numpy(), want, BF16_TOL)


# ---------------------------------------------------------------------------
# the escalation funnel: the chains of the reference, name for name
# ---------------------------------------------------------------------------
def test_nan_operand_chain_equals_the_reference():
    a = dd(64, 14)
    a[0, 0] = np.nan
    with pytest.raises(jsolvers.SolveFailure) as jerr:
        jops.lu(jnp.asarray(a), health=True)
    with pytest.raises(solvers.SolveFailure) as err:
        ops.lu(torch.from_numpy(a), health=True)
    want = [counterpart(c["backend"]) for c in jerr.value.chain]
    got = [c["backend"] for c in err.value.chain]
    assert got == want == ["cuda_fused", "torch", "cuda_vmem", "pivoted", "cuda_blocked"]


def test_zero_pivot_escalations_equal_the_reference():
    a = dd(256, 15)
    a[0, 0] = 0.0
    with jsolvers.record_escalations() as jesc:
        jf, jrec = jops.lu(jnp.asarray(a), health=True)
    with solvers.record_escalations() as esc:
        f, rec = ops.lu(torch.from_numpy(a), health=True)
    assert [(e[1], e[2]) for e in esc] == [(counterpart(e[1]), counterpart(e[2])) for e in jesc]
    assert [(e[1], e[2]) for e in esc] == [("cuda_fused", "torch"), ("torch", "cuda_vmem"),
                                           ("cuda_vmem", "pivoted")]
    assert isinstance(f, PivotedFactors) and rec.verdict() and bool(jrec.verdict())


def test_a_wide_operand_skips_cuda_vmem_like_the_reference():
    # past n = 4096 the unblocked slot is no candidate (the reference's cap,
    # kept), so the funnel's order is the reference's at every n
    for n in (4096, 4097):
        p = solvers.Problem(op="factor", structure="dense", n=n)
        jp = jsolvers.Problem(op="factor", structure="dense", n=n)
        got = [b.name for b in solvers.candidates(p)]
        want = [counterpart(b.name) for b in jsolvers.candidates(jp)
                if b.name not in ("distributed",)]
        assert sorted(got) == sorted(want)
        assert ("cuda_vmem" in got) == (n <= backends.LU_VMEM_MAX_N)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_legacy_slots_take_the_reference_dtypes_the_kernels_support(dtype):
    names = {b.name for b in solvers.candidates(
        solvers.Problem(op="factor", structure="dense", n=64, dtype=dtype))}
    assert ("cuda_vmem" in names) == (dtype == "float32")
    # the reference's driver takes any dtype; the port's kernels fp32 and bf16
    assert ("cuda_blocked" in names) == (dtype != "float64")
    for key in solvers.registry.NOT_PORTED:
        assert key[2] not in ("cuda_vmem", "cuda_blocked", "bf16_ir", "bf16_ir_torch", "rand_lu")


# ---------------------------------------------------------------------------
# the wrappers' contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call,err", [
    (lambda: ebv_lu.lu_vmem(torch.zeros(3, 4)), ValueError),
    (lambda: ebv_lu.lu_vmem(torch.eye(4, dtype=torch.float64)), TypeError),
    (lambda: ebv_lu.panel(torch.zeros(3, 4)), ValueError),
    (lambda: ebv_lu.fused_step(torch.eye(8)[:, :4], torch.zeros(4, 6), torch.zeros(4, 6), col_tile=4),
     ValueError),
    (lambda: ebv_lu.fused_step(torch.eye(8)[:, :4], torch.zeros(4, 6), torch.zeros(3, 6)), ValueError),
    (lambda: ebv_lu.update(torch.zeros(6, 2), torch.zeros(2, 4), torch.zeros(6, 4), row_tile=4),
     ValueError),
    (lambda: ebv_lu.update(torch.zeros(6, 2), torch.zeros(2, 4, dtype=torch.bfloat16),
                           torch.zeros(6, 4)), TypeError),
], ids=["lu_vmem-square", "lu_vmem-dtype", "panel-tall", "fused-tile", "fused-shape",
        "update-tile", "update-dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


def test_wrappers_leave_their_inputs_alone():
    a = torch.from_numpy(dd(40, 16))
    keep = a.clone()
    ebv_lu.lu_vmem(a)
    ebv_lu.panel(a[:, :8])
    ops.lu(a, impl="cuda_blocked", block=16, col_tile=16)
    assert torch.equal(a, keep)
