"""The dense slice end to end: ``repro_torch.kernels.ops`` against
``repro.kernels.ops`` on the same numpy operands, state carried across by
``repro_torch.convert``, and the port's isolation from JAX.

Tolerance: normwise ``max|port - ref| <= 1e-5 * max|ref|`` on solutions —
fp32 on both sides, sums in other orders (never bitwise across
frameworks); measured differences at n <= 600 are ~1e-6.
"""
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import convert, solvers
from repro_torch.core import ebv
from repro_torch.core import solve as core_solve
from repro_torch.kernels import ops, ref

TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def dd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def rhs(n, m=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)


def close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / np.abs(want).max()
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def cpu(x):
    return convert.tensor_from_numpy(x, device="cpu")


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    yield
    solvers.invalidate()


@pytest.mark.parametrize("n", [64, 257, 600])
def test_linear_solve_matches_reference_default_path(n):
    a = dd(n, n)
    for m in (None, 3):
        b = rhs(n, m)
        with solvers.record_dispatches() as log:
            x = ops.linear_solve(cpu(a), cpu(b))
        assert [name for _, name in log] == ["cuda_fused", "cuda_vmem"]
        close(x, jops.linear_solve(jnp.asarray(a), jnp.asarray(b)))
        close(x, np.linalg.solve(a.astype(np.float64), b.astype(np.float64)))


@pytest.mark.parametrize("n", [64, 257, 600])
def test_enriched_factor_and_inverted_solve_match_reference(n):
    a, b = dd(n, n + 1), rhs(n, 3, seed=2)
    f = ops.lu(cpu(a), enrich=True)
    jf = jops.lu(jnp.asarray(a), enrich=True)
    assert f.enriched and f.block == jf.block
    close(f.linv, np.asarray(jf.linv))
    with solvers.record_dispatches() as log:
        x = ops.lu_solve(f, cpu(b), impl="cuda_inverted")
    assert [name for _, name in log] == ["cuda_inverted"]
    close(x, jops.lu_solve(jf, jnp.asarray(b), impl="pallas_inverted"))


@pytest.mark.parametrize("enriched", [False, True])
def test_reference_factorization_carried_across_solves_to_reference_answer(enriched):
    n = 300
    a, b = dd(n, 7), rhs(n, 4, seed=3)
    jf = jops.lu(jnp.asarray(a), enrich=enriched)
    want = np.asarray(jops.lu_solve(jf, jnp.asarray(b)))
    f = convert.factorization_from_numpy(
        np.asarray(jf.packed),
        None if jf.linv is None else np.asarray(jf.linv),
        None if jf.uinv is None else np.asarray(jf.uinv),
        block=jf.block, tier=jf.tier, device="cpu")
    assert f.enriched == enriched and f.block == jf.block
    close(ops.lu_solve(f, cpu(b)), want)
    close(ops.lu_solve(f, cpu(b), impl="cuda_inverted"), want)
    close(ops.lu_solve(f, cpu(b)), ref.solve_ref(np.asarray(jf.packed), b))


def test_convert_rejects_half_an_enrichment():
    with pytest.raises(ValueError):
        convert.factorization_from_numpy(np.eye(4, dtype=np.float32), np.eye(4)[None], None,
                                         block=4, device="cpu")


def test_method_auto_and_many_route_through_the_registry():
    a = dd(96, 4)
    bs = [rhs(96, None, 5), rhs(96, 2, 6)]
    with solvers.record_dispatches() as log:
        x = core_solve.linear_solve(cpu(a), cpu(bs[0]), method="auto")
        many = core_solve.linear_solve_many(cpu(a), [cpu(b) for b in bs], method="auto")
    assert [name for _, name in log] == ["cuda_fused", "cuda_vmem"] * 2
    close(x, np.linalg.solve(a.astype(np.float64), bs[0].astype(np.float64)))
    close(many[1], np.linalg.solve(a.astype(np.float64), bs[1].astype(np.float64)))


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ebv.make_diagonally_dominant(0, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.tensor_from_numpy(np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.factorization_from_numpy(np.eye(3, dtype=np.float32), block=3)
    assert ebv.make_diagonally_dominant(0, 8, device="cpu").device.type == "cpu"
    assert convert.tensor_from_numpy(np.ones(3, np.float32), device="cpu").dtype == torch.float32


def test_ops_run_where_the_tensor_lies():
    a = ebv.make_diagonally_dominant(1, 48, device="cpu")
    b = torch.ones(48)
    x = ops.linear_solve(a, b)
    assert x.device.type == "cpu" and x.shape == (48,)
    assert float(torch.linalg.norm(a @ x - b) / torch.linalg.norm(b)) < 1e-5


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys, repro_torch.kernels.ops, repro_torch.kernels.banded, repro_torch.core.banded, "
        "repro_torch.core.factorization, repro_torch.convert, repro_torch.solvers, "
        "repro_torch.kernels.batched_lu, repro_torch.core.batched, repro_torch.train, "
        "repro_torch.train.optimizer, repro_torch.serve, repro_torch.serve.solve_service, "
        "repro_torch.serve.scheduler, repro_torch.core.refine, repro_torch.core.randomized, "
        "repro_torch.configs, repro_torch.models.common, repro_torch.models.blocks, repro_torch.models.moe, "
        "repro_torch.models.lm, repro_torch.kernels.paged_attn, repro_torch.serve.paged, "
        "repro_torch.serve.engine, repro_torch.launch.serve, repro_torch.core.nonfinite, "
        "repro_torch.data, repro_torch.data.pipeline, repro_torch.ckpt, repro_torch.ckpt.manager, "
        "repro_torch.train.loop, repro_torch.train.grad_compress, repro_torch.launch.train; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_)|from repro[ .])")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offending = [f"{f}:{i}" for f in files if f.exists()
                 for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert offending == []
