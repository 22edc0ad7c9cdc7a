"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in interpret mode, as the JAX package's own tests run them.  Both get the
same numpy operands, and the solves get the same (JAX-made) packed LU, so
each comparison isolates one kernel.  Tolerance: normwise
``max|port - ref| <= 1e-5 * max|ref|`` — fp32 on both sides with sums
taken in other orders (nothing is bitwise across frameworks); measured
differences at n <= 600 are ~1e-6.  The float64 oracle anchors both.

Each CUDA kernel is held against its plain version on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.factorization import dense_block_inverses as jdense_block_inverses
from repro.kernels import ebv_lu as jebv_lu
from repro.kernels import trsm as jtrsm
from repro_torch.core.factorization import dense_block_inverses
from repro_torch.kernels import ebv_lu, ref, trsm

TOL = 1e-5
SIZES = [64, 257, 600]  # 600 pads to 672 > 512: the reference's HBM megakernel branch
# every size with a vector and a 3-wide RHS; the 300-wide RHS (more columns
# than one solve_tiled/inverted block holds) at the largest size
CASES = [(n, m) for n in SIZES for m in (None, 3)] + [(600, 300)]


def dd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def rhs(n, m, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if m is None else (n, m)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    if scale == 0.0:  # nothing to scale by (L of a 1 x 1 factor): exactly equal
        assert np.array_equal(port, want)
        return
    err = np.abs(port - want).max() / scale
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def close_lu(port, want, tol=TOL):
    """A packed factor as its L (strictly lower) and U (upper) apart, each
    against its own largest entry: U's diagonal is ~n/2 and L's entries
    ~1/n, so one norm over both would not see L."""
    port, want = np.asarray(port), np.asarray(want)
    close(np.tril(port, -1), np.tril(want, -1), tol)
    close(np.triu(port), np.triu(want), tol)


@pytest.fixture(scope="module")
def factors():
    """Per size: the operand, the JAX kernel's packed LU and the JAX
    package's inverted diagonal blocks of it (numpy)."""
    out = {}
    for n in SIZES:
        a = dd(n, n)
        lu = jebv_lu.lu_fused(jnp.asarray(a))
        linv, uinv = jdense_block_inverses(lu, block=256)
        out[n] = (a, np.asarray(lu), np.asarray(linv), np.asarray(uinv))
    return out


@pytest.mark.parametrize("n", SIZES)
def test_lu_fused_matches_reference_kernel(n, factors):
    a, jlu, _, _ = factors[n]
    lu = ebv_lu.lu_fused(torch.from_numpy(a))
    close_lu(lu, jlu)
    close_lu(lu, ref.lu_ref(a))


@pytest.mark.parametrize("n,m", CASES)
def test_solve_vmem_matches_reference_kernel(n, m, factors):
    _, jlu, jlinv, juinv = factors[n]
    b = rhs(n, m)
    x = trsm.solve_vmem(t(jlu), t(b))
    close(x, jtrsm.solve_vmem(jnp.asarray(jlu), jnp.asarray(b)))
    close(x, ref.solve_ref(jlu, b))


@pytest.mark.parametrize("n,m", CASES)
def test_solve_tiled_matches_reference_kernel(n, m, factors):
    _, jlu, jlinv, juinv = factors[n]
    b = rhs(n, m)
    x = trsm.solve_tiled(t(jlu), t(b))
    close(x, jtrsm.solve_tiled(jnp.asarray(jlu), jnp.asarray(b)))
    close(x, ref.solve_ref(jlu, b))


@pytest.mark.parametrize("n,m", CASES)
def test_solve_inverted_matches_reference_kernel(n, m, factors):
    _, jlu, jlinv, juinv = factors[n]
    b = rhs(n, m)
    linv, uinv = dense_block_inverses(t(jlu), block=256)
    close(linv, jlinv)
    close(uinv, juinv)
    x = trsm.solve_inverted(t(jlu), linv, uinv, t(b))
    close(x, jtrsm.solve_inverted(jnp.asarray(jlu), jnp.asarray(jlinv), jnp.asarray(juinv), jnp.asarray(b)))
    close(x, ref.solve_ref(jlu, b))


def test_wrappers_count_launches_and_not_on_the_cpu():
    wrappers = (ebv_lu.lu_fused, trsm.solve_vmem, trsm.solve_tiled, trsm.solve_inverted)
    for w in wrappers:
        assert isinstance(w.launches, int)
        w.launches = 0
    a = torch.from_numpy(dd(40, 1))
    b = torch.from_numpy(rhs(40, 2))
    lu = ebv_lu.lu_fused(a)
    linv, uinv = dense_block_inverses(lu, block=16)
    trsm.solve_vmem(lu, b)
    trsm.solve_tiled(lu, b, block=16)
    trsm.solve_inverted(lu, linv, uinv, b)
    assert [w.launches for w in wrappers] == [0, 0, 0, 0]  # the plain versions ran


@pytest.mark.parametrize("n", [1, 40])
def test_dense_solves_of_an_empty_rhs_return_it_without_a_launch(n):
    wrappers = (trsm.solve_vmem, trsm.solve_tiled, trsm.solve_inverted)
    before = [w.launches for w in wrappers]
    lu = ebv_lu.lu_fused(torch.from_numpy(dd(n, 2)))
    linv, uinv = dense_block_inverses(lu, block=16)
    b = torch.zeros((n, 0))
    for x in (trsm.solve_vmem(lu, b), trsm.solve_tiled(lu, b, block=16),
              trsm.solve_inverted(lu, linv, uinv, b)):
        assert x.shape == (n, 0) and x.dtype == b.dtype
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("n,block,tiled,inverted", [
    (1, 256, 3, 2), (100, 256, 3, 2), (2049, 128, 35, 66), (2049, 256, 35, 34),
    (8000, 128, 127, 250), (8000, 256, 127, 126)])
def test_solve_launch_counts(n, block, tiled, inverted):
    # solve_tiled: one launch per diagonal step of each sweep (B <= 128),
    # then the non-finite pass;
    # solve_inverted: the inverse product and the retirement per step, no
    # retirement after either sweep's last step
    assert trsm.tiled_launches(n, block) == tiled
    assert trsm.inverted_launches(n, min(block, n)) == inverted


def test_lu_fused_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        ebv_lu.lu_fused(torch.eye(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        ebv_lu.lu_fused(torch.ones(4, 5))


@pytest.mark.parametrize("n", [1, 127, 128, 129])
def test_lu_fused_matches_reference_kernel_at_the_step_edges(n):
    # one element, one partial tile, exactly one tile, one row past a tile
    a = dd(n, n)
    lu = ebv_lu.lu_fused(torch.from_numpy(a))
    close_lu(lu, jebv_lu.lu_fused(jnp.asarray(a)))
    close_lu(lu, ref.lu_ref(a))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_lu_fused_takes_float32_only(dtype):
    # the reference's lu_fused also takes bf16; no dispatch sends it one
    with pytest.raises(TypeError):
        ebv_lu.lu_fused(torch.eye(8, dtype=dtype))


@pytest.mark.parametrize("n,launches", [(1, 1), (128, 2), (129, 5), (257, 9), (2049, 65)])
def test_fused_launches_at_the_step_edges(n, launches):
    # steps of 128 columns (B = 160 at n = 257 steps by 128 too), and the
    # non-finite pass past n = 1
    assert ebv_lu.fused_step_width(n) == min(n, 128)
    assert ebv_lu.fused_launches(n) == launches


@pytest.mark.parametrize("n,block", [(64, 256), (257, 256), (2000, 256), (8000, 256)])
def test_fused_launch_count(n, block):
    # the first diagonal tile, then per step but the last: both panels, the
    # next step's block row and column, the next diagonal tile and the rest
    # of the trailing update (none after the last panels), then the
    # non-finite pass; a step is at most 128 columns (the kernel's register
    # tile), B = 160 at n = 257 included
    S = -(-n // min(block, n, 128))
    assert ebv_lu.fused_launches(n, block) == (4 * S - 4 if S > 1 else 1) + 1


@pytest.mark.parametrize("n,block,width", [
    (243, 256, 128), (255, 256, 128), (600, 50, 48), (300, 30, 28), (200, 6, 4), (200, 2, 4),
    (40, 256, 40), (100, 100, 100), (101, 100, 100), (50, 50, 50)])
def test_fused_step_width_keeps_the_update_aligned(n, block, width):
    # at most 128 columns (the register tile), the whole matrix in one step,
    # else a multiple of 4 (the update's 16-byte copies start at each step's
    # offset); the plain version's halving (B = 121 at n = 243) plays no part
    assert ebv_lu.fused_step_width(n, block) == width
    S = -(-n // width)
    assert ebv_lu.fused_launches(n, block) == (4 * S - 4 if S > 1 else 1) + 1
