"""The port's plain factors and solves against the JAX package's on a
non-finite value (faults C10 and C11), and CPU emulations of the card's
non-finite passes (``csrc/nonfinite.cuh``) against those plain versions.

The reference writes every elimination and substitution step as a masked
full-length update, so ``0 * inf`` turns NaN the entries the mask zeroes.
Both sides get the same numpy operands; the JAX kernels run in interpret
mode (or, for the fused factor, through their mirror, which the JAX
package holds to them bitwise).  Rule: NaN, +inf and -inf at the same
positions, the finite entries within 1e-5 normwise (fp32 on both sides,
sums in other orders).

The emulations run the port's plain versions with the spreads switched
off (the live-row loops, whose non-finite pattern the kernels share: the
sums hold the same terms), then the pass the card runs after its kernel,
and hold the result to the plain version's, positions and values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro.core import ebv as jebv
from repro.core import solve as jsolve
from repro.kernels import banded as jband
from repro.kernels import batched_lu as jkbatched
from repro.kernels import ebv_lu as jkebv
from repro.kernels import trsm as jtrsm
from repro_torch.core import banded, batched, blocked, ebv, solve
from repro_torch.kernels import trsm

TOL = 1e-5
POISONS = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}


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


def rhs(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def same_non_finite(port, want, tol=TOL):
    """NaN, inf and -inf where ``want`` has them; the finite entries within
    ``tol`` normwise."""
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape
    for where in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(where(port), where(want))
    fin = np.isfinite(want)
    assert not fin.all()
    if fin.any():
        scale = max(np.abs(want[fin]).max(), 1e-30)
        assert np.abs(port[fin] - want[fin]).max() / scale <= tol


# ---------------------------------------------------------------------------
# C10: the factors
# ---------------------------------------------------------------------------
FACTOR_AT = {"upper": (2, 30), "lower": (30, 2), "diagonal": (20, 20)}


def poisoned_dd(at, value, n=40, seed=1):
    a = dd(n, seed)
    a[at] = value
    return a


@pytest.mark.parametrize("value", POISONS)
@pytest.mark.parametrize("at", FACTOR_AT)
def test_ebv_lu_spreads_nan_as_the_reference(at, value):
    a = poisoned_dd(FACTOR_AT[at], POISONS[value])
    same_non_finite(ebv.ebv_lu(t(a)), jebv.ebv_lu(jnp.asarray(a)))


@pytest.mark.parametrize("value", POISONS)
@pytest.mark.parametrize("at", FACTOR_AT)
def test_fused_blocked_lu_spreads_nan_as_the_reference(at, value):
    a = poisoned_dd(FACTOR_AT[at], POISONS[value])
    same_non_finite(blocked.fused_blocked_lu(t(a), block=16), jblocked.fused_blocked_lu(jnp.asarray(a), block=16))


def test_fused_blocked_lu_counts_as_the_reference_kernel():
    # the counts of the re-anchor's probe: 247 non-finite entries
    a = poisoned_dd((2, 30), np.inf)
    want = np.asarray(jkebv.lu_fused(jnp.asarray(a), block=16))
    got = blocked.fused_blocked_lu(t(a), block=16).numpy()
    same_non_finite(got, want)
    assert int((~np.isfinite(got)).sum()) == 247
    assert int((~np.isfinite(ebv.ebv_lu(t(a)).numpy())).sum()) == 639


@pytest.mark.parametrize("value", POISONS)
def test_batched_ebv_lu_spreads_nan_as_the_reference_kernel(value):
    a = np.stack([dd(24, s) for s in range(3)])
    a[1, 2, 20] = POISONS[value]
    same_non_finite(batched.batched_ebv_lu(t(a)), jkbatched.batched_lu_vmem(jnp.asarray(a)))


@pytest.mark.parametrize("k", [0, 4, 5, 10])
def test_ebv_step_is_the_reference_masked_step(k):
    a, ja = t(poisoned_dd((5, 9), np.inf, n=12)), jnp.asarray(poisoned_dd((5, 9), np.inf, n=12))
    for step in range(k):
        a, ja = ebv.ebv_step(a, step), jebv.ebv_step(ja, step)
    same_non_finite(ebv.ebv_step(a, k), jebv.ebv_step(ja, k))


# ---------------------------------------------------------------------------
# C11: the solves
# ---------------------------------------------------------------------------
SOLVE_AT = {"factor": ("lu", (5, 30)), "b last row": ("b", (39, 1)), "b above": ("b", (11, 0)),
            "factor lower": ("lu", (30, 5))}


@pytest.fixture(scope="module")
def dense_lu():
    return np.asarray(jebv.ebv_lu(jnp.asarray(dd(40, 1))))


def solve_inputs(dense_lu, at, value):
    lu, b = dense_lu.copy(), rhs((40, 3))
    which, idx = SOLVE_AT[at]
    (lu if which == "lu" else b)[idx] = value
    return lu, b


@pytest.mark.parametrize("value", POISONS)
@pytest.mark.parametrize("at", SOLVE_AT)
def test_lu_solve_and_solve_vmem_spread_nan_as_the_reference(dense_lu, at, value):
    lu, b = solve_inputs(dense_lu, at, POISONS[value])
    want = np.asarray(jsolve.lu_solve(jnp.asarray(lu), jnp.asarray(b)))
    same_non_finite(solve.lu_solve(t(lu), t(b)), want)
    same_non_finite(trsm.solve_vmem_plain(t(lu), t(b)), jtrsm.solve_vmem(jnp.asarray(lu), jnp.asarray(b)))


@pytest.mark.parametrize("value", POISONS)
@pytest.mark.parametrize("at", SOLVE_AT)
def test_solve_tiled_spreads_nan_as_the_reference(dense_lu, at, value):
    lu, b = solve_inputs(dense_lu, at, POISONS[value])
    want = np.asarray(jtrsm.solve_tiled(jnp.asarray(lu), jnp.asarray(b), block=16))
    same_non_finite(trsm.solve_tiled_plain(t(lu), t(b), block=16), want)


@pytest.mark.parametrize("value", POISONS)
@pytest.mark.parametrize("at", SOLVE_AT)
def test_batched_lu_solve_spreads_nan_as_the_reference_kernel(dense_lu, at, value):
    lu, b = solve_inputs(dense_lu, at, POISONS[value])
    lus, bs = np.stack([lu, dense_lu]), np.stack([b, rhs((40, 3), 4)])
    want = jkbatched.batched_lu_solve_vmem(jnp.asarray(lus), jnp.asarray(bs))
    same_non_finite(batched.batched_lu_solve(t(lus), t(bs)), want)


def test_the_re_anchor_counts_of_the_solves(dense_lu):
    lu, b = solve_inputs(dense_lu, "factor", np.nan)
    assert int(np.isnan(solve.lu_solve(t(lu), t(b)).numpy()).sum()) == 120
    assert int(np.isnan(trsm.solve_tiled_plain(t(lu), t(b), block=16).numpy()).sum()) == 48


BAND_AT = {"upper inf": ((10, 6), np.inf), "lower nan": ((40, 2), np.nan), "pivot nan": ((60, 5), np.nan), "lower -inf": ((70, 4), -np.inf)}


@pytest.fixture(scope="module")
def band_lu():
    return np.asarray(jband.banded_lu_blocked(jnp.asarray(band_dd(97, 5, 4)), bw=5, block=32))


@pytest.mark.parametrize("at", BAND_AT)
def test_band_solve_spreads_nan_as_the_reference_kernel(band_lu, at):
    lu, b = band_lu.copy(), rhs((97, 2))
    idx, value = BAND_AT[at]
    lu[idx] = value
    want = jband.banded_solve_kernelized(jnp.asarray(lu), jnp.asarray(b), bw=5)
    same_non_finite(banded.banded_solve_blocked(t(lu), t(b), bw=5), want)


@pytest.mark.parametrize("value", POISONS)
def test_batched_band_solve_spreads_nan_as_the_reference_kernel(band_lu, value):
    lu = np.stack([band_lu, band_lu])
    b = np.stack([rhs((97, 2)), rhs((97, 2), 5)])
    lu[0, 10, 6] = POISONS[value]
    b[1, 96, 0] = POISONS[value]
    want = jband.batched_banded_solve_vmem(jnp.asarray(lu), jnp.asarray(b), bw=5)
    got = banded.banded_solve_blocked(t(lu), t(b), bw=5)
    same_non_finite(got, want)
    assert int((~np.isfinite(got.numpy()[0])).sum()) == 32


# ---------------------------------------------------------------------------
# the card's passes, emulated: each on the live-row result equals the plain
# version
# ---------------------------------------------------------------------------
def _live_diag_strip(dblk, j):
    d = dblk.clone()
    for k in range(d.shape[1]):
        p = j + k
        d[p + 1:, k] /= d[p, k]
        d[p + 1:, k + 1:] -= d[p + 1:, k:k + 1] * d[p:p + 1, k + 1:]
    return d


def switch_spreads_off(mp):
    """The plain versions with their spreads off: what the live-row loops,
    and the kernels, compute."""
    for mod in (solve, batched, blocked, ebv):
        for name in ("nan_above_last", "nan_below_first", "nan_left_of_last", "lu_spread"):
            if hasattr(mod, name):
                mp.setattr(mod, name, lambda y, *args: y)
    mp.setattr(blocked, "factor_diag_strip", _live_diag_strip)


def solve_fill(x, H):
    """``solve_fill_kernel``: per column whose row 0 is not finite, NaN at
    the rows up to the end of the H-row strip that holds its last
    non-finite row.  The live result's non-finite rows are a prefix of each
    column (checked here), so row 0 finite means none."""
    x = x.clone()
    bad = ~torch.isfinite(x)
    for idx in np.ndindex(*x.shape[:-2], x.shape[-1]):
        *lead, c = idx
        col = bad[(*lead, slice(None), c)]
        rows = torch.nonzero(col).flatten()
        assert not len(rows) or bool(col[:int(rows[-1]) + 1].all())
        if bool(col[0]):
            end = min(x.shape[-2], (int(rows[-1]) // H + 1) * H)
            x[(*lead, slice(0, end), c)] = float("nan")
    return x


def same_exactly(got, want):
    got, want = got.numpy(), want.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.where(np.isnan(want), 0, got), np.where(np.isnan(want), 0, want))


def random_poisons(rng, shape, count):
    return [(tuple(int(rng.integers(s)) for s in shape), [np.nan, np.inf, -np.inf][rng.integers(3)])
            for _ in range(count)]


@pytest.mark.parametrize("seed", range(6))
def test_the_dense_solve_pass_gives_the_plain_pattern(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n, m = [(40, 3), (97, 2), (130, 1)][seed % 3]
    lu = ebv.ebv_lu(t(dd(n, seed)))
    b = t(rhs((n, m), seed))
    for idx, v in random_poisons(rng, (n, n), 1):
        lu[idx] = v
    for idx, v in random_poisons(rng, (n, m), seed % 2):
        b[idx] = v
    lus, bs = torch.stack([lu, ebv.ebv_lu(t(dd(n, seed + 1)))]), torch.stack([b, b])
    want = solve.lu_solve(lu, b)
    want_batched = batched.batched_lu_solve(lus, bs)
    tiled = {blk: trsm.solve_tiled_plain(lu, b, block=blk) for blk in (16, 32)}
    with monkeypatch.context() as mp:
        switch_spreads_off(mp)
        live_x = solve.lu_solve(lu, b)
        live_batched = batched.batched_lu_solve(lus, bs)
        live_tiled = {blk: trsm.solve_tiled_plain(lu, b, block=blk) for blk in tiled}
    same_exactly(solve_fill(live_x, n), want)
    same_exactly(solve_fill(live_batched, n), want_batched)
    for blk, x in live_tiled.items():
        same_exactly(solve_fill(x, blk), tiled[blk])


def band_live_solve(lu, b, bw):
    """The band kernels' arithmetic: each row's sum over the band only."""
    n = lu.shape[0]
    x = b.clone()
    for i in range(n):
        for j in range(max(0, i - bw), i):
            x[i] -= lu[i, j - i + bw] * x[j]
    for i in range(n - 1, -1, -1):
        for j in range(i + 1, min(n, i + bw + 1)):
            x[i] -= lu[i, j - i + bw] * x[j]
        x[i] /= lu[i, bw]
    return x


@pytest.mark.parametrize("seed", range(6))
def test_the_band_solve_pass_gives_the_plain_pattern(seed):
    rng = np.random.default_rng(seed)
    n, bw, block = [(97, 5, None), (200, 3, 16), (150, 1, 64)][seed % 3]
    lu = banded.banded_lu_blocked(t(band_dd(n, bw, seed)), bw=bw)
    b = t(rhs((n, 2), seed))
    for idx, v in random_poisons(rng, (n, 2 * bw + 1), 1):
        lu[idx] = v
    for idx, v in random_poisons(rng, (n, 2), seed % 2):
        b[idx] = v
    want = banded.banded_solve_blocked(lu, b, bw=bw, block=block)
    strip = blocked.sub_block_width(banded.band_block_size(n, bw, block))
    got = solve_fill(band_live_solve(lu, b, bw), strip)
    if bool(torch.isfinite(want).all()):  # the poison fell outside the band
        return
    same_non_finite(got, want, 1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_the_batched_factor_pass_gives_the_plain_pattern(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    a = t(np.stack([dd(24, seed + s) for s in range(3)]))
    for idx, v in random_poisons(rng, (3, 24, 24), 2):
        a[idx] = v
    want = batched.batched_ebv_lu(a)
    with monkeypatch.context() as mp:
        switch_spreads_off(mp)
        got = batched.batched_ebv_lu(a)
    # lu_spread_kernel: the last multiplier of a row, the last pivot-row entry of a column
    n = a.shape[-1]
    for s in range(3):
        for r in range(2, n):
            if not bool(torch.isfinite(got[s, r, r - 1])):
                got[s, r, :r - 1] = float("nan")
        for j in range(1, n):
            if not bool(torch.isfinite(got[s, j - 1, j])):
                got[s, :j, j] = float("nan")
    same_exactly(got, want)


def lu_replay(a, B, C2):
    """``lu_replay_kernel``'s phases on an (n, n) tensor, in place (a row or
    a column the kernel gives a thread is a vector here, a phase between two
    grid barriers one statement or loop): it mirrors
    ``core/blocked.py:fused_lu_steps``' blocking, so it gives the plain
    pattern only while the two agree."""
    n = a.shape[0]
    if bool(torch.isfinite(torch.diagonal(a)).all()):
        return a
    nan, isnan = float("nan"), torch.isnan

    def trsm_columns(r0, re, cl, ch):  # replay_trsm_column on columns [cl, ch)
        for k in range(min(C2 - 1, n - r0)):
            q = r0 + k
            u = a[q, cl:ch].clone()
            a[q + 1:re, cl:ch] = a[q + 1:re, cl:ch].masked_fill(isnan(u)[None, :] | isnan(a[q + 1:re, q:q + 1]),
                                                              nan)
            a[r0:q + 1, cl:ch] = a[r0:q + 1, cl:ch].masked_fill(~torch.isfinite(u)[None, :], nan)

    def product(rl, rh, cl, ch, kl, kh):
        if rl < rh and cl < ch and kl < kh:
            rf, cf = isnan(a[rl:rh, kl:kh]).any(1), isnan(a[kl:kh, cl:ch]).any(0)
            a[rl:rh, cl:ch] = a[rl:rh, cl:ch].masked_fill(rf[:, None] | cf[None, :], nan)

    def against_pivot(rows, r0, c, sc):
        lb = isnan(a[rows, c]) | isnan(a[c, c])
        a[rows, c] = a[rows, c].masked_fill(lb, nan)
        a[rows, c + 1:sc] = a[rows, c + 1:sc].masked_fill(lb[:, None] | isnan(a[c, c + 1:sc])[None, :], nan)
        a[rows, r0:c] = a[rows, r0:c].masked_fill(~torch.isfinite(a[rows, c:c + 1]), nan)

    S = -(-n // B)
    for s in range(S):
        base, end = s * B, min(s * B + B, n)
        for j in range(0, B, C2):  # the panel, a strip at a time
            r0 = base + j
            if r0 >= n:
                break
            sc, inpanel = min(r0 + C2, n), j + C2 < B
            for c in range(r0, sc):  # block 0: the rows below each pivot, then above it
                against_pivot(slice(c + 1, end), r0, c, sc)
                a[base:c + 1, c + 1:sc] = a[base:c + 1, c + 1:sc].masked_fill(
                    ~torch.isfinite(a[c, c + 1:sc])[None, :], nan)
            if inpanel:
                trsm_columns(r0, sc, r0 + C2, end)
            for c in range(r0, sc):  # the row strips below, a thread a row
                against_pivot(slice(end, n), r0, c, sc)
            if inpanel:
                product(r0 + C2, n, r0 + C2, end, r0, sc)
        if end == n:
            break
        for j in range(0, B, C2):  # the trailing columns, a strip at a time
            r0 = base + j
            if r0 >= n:
                break
            trsm_columns(r0, min(r0 + C2, n), end, n)
            if j + C2 < B:
                product(r0 + C2, end, end, n, r0, min(r0 + C2, n))
        product(end, n, end, n, base, end)
    return a


@pytest.mark.parametrize("n,block", [(40, 16), (45, 16), (70, 50), (100, 32), (129, 64), (33, 256)])
def test_the_fused_factor_replay_gives_the_plain_pattern(n, block, monkeypatch):
    rng = np.random.default_rng(n + block)
    B = blocked.fused_block_size(n, block)
    for case in range(3):
        a = t(dd(n, case))
        extra = [((n // 3, n // 3), 0.0)] if case == 2 else []
        for idx, v in random_poisons(rng, (n, n), 1 + case % 2) + extra:
            a[idx] = v
        want = blocked.fused_blocked_lu(a, block=block)
        with monkeypatch.context() as mp:
            switch_spreads_off(mp)
            got = blocked.fused_blocked_lu(a, block=block)
        same_exactly(lu_replay(got, B, blocked.sub_block_width(B)), want)


_ALL = (1 << 64) - 1


def _bits_above(j):
    return 0 if j >= 63 else (_ALL << (j + 1)) & _ALL


def lu_replay_masks(a, B, C2):
    """``lu_replay_kernel``'s bit-mask path (a strip of at most 64 columns)
    on an (n, n) tensor: each row (or column) of a strip is a NaN mask and a
    non-finite mask, bit j for column (row) r0 + j, as the kernel keeps
    them; the products as in :func:`lu_replay`."""
    a = a.clone()
    n = a.shape[0]
    if bool(torch.isfinite(torch.diagonal(a)).all()):
        return a
    isnan, fin = torch.isnan(a), torch.isfinite(a)

    def masks(vals_nan, vals_fin):
        return (sum(int(v) << j for j, v in enumerate(vals_nan)),
                sum(int(not v) << j for j, v in enumerate(vals_fin)))

    def refresh():
        nonlocal isnan, fin
        isnan, fin = torch.isnan(a), torch.isfinite(a)

    def set_nan(rows, cols):
        a[rows, cols] = float("nan")

    def store(i, r0, nm, column=False):
        for j in range(64):
            if nm >> j & 1:
                set_nan(*((r0 + j, i) if column else (i, r0 + j)))

    def rule(nm, fm, j, pivot_nan, pivot_row, w):  # mask_against_pivots' step j
        if ((nm | pivot_nan) >> j) & 1:
            nm |= ((1 << j) | _bits_above(j)) & ((1 << w) - 1)
        else:
            nm |= pivot_row & _bits_above(j)
        fm |= nm
        if (fm >> j) & 1:
            nm |= (1 << j) - 1
            fm |= (1 << j) - 1
        return nm, fm

    def product(rl, rh, cl, ch, kl, kh):
        if rl < rh and cl < ch and kl < kh:
            rf, cf = torch.isnan(a[rl:rh, kl:kh]).any(1), torch.isnan(a[kl:kh, cl:ch]).any(0)
            a[rl:rh, cl:ch] = a[rl:rh, cl:ch].masked_fill(rf[:, None] | cf[None, :], float("nan"))

    def trsm_columns(r0, w, cols, lo):  # mask_trsm_column
        refresh()
        for col in cols:
            nm, fm = masks(isnan[r0:r0 + w, col], fin[r0:r0 + w, col])
            for k in range(min(C2 - 1, n - r0)):
                un, uf = nm >> k & 1, fm >> k & 1
                nm |= (_bits_above(k) & ((1 << w) - 1)) if un else (lo[k] & _bits_above(k))
                fm |= nm
                if uf:
                    nm |= (1 << (k + 1)) - 1
                    fm |= (1 << (k + 1)) - 1
            store(col, r0, nm, column=True)

    S = -(-n // B)
    for s in range(S):
        base, end = s * B, min(s * B + B, n)
        for j0 in range(0, B, C2):
            r0 = base + j0
            if r0 >= n:
                break
            sc = min(r0 + C2, n)
            w = sc - r0
            refresh()  # mask_diag_strip: block 0, the rows in shared memory
            rows = [list(masks(isnan[r, r0:sc], fin[r, r0:sc])) for r in range(base, end)]
            for j in range(w):
                pr = r0 + j - base
                pn, pf = rows[pr]
                for r in range(pr + 1, end - base):
                    rows[r] = list(rule(rows[r][0], rows[r][1], j, pn, pn, w))
                up = pf & _bits_above(j) & ((1 << w) - 1)
                for r in range(pr + 1):
                    rows[r][0] |= up
                    rows[r][1] |= up
            for r, (nm, _) in enumerate(rows):
                store(base + r, r0, nm)
            refresh()  # strip_masks
            up = [masks(isnan[r0 + t, r0:sc], fin[r0 + t, r0:sc])[0] for t in range(w)]
            lo = [masks(isnan[r0:sc, r0 + k], fin[r0:sc, r0 + k])[0] for k in range(w)]
            if j0 + C2 < B:
                trsm_columns(r0, w, range(r0 + C2, end), lo)
            refresh()
            for i in range(end, n):  # the row strips below
                nm, fm = masks(isnan[i, r0:sc], fin[i, r0:sc])
                for j in range(w):
                    nm, fm = rule(nm, fm, j, up[j], up[j], w)
                store(i, r0, nm)
            if j0 + C2 < B:
                product(r0 + C2, n, r0 + C2, end, r0, sc)
        if end == n:
            break
        for j0 in range(0, B, C2):
            r0 = base + j0
            if r0 >= n:
                break
            sc = min(r0 + C2, n)
            refresh()
            lo = [masks(isnan[r0:sc, r0 + k], fin[r0:sc, r0 + k])[0] for k in range(sc - r0)]
            trsm_columns(r0, sc - r0, range(end, n), lo)
            if j0 + C2 < B:
                product(r0 + C2, end, end, n, r0, sc)
        product(end, n, end, n, base, end)
    return a


@pytest.mark.parametrize("n,block", [(40, 16), (45, 16), (70, 50), (100, 32), (129, 64), (96, 32)])
def test_the_fused_factor_mask_replay_gives_the_plain_pattern(n, block, monkeypatch):
    # the kernel's bit-mask path (C2 <= 64) on the live result gives the
    # plain version's NaN and inf
    rng = np.random.default_rng(n + block)
    B = blocked.fused_block_size(n, block)
    C2 = blocked.sub_block_width(B)
    assert C2 <= 64
    for case in range(3):
        a = t(dd(n, case))
        extra = [((n // 3, n // 3), 0.0)] if case == 2 else []
        for idx, v in random_poisons(rng, (n, n), 1 + case % 2) + extra:
            a[idx] = v
        want = blocked.fused_blocked_lu(a, block=block)
        with monkeypatch.context() as mp:
            switch_spreads_off(mp)
            got = blocked.fused_blocked_lu(a, block=block)
        same_exactly(lu_replay_masks(got, B, C2), want)


def test_a_finite_factor_and_solve_pass_through_the_passes_unchanged():
    a = t(dd(50, 7))
    lu = blocked.fused_blocked_lu(a, block=16)
    assert torch.equal(lu_replay(lu.clone(), 16, 16), lu)
    x = solve.lu_solve(lu, t(rhs((50, 2))))
    assert torch.equal(solve_fill(x, 50), x)


# ---------------------------------------------------------------------------
# C12: one grid axis holds every step of any RHS width
# ---------------------------------------------------------------------------
def test_a_step_grid_past_one_axis_is_refused_before_the_launch():
    # the C entries of solve_tiled / solve_inverted size every step's grid
    # before they launch and report a grid past one axis by this code
    with pytest.raises(ValueError, match="grid axis"):
        trsm._build.check(trsm._build.GRID_PAST_AXIS, "ebv_solve_tiled")
    trsm._build.check(0, "ebv_solve_tiled")  # no error: nothing raised
    assert trsm.solve_tiled.last_grid is None and trsm.solve_inverted.last_grid is None  # no card call yet
