"""The operation orders of the fused step's U12 solve B15
(``kernels/ebv_lu.py:fused_step``, ``csrc/legacy_lu.cu:u12_solve_kernel``)
and of the narrow-band factor's warp walk B5
(``kernels/banded.py:banded_lu_blocked``, ``csrc/band_walk.cu``), on the CPU.

Both kernels are held bitwise to their plain versions on the card.  That
rests on each element seeing the plain version's rounded operations in the
plain version's order, however the kernel schedules them.  Here each
schedule is written out in numpy, one rounded operation at a time
(multiply and subtract rounded apart, as ``__fmul_rn``/``__fsub_rn`` do;
in bf16 each result rounded to bf16 as ``rnd<T>`` does):

- B15: a block a tile of 16 columns; strips of 32 pivots, L11's strip
  staged (rows past the panel hold what an earlier strip left, NaN here),
  the strip's 32 x 32 triangle a column at a time, then the rows below
  the strip taking its 32 terms in order; a column holding a non-finite
  value comes out NaN throughout (fault C6: the plain version's masked
  axpys turn such a column NaN, 0 * inf).
- B5: the live rows p .. p+bw on lanes p mod 32, each lane's registers
  holding columns p .. p+bw, shifted a column a pivot, the column entering
  read at the start of the pivot (up to bw = 15 an idle lane gathers its
  next row that way too; wider bands read the entering row whole); the
  band through a
  ring of 4 chunks of 32 rows, each slot tagged with the row it holds and
  whether its copy group has been waited for, so a read of a row the ring
  no longer (or not yet) holds fails.

Each must equal the port's plain version bit for bit (NaN where it has
NaN); the B15 emulation is also held to the JAX reference's Pallas kernel
(``repro.kernels.ebv_lu.fused_step``, interpret mode) to 1e-5 normwise,
since XLA's CPU code may fuse ``y - l*y_k`` into one rounding where
PyTorch rounds twice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ebv_lu as jk
from repro_torch.core import banded as tbanded
from repro_torch.kernels import banded as kband
from repro_torch.kernels import ebv_lu

F32 = np.float32
TOL = 1e-5
STRIP = 32     # pivots a B15 strip (kStrip)
CHUNK, CHUNKS = 32, 4  # B5's ring: rows a copy group, groups in the ring


def rounder(dtype):
    """The rounding of one result to the element type (rnd<T>)."""
    if dtype == "float32":
        return lambda x: np.asarray(x, F32)
    return lambda x: torch.from_numpy(np.asarray(x, F32)).to(torch.bfloat16).float().numpy()


def to_torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# B15: the U12 solve
# ---------------------------------------------------------------------------
def strip_solve_emulation(l11, top, dtype="float32", nan_rule=True):
    """U12 = L11^-1 top as u12_solve_kernel computes it (every tile of
    columns runs the same schedule, so the tiles go side by side);
    ``nan_rule=False``: without the kernel's last pass, which turns a
    column holding a non-finite value NaN."""
    rnd = rounder(dtype)
    b, w = top.shape
    ys = np.asarray(top, F32).copy()
    ls = np.full((max(b, STRIP), STRIP), np.nan, F32)  # what earlier strips left: never read into a result
    with np.errstate(all="ignore"):
        for s0 in range(0, b, STRIP):
            kw = min(STRIP, b - s0)
            ls[:b - s0] = 0.0
            ls[:b - s0, :kw] = l11[s0:, s0:s0 + kw]
            # the strip's triangle, one column a lane, rows past kw zero
            y = np.zeros((STRIP, w), F32)
            y[:kw] = ys[s0:s0 + kw]
            for l in range(STRIP - 1):
                for j in range(l + 1, STRIP):
                    y[j] = rnd(y[j] - rnd(ls[j, l] * y[l]))
            ys[s0:s0 + kw] = y[:kw]
            # the rows below the strip (only below a whole strip), terms in order
            below = ys[s0 + STRIP:]
            for l in range(STRIP if s0 + STRIP < b else 0):
                below[:] = rnd(below - rnd(ls[STRIP:b - s0, l:l + 1] * ys[s0 + l]))
    if nan_rule:
        ys[:, ~np.isfinite(ys).all(axis=0)] = np.nan  # per column: the plain version's NaN rule
    return ys


def fused_inputs(b, w, seed, poison=None):
    """A packed panel (L11 unit lower with entries ~ 1/b, 8 rows of L21)
    and A12; ``poison``: an inf in A12's column 1, or an inf in L11 that
    meets an exact zero of U12 (0 * inf)."""
    rng = np.random.default_rng(seed)
    pan = (rng.uniform(-1.0, 1.0, (b + 8, b)) * (2.0 / max(b, 1))).astype(F32)
    top = rng.standard_normal((b, w)).astype(F32)
    if poison == "a12_inf":
        top[min(2, b - 1), min(1, w - 1)] = np.inf
    elif poison == "l11_zero_times_inf":
        # y_0 = top[0] is final; an inf at L11[1, 0] meets it, and column 0's is 0
        top[0, 0] = 0.0
        pan[1, 0] = np.inf
    return pan, top


def plain_u12(pan, top, dtype):
    b, w = top.shape
    trail = np.zeros((pan.shape[0] - b, w), F32)
    u12, _ = ebv_lu.fused_step_plain(to_torch(pan, dtype), to_torch(top, dtype), to_torch(trail, dtype))
    return u12.float().numpy()


@pytest.mark.parametrize("b,w", [(256, 1792), (256, 64), (100, 33), (7, 5), (1, 3)])
def test_strip_solve_is_bitwise_the_plain_u12(b, w):
    pan, top = fused_inputs(b, w, b + w)
    got = strip_solve_emulation(pan[:b], top)
    want = plain_u12(pan, top, "float32")
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,w", [(100, 33), (7, 5), (64, 20)])
def test_strip_solve_is_bitwise_the_plain_u12_in_bf16(b, w):
    pan, top = fused_inputs(b, w, 3 * b + w)
    rnd = rounder("bfloat16")
    pan, top = rnd(pan), rnd(top)  # the bf16 operands' own values
    got = strip_solve_emulation(pan[:b], top, "bfloat16")
    np.testing.assert_array_equal(got, plain_u12(pan, top, "bfloat16"))


# C6: a U12 column holding a non-finite value is NaN throughout in the
# plain version; with an inf in L11, every column meets it
@pytest.mark.parametrize("poison", ["a12_inf", "l11_zero_times_inf"])
@pytest.mark.parametrize("b,w", [(256, 64), (100, 33), (7, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strip_solve_turns_a_non_finite_column_nan_as_the_plain_version(b, w, poison, dtype):
    pan, top = fused_inputs(b, w, b + 2 * w, poison)
    rnd = rounder(dtype)
    pan, top = rnd(pan), rnd(top)
    got = strip_solve_emulation(pan[:b], top, dtype)
    want = plain_u12(pan, top, dtype)
    np.testing.assert_array_equal(got, want)  # NaN where the plain version has NaN
    col = min(1, w - 1) if poison == "a12_inf" else 0
    nan_cols = np.isnan(want).all(axis=0)
    if poison == "a12_inf":
        assert nan_cols[col] and np.isfinite(np.delete(want, col, axis=1)).all()
    else:
        assert nan_cols.all()
    # the rows-below-only solve leaves the rows above the first non-finite value finite
    assert not np.isnan(strip_solve_emulation(pan[:b], top, dtype, nan_rule=False)[:, col]).all()


@pytest.mark.parametrize("m,b,w,ct", [(64, 16, 48, 16), (160, 40, 33, 33)])
def test_strip_solve_matches_the_reference_kernel(m, b, w, ct):
    rng = np.random.default_rng(m + b)
    p = rng.uniform(-1.0, 1.0, (m, b)).astype(F32)
    p[np.arange(b), np.arange(b)] = np.abs(p[:b]).sum(axis=1) + 1.0
    pan = np.array(jk.panel(jnp.asarray(p)))
    top = rng.standard_normal((b, w)).astype(F32)
    trail = rng.standard_normal((m - b, w)).astype(F32)
    ju12, _ = jk.fused_step(jnp.asarray(pan), jnp.asarray(top), jnp.asarray(trail), col_tile=ct)
    got = strip_solve_emulation(pan[:b], top)
    ju12 = np.asarray(ju12, np.float64)
    assert np.abs(got - ju12).max() / np.abs(ju12).max() <= TOL
    np.testing.assert_array_equal(got, plain_u12(pan, top, "float32"))


# ---------------------------------------------------------------------------
# B5, B11 and B18: the warp walk
# ---------------------------------------------------------------------------
def warp_walk_emulation(arow, bw, window=False):
    """The factor band_lu_warp_kernel<bw, window> writes, with its ring's
    slots tagged by the row each holds.  ``arow`` is one band (n, 2bw+1) or a
    stack (B, n, 2bw+1) (B11): a warp a system, system s walking the band at
    s * n * (2bw+1) floats of the stack.  ``window``: B18's step (fault C7):
    the reach takes a - l * u', u' NaN where another tail entry is not
    finite; a live row whose multiplier or whose pivot row's tail is not
    finite turns NaN the column it reads ahead (its multiplier at every
    later pivot is then not finite either) and its L part left of the
    pivot, by a count a ring slot that the chunk's write-back applies.  What a lane reads from a row past the
    band or from a column outside its row's band is NaN here (the kernel
    reads whatever the slot holds), so such a value reaching the factor
    shows."""
    a = np.asarray(arow, F32)
    stack = a.reshape(-1, *a.shape[-2:])
    n, width = stack.shape[1:]
    flat = stack.reshape(-1).copy()
    for system in range(stack.shape[0]):
        _walk_system(flat, system * n * width, n, bw, window)
    return flat.reshape(a.shape)


def _walk_system(flat, off, n, bw, window):
    """One warp's walk over the band at ``flat[off:]``, in place."""
    width = 2 * bw + 1
    ring_rows = CHUNK * CHUNKS
    preload = 2 * bw <= 31  # a lane gathers its next row a column a pivot while it idles
    ring = np.full((ring_rows, width + 1), np.nan, F32)  # rows padded to 2bw+2
    tag = np.full(ring_rows, -1)
    nan_left = np.zeros(ring_rows, int)  # B18: the slot's row has band entries 0 .. nan_left-1 NaN
    landed = np.zeros(ring_rows, bool)  # the slot's copy group has been waited for
    groups = []  # the copy groups in flight, oldest first: their slots
    chunks = -(-n // CHUNK)

    def band_rows(r0, r1):
        return flat[off + r0 * width:off + r1 * width].reshape(r1 - r0, width)

    def stage(c):
        rows = np.arange(c * CHUNK, min(n, (c + 1) * CHUNK)) if c < chunks else np.arange(0)
        slot = rows % ring_rows
        if rows.size:
            ring[slot, :width] = band_rows(rows[0], rows[-1] + 1)
        tag[slot] = rows
        landed[slot] = False
        groups.append(slot)

    def wait(pending):  # cp.async.wait_group
        while len(groups) > pending:
            landed[groups.pop(0)] = True

    def slots(rows):  # the ring slots of `rows`, which the ring must hold, landed
        slot = np.asarray(rows) % ring_rows
        held = tag[slot] == rows
        assert held.all(), f"row {np.asarray(rows)[~held][0]}'s slot holds another row"
        assert landed[slot].all(), "a row is read before its copy was waited for"
        return slot

    def read(rows, cols):  # band entries (rows, cols), as the lanes read them
        rows, cols = np.broadcast_arrays(rows, cols)
        ok = (rows < n) & (cols >= 0) & (cols < width)
        got = np.full(rows.shape, np.nan, F32)
        got[ok] = ring[slots(rows[ok]), cols[ok]]
        return got

    def write_back(c):
        rows = np.arange(c * CHUNK, min(n, (c + 1) * CHUNK))
        slot = slots(rows)
        band_rows(rows[0], rows[-1] + 1)[:] = np.where(cols[None, :] < nan_left[slot][:, None], np.nan,
                                                       ring[slot, :width])

    def clear_nan_left(c):  # the chunk's slots take new rows
        nan_left[(c * CHUNK + np.arange(32)) % ring_rows] = 0

    lanes = np.arange(32)
    cols = np.arange(width)
    for c in range(CHUNKS):
        stage(c)
        clear_nan_left(c)
    wait(CHUNKS - 2)
    # r[lane, k]: column p+k of the lane's row p + ((lane - p) mod 32)
    r = read(lanes[:, None], np.arange(bw + 1)[None, :] - lanes[:, None] + bw)
    with np.errstate(all="ignore"):
        for p in range(n):
            if p > 0 and p % CHUNK == 0:
                write_back(p // CHUNK - 1)
                clear_nan_left(p // CHUNK - 1)
                stage(p // CHUNK + CHUNKS - 1)
                wait(CHUNKS - 2)
            d = (lanes - p) & 31
            dn = (d - 1) & 31
            i, nxt_row = p + d, p + 1 + dn
            live = (d >= 1) & (d <= bw) & (i < n)
            # the reads for pivot p+1, before pivot p's stores: a column of
            # each lane's next row, and the row entering, read whole by every lane
            nxt = read(nxt_row, 2 * bw - dn)
            enter = None if preload else np.broadcast_to(read(p + 1 + bw, np.arange(bw)), (32, bw))
            pl = p & 31
            piv, u = r[pl, 0], r[pl, 1:].copy()
            bad = ~np.isfinite(u) if window else np.zeros(bw, bool)
            us = np.where(bad.sum() - bad > 0, np.float32(np.nan), u)  # u'
            l = np.where(live, r[:, 0], piv) / piv
            upd = r[:, 1:] - l[:, None] * us[None, :]
            if window:
                hit = live & (bad.any() | ~np.isfinite(l))
                nxt = np.where(hit, np.float32(np.nan), nxt)
                nan_left[i[hit] % ring_rows] = bw - d[hit]
            ring[slots(i[live]), bw - d[live]] = l[live]
            ring[slots(p), bw:2 * bw + 1] = np.concatenate([[piv], u])
            shifted = r[:, 1:] if preload else enter
            r = np.concatenate([np.where(live[:, None], upd, shifted), nxt[:, None]], axis=1).astype(F32)
    if chunks:
        write_back(chunks - 1)


def any_band(n, bw, seed, zero_pivot=False):
    """A diagonally dominant band whose entries outside the matrix are not
    zero (the walk updates those past column n - 1 as the plain version
    does); ``zero_pivot``: the first pivot is 0."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (n, 2 * bw + 1)).astype(F32)
    a[:, bw] = np.abs(a).sum(axis=1) + 1.0
    if zero_pivot:
        a[0, bw] = 0.0
    return a


@pytest.mark.parametrize("n_of", [lambda bw: bw + 1, lambda bw: 2 * bw + 3, lambda bw: 257,
                                  lambda bw: 4000], ids=["bw+1", "2bw+3", "257", "4000"])
@pytest.mark.parametrize("bw", [1, 2, 5, 11, 16, 31])
def test_warp_walk_is_bitwise_the_plain_factor(bw, n_of):
    n = n_of(bw)
    a = any_band(n, bw, 7 * n + bw)
    want = kband.banded_lu_plain(torch.from_numpy(a), bw=bw).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(warp_walk_emulation(a, bw), want)


@pytest.mark.parametrize("n,bw", [(40, 1), (70, 5), (100, 16), (64, 31)])
def test_warp_walk_on_a_zero_pivot_is_the_plain_factor(n, bw):
    a = any_band(n, bw, n + bw, zero_pivot=True)
    want = tbanded.banded_lu_blocked(torch.from_numpy(a), bw=bw).numpy()
    assert not np.isfinite(want).all()
    np.testing.assert_array_equal(warp_walk_emulation(a, bw), want)  # NaN and inf where the plain has them


POISONS = ("any", "zero pivot", "nan pivot", "inf tail", "nan tail", "two infs")


def poisoned_band(n, bw, poison, seed):
    """:func:`any_band` with, but for "any", pivot row k = min(5, n - 2) (a
    row with rows below it) poisoned: its pivot 0 or NaN, an inf or a NaN in
    its upper tail (column k+1 + k mod bw), or "two infs": inf and -inf at
    the tail's two ends (-inf alone where bw = 1)."""
    a = any_band(n, bw, seed, zero_pivot=poison == "zero pivot")
    k = min(5, n - 2)
    at = {"nan pivot": [(bw, np.nan)], "inf tail": [(bw + 1 + k % bw, np.inf)],
          "nan tail": [(bw + 1 + k % bw, np.nan)],
          "two infs": [(bw + 1, np.inf), (2 * bw, -np.inf)]}.get(poison, [])
    for col, value in at:
        a[k, col] = value
    return a


WALK_SIZES = pytest.mark.parametrize(
    "n_of", [lambda bw: bw + 1, lambda bw: 2 * bw + 3, lambda bw: 257, lambda bw: 4000],
    ids=["bw+1", "2bw+3", "257", "4000"])


# B18: the window step (fault C7) against its plain version, NaN and inf
# where the plain version has them and every finite value bit for bit
@WALK_SIZES
@pytest.mark.parametrize("poison", POISONS)
@pytest.mark.parametrize("bw", [1, 2, 5, 11, 16, 31])
def test_warp_walk_window_step_is_bitwise_its_plain_version(bw, poison, n_of):
    n = n_of(bw)
    a = poisoned_band(n, bw, poison, 11 * n + bw)
    want = kband.banded_lu_window_plain(torch.from_numpy(a), bw=bw).numpy()
    assert np.isfinite(want).all() == (poison == "any")
    np.testing.assert_array_equal(warp_walk_emulation(a, bw, window=True), want)


# B11: a warp a system over a stack, each system at its own offset
@WALK_SIZES
@pytest.mark.parametrize("poison", POISONS)
@pytest.mark.parametrize("bw", [1, 2, 5, 11, 16, 31])
def test_warp_walk_over_a_stack_is_bitwise_the_plain_factor(bw, poison, n_of):
    n = n_of(bw)
    a = np.stack([any_band(n, bw, 13 * n + bw), poisoned_band(n, bw, poison, 17 * n + bw)])
    want = kband.banded_lu_plain(torch.from_numpy(a), bw=bw).numpy()
    assert np.isfinite(want).all() == (poison == "any")
    np.testing.assert_array_equal(warp_walk_emulation(a, bw), want)


# C7 is B18's alone: on an inf in a tail B5's walk keeps the entries its
# pivot does not reach, where B18's window step turns them NaN
@pytest.mark.parametrize("bw", [1, 2, 5, 16, 31])
def test_b5_walk_is_not_the_window_step_on_an_inf_tail(bw):
    a = poisoned_band(2 * bw + 40, bw, "inf tail", bw)
    b5, b18 = warp_walk_emulation(a, bw), warp_walk_emulation(a, bw, window=True)
    want = kband.banded_lu_window_plain(torch.from_numpy(a), bw=bw).numpy()
    np.testing.assert_array_equal(b18, want)
    assert np.isnan(want).sum() > np.isnan(b5).sum()
    assert not np.array_equal(np.isnan(b5), np.isnan(want))


@pytest.mark.parametrize("n,bw,want", [
    (16000, 5, "warp walk"), (4, 31, "warp walk"), (16384, 32, "ring walk"), (300, 64, "ring walk"),
    (65536, 169, "ring walk"), (65536, 170, "device-memory walk"), (450, 200, "device-memory walk"),
    (0, 40, "device-memory walk"), (0, 5, "warp walk")])
def test_band_lu_walk_names_the_c_drivers_path(n, bw, want):
    assert kband.band_lu_walk(n, bw) == want
