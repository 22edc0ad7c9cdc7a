"""The launch plan of the dense solve B2 (``kernels/trsm.py:solve_vmem``),
on the CPU.

One cooperative launch of at most one block per SM: block r owns the
contiguous rows r R .. r R + R - 1 of the packed factor for the whole
launch, their columns [theta, n) resident in shared memory (with a copy
of a streamed diagonal tile where it fits), and the RHS goes in equal
groups of columns that sit beside them (``csrc/trsm.cu:ebv_solve_vmem``).  The wrapper passes
``solve_vmem_plan``'s choice to the C entry (the card tests check that the
entry launched it), so the rules are held here without a card.
"""
import pytest

from repro_torch.kernels import trsm

SMEM = 232448  # dynamic shared memory one H100 block may use
THREADS, OUTPUTS = 512, 8  # a block's threads and the outputs one accumulates (kVThreads, kVOut)


def resident_bytes(n, rows, group, theta, copy):
    """A block's shared memory: its rows' columns [theta, n) at a stride of
    a multiple of 32 floats plus 4, a copy of the diagonal tile where
    ``copy``, the rows' reciprocal pivots and, past 32 rows, the group's
    RHS rows and two handed-over row blocks' values."""
    nr = n - theta
    ld = -(-nr // 32) * 32 + 4 if nr > 0 else 0
    return 4 * rows * (ld + (rows if copy else 0) + 1 + (0 if rows <= 32 else 3 * group))


# n up to 40000: past R of about 240 rows (n = 31549 on 132 SMs) even a
# block with nothing resident has no room for a copy of its diagonal tile
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", [1, 8, 64, 300])
@pytest.mark.parametrize("n", [1, 2, 31, 500, 1000, 2000, 2048, 4000, 8000, 30000, 40000])
def test_solve_vmem_plan_owns_every_row_once_within_the_card(n, m, sms):
    plan = trsm.solve_vmem_plan(n, m, sms, SMEM)
    # every row owned once, in contiguous blocks of R rows, the last one not empty
    owned = [i for r in range(plan.blocks) for i in range(r * plan.rows, min(n, (r + 1) * plan.rows))]
    assert owned == list(range(n))
    assert (plan.blocks - 1) * plan.rows < n <= plan.blocks * plan.rows
    assert plan.blocks <= sms  # about one block per SM, never more: the launch is cooperative
    # the RHS in equal groups, each within what a block's threads accumulate
    groups = -(-m // plan.group)
    assert 1 <= plan.group <= m and groups * plan.group - m < groups
    if plan.rows <= 32:  # a warp per 4 columns of a group
        assert plan.group <= 4 * THREADS // 32
    else:
        assert plan.group * -(-plan.rows // OUTPUTS) <= THREADS
    # the resident bytes fit a block; theta is the least multiple of R that
    # fits, at most the first at or past n (nothing resident)
    assert plan.theta % plan.rows == 0 and plan.theta < n + plan.rows
    assert plan.bytes == resident_bytes(n, plan.rows, plan.group, plan.theta, plan.copy) <= SMEM
    if plan.theta > 0:  # streamed only where the rows do not fit
        assert resident_bytes(n, plan.rows, plan.group, 0, False) > SMEM
        assert resident_bytes(n, plan.rows, plan.group, plan.theta - plan.rows, plan.copy) > SMEM
    # a streamed diagonal tile is copied unless no theta leaves room for it
    assert not plan.copy or plan.theta > 0
    if plan.theta > 0 and not plan.copy:
        assert resident_bytes(n, plan.rows, plan.group, -(-n // plan.rows) * plan.rows, True) > SMEM
    assert plan.resident == max(0, n - plan.theta) / n


# (n, m) -> (blocks, R, theta, copy): one warp's 32 rows a block up to
# n = 4224, every row resident up to n = 1792 at any RHS width; past that
# the leftmost columns, which the forward sweep consumes first, stream (256
# of n = 2000's, 13 %) and a streamed diagonal tile is copied; past 132
# blocks, R = ceil(n / 132) and the wide path; from about 240 rows a block
# (n = 30000 at m = 64, 31549 at m = 1) no room for that copy
@pytest.mark.parametrize("n,m,want", [(500, 1, (16, 32, 0, False)), (1024, 8, (32, 32, 0, False)),
                                      (2000, 1, (63, 32, 256, True)), (2048, 64, (64, 32, 288, True)),
                                      (4000, 1, (125, 32, 2240, True)), (8000, 64, (132, 61, 7381, True)),
                                      (30000, 1, (132, 228, 30096, True)), (30000, 64, (132, 228, 29868, False)),
                                      (31549, 1, (132, 240, 31440, False)), (40000, 1, (132, 304, 40128, False)),
                                      (40000, 64, (132, 304, 40128, False))])
def test_the_dense_solve_plan_at_the_paths_sizes(n, m, want):
    plan = trsm.solve_vmem_plan(n, m)
    assert (plan.blocks, plan.rows, plan.theta, plan.copy) == want
    assert (plan.resident == 1.0) == (plan.theta == 0)


# R past 4096 rows: more outputs than a block's threads hold, refused
# rather than launched (n = 5000 on one SM; on 132 SMs n past 540672)
def test_solve_vmem_plan_refuses_rows_no_block_holds():
    with pytest.raises(ValueError, match="rows a block"):
        trsm.solve_vmem_plan(5000, 1, 1)
