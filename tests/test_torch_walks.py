"""The launch plans of the unblocked EbV walks, on the CPU.

The legacy factor and panel (B17, B16: ``kernels/ebv_lu.py:lu_vmem`` /
``panel``) and the batched factor's cluster kernel (B9:
``kernels/batched_lu.py:batched_lu_vmem``) own a matrix's rows by the
paper's equalized pairing over the blocks of a grid or the CTAs of a
cluster, and keep the rows above a threshold column resident in shared
memory (``csrc/ebv_walk.cuh``).  The C entries choose the plan; the Python
functions here mirror them (the card tests check that the two agree on the
card), so the rules are held here without a card: every row owned once,
every unit carrying m row-steps, shared memory within one H100 block's
227 KB, clusters of at most 16 CTAs, and the one-block kernels kept where
one block per system fills the card.
"""
import pytest
import torch

from repro_torch.kernels import batched_lu, ebv_lu

SMEM = 232448  # dynamic shared memory one H100 block may use
SMS = 132


# (m, participants): lu_vmem at n = 2, 3, 263, 500, 2000, 4096 (one block
# per SM, at most m // 2), the panel's 8000 rows, and the batched clusters
@pytest.mark.parametrize("m,parts", [(2, 1), (3, 1), (263, 131), (500, 132), (2000, 132), (4096, 132),
                                     (8000, 132), (241, 16), (384, 16), (385, 16), (1024, 16), (256, 4),
                                     (384, 2)])
def test_each_row_is_owned_once_and_each_unit_carries_m_row_steps(m, parts):
    lists = [ebv_lu.owned_rows(c, parts, m) for c in range(parts)]
    assert sorted(r for rows in lists for r in rows) == list(range(1, m))  # row 0 is never updated
    for c, rows in enumerate(lists):
        assert all(x > y for x, y in zip(rows, rows[1:]))  # decreasing: the live rows are a prefix
        for u in range(c, m // 2, parts):  # unit u: row u+1, live u+1 steps; row m-1-u, m-1-u steps
            assert m - 1 - u in rows and u + 1 in rows
            assert (u + 1) + (m - 1 - u) == m
        for t, r in enumerate(rows):
            assert ebv_lu.row_owner(r, parts, m) == (c, t)
    assert max(len(rows) for rows in lists) - min(len(rows) for rows in lists) <= 2


def _bytes_at(m, ncols, parts, elem, theta):
    rows_max = 2 * -(-(m // 2) // parts)
    above = max(sum(r > theta for r in ebv_lu.owned_rows(c, parts, m)) for c in range(parts))
    return -(-(ncols + ebv_lu.WALK_LAG * rows_max) * 4 // 16) * 16 + above * (ncols - theta) * elem


# lu_vmem at odd and even n up to the reference's cap, on each side of the
# resident/streamed split, in fp32 and bf16; the panels of the blocked driver
@pytest.mark.parametrize("m,ncols", [(2, 2), (3, 3), (263, 263), (500, 500), (1001, 1001), (2000, 2000),
                                     (2641, 2641), (2642, 2642), (3698, 3698), (3699, 3699),
                                     (4095, 4095), (4096, 4096), (2000, 256), (8000, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_walk_plan_fits_one_block_and_streams_least(m, ncols, dtype):
    plan = ebv_lu.legacy_walk_plan(m, ncols, dtype)
    elem = 2 if dtype == torch.bfloat16 else 4
    assert plan.parts == max(1, min(SMS, m // 2))
    assert plan.bytes <= SMEM and plan.bytes == _bytes_at(m, ncols, plan.parts, elem, plan.theta)
    if plan.theta > 0:  # the least theta: one column more per resident row would not fit
        assert _bytes_at(m, ncols, plan.parts, elem, plan.theta - 1) > SMEM
    assert 0 < plan.resident <= 1


@pytest.mark.parametrize("n,dtype,theta", [(2000, torch.float32, 0), (2641, torch.float32, 0),
                                           (2642, torch.float32, 1), (4096, torch.float32, 1519),
                                           (3698, torch.bfloat16, 0), (3699, torch.bfloat16, 1),
                                           (4096, torch.bfloat16, 389)])
def test_the_resident_split_of_lu_vmem(n, dtype, theta):
    # up to n = 2641 (fp32) and 3698 (bf16) every row stays in shared memory
    assert ebv_lu.legacy_walk_plan(n, n, dtype).theta == theta


# (B, n) -> (kind, CTAs per system) with the nominal room of 132 // C
# clusters: staged up to n = 240; past it a cluster of the largest power of
# two <= 16 with B x C <= 132, at least 2; one block per system in device
# memory from B = 132 on
PLANS = [((8, 128), ("staged", 1)), ((3, 240), ("staged", 1)), ((200, 240), ("staged", 1)),
         ((1, 241), ("cluster", 16)), ((2, 241), ("cluster", 16)), ((2, 384), ("cluster", 16)),
         ((3, 385), ("cluster", 16)), ((5, 1000), ("cluster", 16)), ((8, 1024), ("cluster", 16)),
         ((9, 1024), ("cluster", 8)), ((32, 256), ("cluster", 4)), ((33, 256), ("cluster", 4)),
         ((34, 384), ("cluster", 2)), ((100, 384), ("cluster", 2)), ((131, 1024), ("cluster", 2)),
         ((132, 384), ("global", 1)), ((133, 384), ("global", 1))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_the_batched_plan(shape, want):
    bsz, n = shape
    plan = batched_lu.batched_lu_plan(bsz, n, SMS)
    assert (plan.kind, plan.ctas) == want
    if plan.kind == "cluster":
        assert 2 <= plan.ctas <= 16 and plan.walk.parts == plan.ctas
        assert plan.walk.bytes <= SMEM
        assert bsz * plan.ctas <= SMS or plan.ctas == 2  # all resident at once, or the smallest cluster
        assert bsz * plan.ctas * 2 > SMS or plan.ctas == 16  # a larger cluster would not fit
    else:
        assert plan.walk is None


# the room an H100 80GB HBM3 reports for the cluster kernel (a cluster stays
# within one GPC): 66 / 30 / 15 / 7 clusters of 2 / 4 / 8 / 16 CTAs
H100_ROOM = {2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("shape,ctas", [((2, 384), 16), ((7, 1024), 16), ((8, 1024), 8), ((15, 1000), 8),
                                        ((16, 385), 4), ((30, 256), 4), ((32, 256), 2), ((66, 384), 2),
                                        ((67, 384), 2)])
def test_the_batched_plan_takes_the_largest_cluster_whose_systems_all_run_at_once(shape, ctas):
    plan = batched_lu.batched_lu_plan(*shape, SMS, H100_ROOM)
    assert (plan.kind, plan.ctas) == ("cluster", ctas)
    assert shape[0] <= H100_ROOM[ctas] or ctas == 2


@pytest.mark.parametrize("bsz", [1, 8, 131, 132, 500])
@pytest.mark.parametrize("n", [1, 64, 240, 241, 384, 1024])
def test_the_batched_plan_keeps_one_block_per_system_where_that_fills_the_card(bsz, n):
    plan = batched_lu.batched_lu_plan(bsz, n, SMS)
    if n <= 240:  # the system fits one block's shared memory
        assert plan == ("staged", 1, None)
    elif bsz >= SMS:
        assert plan == ("global", 1, None)
    else:
        assert plan.kind == "cluster"


def test_the_walk_plans_at_the_main_paths_shapes():
    # the resident shares chip_smoke prints: lu_vmem at the cap, B9 at (8, 1024)
    # on the H100's room (8 clusters of 8) and on the nominal one (16 of 16)
    assert 0.39 < ebv_lu.legacy_walk_plan(4096, 4096).resident < 0.40
    big = batched_lu.batched_lu_plan(8, 1024, SMS, H100_ROOM).walk
    assert (big.parts, big.theta) == (8, 357) and 0.42 < big.resident < 0.43
    big = batched_lu.batched_lu_plan(8, 1024).walk
    assert (big.parts, big.theta) == (16, 79) and 0.85 < big.resident < 0.86
    assert batched_lu.batched_lu_plan(2, 384).walk.theta == 0  # the optimizer's systems: wholly resident
