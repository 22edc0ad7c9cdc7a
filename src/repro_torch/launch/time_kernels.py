"""Time the dense factor B1 (``kernels/ebv_lu.py:lu_fused``) and the rank-k
update B14 (``kernels/ebv_lu.py:update``) on the card, beside their library
calls (``torch.linalg.lu_factor(pivot=False)``, ``torch.addmm``), the
dense solve B2 (``kernels/trsm.py:solve_vmem``) against the fewest rows a
block its plan takes (``trsm.VMEM_MIN_ROWS``, 32; 1 gives one block per SM),
the batched solve B10 (``kernels/batched_lu.py:batched_lu_solve_vmem``) on
each path and cluster size beside batched ``lu_solve``
(:func:`batched_solve_sweep`), and the wide-band factor B6's cluster walk
(``kernels/banded.py:banded_lu_tiled``) at the Poisson band over its CTAs K
and pivots a group g (:func:`band_cluster_sweep`) and against its slab
steps on narrower bands (:func:`band_walk_crossover`), the band solve B7
(``kernels/banded.py:banded_solve_kernelized``) over its warps a block and
staged strips (:func:`band_solve_sweep`) and the paged decode attention
B13 (``kernels/paged_attn.py:paged_decode_attention``) over its CTAs a
cluster (:func:`paged_sweep`), the fused step B15
(``kernels/ebv_lu.py:fused_step``) beside ``solve_triangular`` + ``addmm``
and the forced ``cuda_blocked`` factor it runs in (:func:`blocked_steps`),
and the narrow-band factors on the warp walk (:func:`narrow_bands`): B5
(``kernels/banded.py:banded_lu_blocked``) at Table 1's bands and over bw
at n = 16384, beside B6's slab steps from bw = 12 and the scalar factor
B18 (``banded_lu_kernelized``), and the batched factor B11
(``batched_banded_lu_vmem``) at ``chip_smoke.py``'s three stacks, over
its systems at (16000, 5) and over bw at 16 x 16384, and the batched band
solve B12 (``batched_banded_solve_vmem``) at the same stacks and systems,
beside the per-warp kernel it ran before and over its warps a block
(:func:`batched_band_solves`); ``chip_smoke.py`` runs the sweeps once.

    PYTHONPATH=src python src/repro_torch/launch/time_kernels.py [section ...]

Sections (all by default): factor (B1), update (B14), batched (B10), band
(B6), solve (B7), paged (B13), vmem (B2), blocked (B15), narrow (B5, B11, B18),
batched_band_solve (B12), grid (B10 and B8 at ``chip_smoke.py``'s shapes, B3
and B4 at n = 2000 / 8000 and past a grid axis of column tiles), inverted
(B8's launches at the shootout and the Poisson band), finite (the kernels the
non-finite passes follow, at their table shapes), poisoned (B1 on matrices
whose factor is not finite), scan (B8's tail scan a step, over bw).

It runs as a file and imports ``repro_torch`` absolutely, so it times the
package that ``PYTHONPATH`` names: with another checkout's ``src`` there it
times that checkout's kernels, which is how two trees are compared on one
card in one call (run them A, B, B, A).  Each row is the median of 5 calls
between CUDA events after a warm-up call, and the mean of 20 calls back to
back between two events (the device's time without the host's before each
launch).  The first line is the card's name and power limit.
"""
import hashlib
import inspect
import statistics
import subprocess
import sys

import torch

REPS = 5
BACK_TO_BACK = 20
FACTOR_SIZES = (500, 2000, 8000)
UPDATE_SHAPE = (1792, 256, 1792)  # (m, k, w): chip_smoke.py's B14 row
SOLVE_SIZES, SOLVE_WIDTHS, LEAST_ROWS = (500, 2000), (1, 64), (1, 16, 32, 64)
# B6's cluster walk: K CTAs and g pivots a group (kernels/banded.py:CLUSTER_ORDER)
BAND_CTAS, BAND_GROUPS = (2, 4, 8, 16), (8, 16, 32)
SLAB_BANDS = (16, 32, 33, 36, 64)  # bands whose slab fits one block: B6's slab steps against its cluster walk
# B7: warps a block and staged strips (kernels/banded.py:band_solve_plan)
SWEEP_WARPS, SWEEP_STAGES = (4, 8, 16), (2, 3, 4)
PAGED_CTAS = (1, 2, 4, 8, 16)  # B13: CTAs a cluster (kernels/paged_attn.py:paged_plan)
# chip_smoke.py's bands for B7: Table 1's largest, the shootout (m = 64), the Poisson band
SOLVE_BANDS = ((16000, 5, 1), (16384, 16, 64), (65536, 256, 1))
PAGED_SHAPES = ((4, 36), (32, 256))  # B13: (rows, pages of 16) served and decode-heavy
BLOCKED_SIZES = (2000, 8000)  # B15's first step and the forced cuda_blocked factor
# B5: Table 1's bands (bw = 5), then bw at n = 16384 (the crossover record
# for solvers/backends.py:BANDED_TILED_MIN_BW: B6's slab steps from bw = 12)
NARROW_TABLE1 = ((500, 5), (4000, 5), (16000, 5))
NARROW_BWS = (1, 2, 5, 11, 16, 31)
# B11: chip_smoke.py's stacks (systems, n, bw): 4 and 16 Table 1 bands and 32
# Poisson bands of a 64 x 64 grid; then (16000, 5) for one system, 16, one an
# SM of the H100's 132, 4 and 8 an SM; then bw at 16 x 16384
NARROW_STACKS = ((4, 500, 5), (16, 16000, 5), (32, 4096, 64))
NARROW_SYSTEMS = (1, 16, 132, 528, 1056)
# B12 at (16000, 5): warps a block (band_solve_plan takes 4 where bw <= 32)
BAND_STACK_WARPS = (1, 2, 4)
# B10 at chip_smoke.py's stacks (B, n, RHS widths): the batched dense path's and the optimizer's
GRID_STACKS = ((8, 128, (1, 128)), (32, 256, (1, 256)), (8, 1024, (1, 1024)), (2, 384, (51968,)))
# B8: the shootout band with 1 and 64 RHS columns, the Poisson band of a 256 x 256 grid
INVERTED_SHAPES = ((16384, 16, 1), (16384, 16, 64), (65536, 256, 1))
POISONED_SIZES = (1024, 2000, 8000)
# B8's scan at S = 128 over the band (and RHS) width
SCAN_BANDS = ((4096, 1, 1), (4096, 4, 1), (8192, 8, 1), (16384, 16, 1), (32768, 32, 1), (16384, 16, 64),
              (16384, 16, 512))  # B1 on a NaN entry and on a zero first pivot
# B3 and B4 past a grid axis of column tiles (fault C12)
WIDE_RHS = (64, 4_194_305)
# B10: (B, n, m) on either side of the plan's split between its two paths
SOLVE_SPLIT = ((8, 1024, 1), (8, 1024, 16), (8, 1024, 64), (8, 1024, 1024), (32, 256, 1), (32, 256, 16),
               (32, 256, 256), (8, 128, 1), (8, 128, 128), (2, 384, 51968))


def timed(fn) -> tuple[float, float]:
    """(median ms of one call, mean ms a call over BACK_TO_BACK calls)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(BACK_TO_BACK):
        fn()
    end.record()
    end.synchronize()
    return statistics.median(times), start.elapsed_time(end) / BACK_TO_BACK


def graph_ms(fn, calls: int = BACK_TO_BACK) -> float | None:
    """The time a call of ``fn`` takes on the card without the host: ``calls``
    calls captured in one CUDA graph, the median of 5 replays between CUDA
    events over ``calls``; None where the capture fails (a launch that is
    not capture-safe)."""
    fn()
    torch.cuda.synchronize()
    try:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
    except RuntimeError as err:
        print(f"    the capture failed: {err}", flush=True)
        return None
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def poisson_band(nx: int, device) -> torch.Tensor:
    """The 5-point Laplacian of an nx x nx grid with diagonal 4.05
    (examples/cfd_poisson.py) in row-aligned band form, bw = nx."""
    n, bw = nx * nx, nx
    i = torch.arange(n, device=device)
    one = torch.ones(n, device=device)
    a = torch.zeros((n, 2 * bw + 1), device=device)
    a[:, bw] = 4.05
    a[:, bw - 1] = torch.where(i % nx > 0, -one, 0 * one)
    a[:, bw + 1] = torch.where(i % nx < nx - 1, -one, 0 * one)
    a[:, 0] = torch.where(i >= nx, -one, 0 * one)
    a[:, 2 * bw] = torch.where(i < n - nx, -one, 0 * one)
    return a


def band_cluster_sweep(a: torch.Tensor, bw: int) -> dict:
    """{(K, g): (ms one call, ms back to back)} of B6's cluster walk on the
    band ``a`` for every K and g whose CTA fits shared memory (the others
    print why not), each checked bitwise against the plan's own choice."""
    from repro_torch.kernels import banded

    n = a.shape[0]
    want = banded.banded_lu_tiled(a, bw=bw)
    out = {}
    for k in BAND_CTAS:
        for g in BAND_GROUPS:
            try:
                plan = banded.band_cluster_plan(bw, ctas=k, group=g)
            except ValueError as err:
                print(f"    banded_lu_tiled n={n} bw={bw} K={k:2d} g={g:2d}: {err}", flush=True)
                continue
            got = banded._lu_tiled(a, bw=bw, plan=plan)
            if not torch.equal(got, want):
                raise RuntimeError(f"banded_lu_tiled K={k} g={g} differs from the plan's own")
            out[(k, g)] = timed(lambda: banded._lu_tiled(a, bw=bw, plan=plan))
            t1, t20 = out[(k, g)]
            print(f"    banded_lu_tiled n={n} bw={bw} K={k:2d} g={g:2d}: {t1:.3f} / {t20:.3f} ms "
                  f"(one call / back to back), {1e3 * t1 / n:.3f} us a pivot, "
                  f"{1e3 * t1 / -(-n // g):.2f} us a group", flush=True)
    return out


def band_walk_crossover(n: int = 16384, bws=SLAB_BANDS) -> dict:
    """{bw: {label: (ms one call, ms back to back)}} of B6 on bands whose
    slab fits one block: its slab steps beside the cluster walk at every K
    and g that fits, each checked bitwise against the plain version; the
    plan takes the slab steps below ``banded.BAND_CLUSTER_MIN_BW``, where
    they are faster."""
    from repro_torch.kernels import banded

    dev = torch.device("cuda")
    out = {}
    for bw in bws:
        g = torch.Generator(device=dev).manual_seed(900 + bw)
        a = torch.rand((n, 2 * bw + 1), generator=g, device=dev) * 2 - 1
        j = torch.arange(n, device=dev)[:, None] - bw + torch.arange(2 * bw + 1, device=dev)
        a = torch.where((j >= 0) & (j < n), a, 0.0)  # a band: zero outside the matrix
        a[:, bw] = a.abs().sum(dim=1) + 1
        want = banded.banded_lu_plain(a, bw=bw)
        runs = {"slab steps": None}
        for k in BAND_CTAS:
            for grp in BAND_GROUPS:
                try:
                    runs[f"K={k} g={grp}"] = banded.band_cluster_plan(bw, ctas=k, group=grp)
                except ValueError:
                    pass
        cells = out[bw] = {}
        for label, plan in runs.items():
            if label == "slab steps" and not banded.slab_fits(n, bw):
                continue  # no slab of this band fits a block
            if not torch.equal(banded._lu_tiled(a, bw=bw, plan=plan), want):
                raise RuntimeError(f"banded_lu_tiled n={n} bw={bw} {label} differs from its plain version")
            cells[label] = timed(lambda: banded._lu_tiled(a, bw=bw, plan=plan))
        best = min((v[0], k) for k, v in cells.items() if k != "slab steps")
        print(f"    banded_lu_tiled n={n} bw={bw}, one call / back to back: "
              + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in cells.items())
              + f"; fastest cluster walk {best[1]} {best[0]:.4f}", flush=True)
    return out


def band_solve_sweep(lu: torch.Tensor, b: torch.Tensor, bw: int) -> dict:
    """{label: (ms one call, ms back to back)} of B7 on the factors ``lu``
    and RHS ``b`` over its warps a block (:data:`SWEEP_WARPS`) and staged
    strips (:data:`SWEEP_STAGES`), each that fits, beside the per-warp
    kernel it replaced (B12's), each checked against the plain version
    within 1e-4 normwise."""
    from repro_torch.core.banded import banded_solve_blocked
    from repro_torch.kernels import banded

    n = lu.shape[0]
    m = 1 if b.ndim == 1 else b.shape[1]
    want = banded_solve_blocked(lu, b, bw=bw)
    scale = float(want.abs().max())
    plans = {f"warps={w} stages={r}": banded.band_solve_plan(n, bw, m, warps=w, stages=r)
             for w in SWEEP_WARPS for r in SWEEP_STAGES}
    # the per-warp kernel, which B12 and the bands too wide to stage take
    plans["per-warp kernel"] = banded.BandSolvePlan("warp", min(m, 32), min(m, 32), 0, 0)
    out = {}
    for label, plan in plans.items():
        if label != "per-warp kernel" and plan.path != "staged":
            print(f"    banded_solve_kernelized n={n} bw={bw} m={m} {label}: no block holds it", flush=True)
            continue
        err = float((banded._solve(lu, b, bw=bw, plan=plan) - want).abs().max()) / scale
        if not err <= 1e-4:
            raise RuntimeError(f"banded_solve_kernelized n={n} bw={bw} m={m} {label}: normwise {err:.2e}")
        out[label] = timed(lambda: banded._solve(lu, b, bw=bw, plan=plan))
    plan = banded.band_solve_plan(n, bw, m)
    strips = 2 * -(-n // 32)
    print(f"    banded_solve_kernelized n={n} bw={bw} m={m} (plan: {plan.warps} warps, {plan.cols} columns a "
          f"block, {plan.stages} stages), one call / back to back: "
          + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in out.items())
          + f"; the plan's {1e3 * out[f'warps={plan.warps} stages={plan.stages}'][0] / strips:.3f} us a strip",
          flush=True)
    return out


def paged_sweep(args: tuple) -> dict:
    """{K: (ms one call, ms back to back, ms a call in a CUDA graph)} of
    B13 on ``args`` (q, the two pools, page table, lengths) over clusters
    of K = 1 .. 16 CTAs, each checked against the plain version (1e-5
    normwise in fp32, 1e-2 in bf16).  At the served shape a call's host
    time exceeds its device time, so back to back measures the host; the
    graph's replay measures the card alone."""
    from repro_torch.kernels import paged_attn

    q, kp = args[0], args[1]
    b, h, dh = q.shape
    np_, page, kvh = args[3].shape[1], kp.shape[1], kp.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    want = paged_attn.paged_decode_attention_plain(*args).float()
    tol = 1e-5 if q.dtype == torch.float32 else 1e-2
    out = {}
    for k in PAGED_CTAS:
        plan = paged_attn.paged_plan(b, h, kvh, dh, np_, page, q.element_size(), sms, ctas=k)
        err = float((paged_attn._attend(*args, plan).float() - want).abs().max() / want.abs().max())
        if not err <= tol:
            raise RuntimeError(f"paged_decode_attention B={b} NP={np_} K={k}: normwise {err:.2e}")
        call = lambda: paged_attn._attend(*args, plan)
        out[k] = (*timed(call), graph_ms(call))
    plan = paged_attn.paged_plan(b, h, kvh, dh, np_, page, q.element_size(), sms)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    print(f"    paged_decode_attention B={b} NP={np_} {str(q.dtype).removeprefix('torch.')} (plan: K={plan.ctas}), "
          "one call / back to back / in a CUDA graph: "
          + "; ".join(f"K={k} {v[0]:.4f} / {v[1]:.4f} / {fmt(v[2])}" for k, v in out.items()), flush=True)
    return out


def batched_solve_sweep(lu: torch.Tensor, b: torch.Tensor) -> dict:
    """{label: (ms one call, ms back to back)} of B10 on ``lu``, ``b``
    (``(B, n)`` or ``(B, n, m)``) on the wide path and on clusters of each
    size that fits, beside batched ``lu_solve`` with identity pivots, each
    checked bitwise against the plain version."""
    from repro_torch.kernels import batched_lu

    b = b[..., None] if b.ndim == 2 else b
    bsz, n, m = b.shape
    sms = torch.cuda.get_device_properties(lu.device).multi_processor_count
    room = batched_lu.solve_cluster_room(lu.device)
    want = batched_lu.batched_lu_solve_plain(lu, b)
    runs = [("wide", "wide", None)] + [(f"cluster of {c}", "cluster", c) for c in (2, 4, 8, 16)]
    out = {}
    for label, path, c in runs:
        try:
            plan = batched_lu.batched_solve_plan(bsz, n, m, sms, room, path, c)
            got = batched_lu._solve(lu, b, plan)
        except (ValueError, RuntimeError) as err:  # no such CTA fits, or the card holds no such cluster
            print(f"    batched_lu_solve_vmem B={bsz} n={n} m={m} {label}: {err}", flush=True)
            continue
        if not torch.equal(got, want):
            raise RuntimeError(f"batched_lu_solve_vmem B={bsz} n={n} m={m} {label} differs from its plain version")
        out[label] = timed(lambda: batched_lu._solve(lu, b, plan))
    piv = torch.arange(1, n + 1, dtype=torch.int32, device=lu.device).expand(bsz, n).contiguous()
    out["lu_solve"] = timed(lambda: torch.linalg.lu_solve(lu, piv, b))
    plan = batched_lu.batched_solve_plan(bsz, n, m, sms, room)
    print(f"    batched_lu_solve_vmem B={bsz} n={n} m={m} (plan: {plan.path}, {plan.cols} columns a tile, "
          f"{plan.ctas} CTA(s)), one call / back to back: "
          + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in out.items()), flush=True)
    return out


def solve_bands(dev) -> dict:
    """B7 at chip_smoke.py's three bands: {(n, bw, m): (ms one call, ms
    back to back)}, on this tree's B7 (its default plan) and, where the
    tree has them, over its warps a block and staged strips."""
    from repro_torch.kernels import banded

    out = {}
    for n, bw, m in SOLVE_BANDS:
        a = poisson_band(256, dev) if bw == 256 else band_of(n, bw, dev)
        lu = banded.banded_lu_tiled(a, bw=bw)
        g = torch.Generator(device=dev).manual_seed(n + m)
        b = torch.randn((n,) if m == 1 else (n, m), generator=g, device=dev)
        out[(n, bw, m)] = timed(lambda: banded.banded_solve_kernelized(lu, b, bw=bw))
        print(f"banded_solve_kernelized n={n} bw={bw} m={m}: {out[(n, bw, m)][0]:.4f} ms, "
              f"{out[(n, bw, m)][1]:.4f} back to back", flush=True)
        if hasattr(banded, "band_solve_plan"):
            band_solve_sweep(lu, b, bw)
    return out


def paged_shapes(dev) -> dict:
    """B13 at chip_smoke.py's two shapes (llama3-8b's KV heads, bf16):
    {(B, NP): (ms one call, ms back to back, ms a call in a CUDA graph)},
    and over its clusters where the tree has them."""
    from repro_torch.kernels import paged_attn

    out = {}
    for b, np_ in PAGED_SHAPES:
        g = torch.Generator(device=dev).manual_seed(b * np_)
        pool = b * np_ + 1
        q = torch.randn((b, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        kp, vp = (torch.randn((pool, 16, 8, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        table = (1 + torch.randperm(pool - 1, generator=g, device=dev)).reshape(b, np_).to(torch.int32)
        lengths = torch.full((b,), np_ * 16, dtype=torch.int32, device=dev)
        args = (q, kp, vp, table, lengths)
        call = lambda: paged_attn.paged_decode_attention(*args)
        out[(b, np_)] = (*timed(call), graph_ms(call))
        dev_ms = out[(b, np_)][2]
        print(f"paged_decode_attention B={b} NP={np_} bf16: {out[(b, np_)][0]:.4f} ms, "
              f"{out[(b, np_)][1]:.4f} back to back, in a CUDA graph "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}", flush=True)
        if hasattr(paged_attn, "paged_plan"):
            paged_sweep(args)
    return out


def band_of(n: int, bw: int, dev, seed: int = 0) -> torch.Tensor:
    """A diagonally dominant row-aligned band, zero outside the matrix."""
    g = torch.Generator(device=dev).manual_seed(900 + bw + 1000 * seed)
    a = torch.rand((n, 2 * bw + 1), generator=g, device=dev) * 2 - 1
    j = torch.arange(n, device=dev)[:, None] - bw + torch.arange(2 * bw + 1, device=dev)
    a = torch.where((j >= 0) & (j < n), a, 0.0)
    a[:, bw] = a.abs().sum(dim=1) + 1
    return a


def blocked_steps(dev) -> dict:
    """B15 on the forced cuda_blocked factor's first step (pan (n, 256), the
    trailing width padded to a multiple of 128 as the driver pads it) at
    n in :data:`BLOCKED_SIZES`, beside ``solve_triangular`` + ``addmm``
    (two calls), its U12 checked bitwise against the plain version; then
    ``ops.lu(impl="cuda_blocked")`` at the same n.  {label: (ms one call,
    ms back to back)}."""
    from repro_torch.kernels import ebv_lu, ops

    out = {}
    for n in BLOCKED_SIZES:
        g = torch.Generator(device=dev).manual_seed(n)
        a = torch.rand((n, n), generator=g, device=dev) * 2 - 1
        a.diagonal().copy_(a.abs().sum(dim=1) + 1)
        b = 256
        wpad = -(-(n - b) // 128) * 128
        pan = ebv_lu.panel(a[:, :b])
        top = torch.nn.functional.pad(a[:b, b:], (0, wpad - n + b))
        trail = torch.nn.functional.pad(a[b:, b:], (0, wpad - n + b))
        u12, _ = ebv_lu.fused_step(pan, top, trail, col_tile=128)
        if not torch.equal(u12, ebv_lu.fused_step_plain(pan, top, trail)[0]):
            raise RuntimeError(f"fused_step n={n}: U12 differs from the plain version's")
        l11, l21 = pan[:b], pan[b:]

        def two_calls():
            u = torch.linalg.solve_triangular(l11, top, upper=False, unitriangular=True)
            return torch.addmm(trail, l21, u, alpha=-1)

        before = ebv_lu.fused_step.launches
        out[f"fused_step n={n}"] = timed(lambda: ebv_lu.fused_step(pan, top, trail, col_tile=128))
        per_call = (ebv_lu.fused_step.launches - before) // (1 + REPS + BACK_TO_BACK)
        out[f"library n={n}"] = timed(two_calls)
        out[f"cuda_blocked n={n}"] = timed(lambda: ops.lu(a, impl="cuda_blocked"))
        k, lib, fac = (out[f"{x} n={n}"] for x in ("fused_step", "library", "cuda_blocked"))
        m = n - b  # the unit-lower solve b(b-1)W flops and the product 2(m-b)bW, over 67 TFLOP/s fp32
        bound = (b * (b - 1) * wpad + 2 * m * b * wpad) / 67e12 * 1e3
        print(f"fused_step n={n} step 1 (W {wpad}, {per_call} launch(es) a call), one call / back to back: "
              f"{k[0]:.4f} / {k[1]:.4f} ms (bound {bound:.4f}); solve_triangular + addmm {lib[0]:.4f} / "
              f"{lib[1]:.4f}; ops.lu(impl='cuda_blocked') {fac[0]:.4f} / {fac[1]:.4f}", flush=True)
    return out


def narrow_bands(dev) -> dict:
    """B5 at :data:`NARROW_TABLE1` and at n = 16384 over :data:`NARROW_BWS`,
    beside B6 (its slab steps) from bw = 12 and B18; B11 at
    :data:`NARROW_STACKS`, over :data:`NARROW_SYSTEMS` at (16000, 5) and
    over :data:`NARROW_BWS` at 16 x 16384.  Each factor is checked bitwise
    against its plain version.  {label: (ms one call, ms back to back)}."""
    from repro_torch.kernels import banded

    def walk(fn):
        return getattr(fn, "last_path", None) or "ring walk"

    out = {}
    cases = list(NARROW_TABLE1) + [(16384, bw) for bw in NARROW_BWS]
    for n, bw in cases:
        a = band_of(n, bw, dev)
        if not torch.equal(banded.banded_lu_blocked(a, bw=bw), banded.banded_lu_plain(a, bw=bw)):
            raise RuntimeError(f"banded_lu_blocked n={n} bw={bw} differs from its plain version")
        t = out[f"banded_lu_blocked n={n} bw={bw}"] = timed(lambda: banded.banded_lu_blocked(a, bw=bw))
        line = (f"banded_lu_blocked n={n} bw={bw} ({walk(banded.banded_lu_blocked)}), one call / back to "
                f"back: {t[0]:.4f} / {t[1]:.4f} ms, {1e3 * t[0] / n:.4f} us a pivot")
        if bw >= 12:
            tt = out[f"banded_lu_tiled n={n} bw={bw}"] = timed(lambda: banded.banded_lu_tiled(a, bw=bw))
            line += f"; banded_lu_tiled {tt[0]:.4f} / {tt[1]:.4f}"
        if n == 16384 or (n, bw) == (16000, 5):
            if not torch.equal(banded.banded_lu_kernelized(a, bw=bw), banded.banded_lu_scalar_plain(a, bw=bw)):
                raise RuntimeError(f"banded_lu_kernelized n={n} bw={bw} differs from its plain version")
            ts = out[f"banded_lu_kernelized n={n} bw={bw}"] = timed(lambda: banded.banded_lu_kernelized(a, bw=bw))
            line += (f"; banded_lu_kernelized ({walk(banded.banded_lu_kernelized)}) {ts[0]:.4f} / "
                     f"{ts[1]:.4f} ms, {1e3 * ts[0] / n:.4f} us a pivot")
        print(line, flush=True)

    def stack_row(label, stack, bw):
        if not torch.equal(banded.batched_banded_lu_vmem(stack, bw=bw), banded.banded_lu_plain(stack, bw=bw)):
            raise RuntimeError(f"batched_banded_lu_vmem {label} differs from its plain version")
        t = out[f"batched_banded_lu_vmem {label}"] = timed(lambda: banded.batched_banded_lu_vmem(stack, bw=bw))
        print(f"batched_banded_lu_vmem {label} ({walk(banded.batched_banded_lu_vmem)}), one call / back to "
              f"back: {t[0]:.4f} / {t[1]:.4f} ms, {1e3 * t[0] / stack.shape[1]:.4f} us a pivot", flush=True)

    for bsz, n, bw in NARROW_STACKS:
        if bw == 64:  # the Poisson ensemble, member s with diagonal 4.05 + 0.01 s
            stack = poisson_band(64, dev).expand(bsz, -1, -1).clone()
            stack[:, :, 64] += 0.01 * torch.arange(bsz, device=dev)[:, None]
        else:
            stack = torch.stack([band_of(n, bw, dev, s) for s in range(bsz)])
        stack_row(f"B={bsz} n={n} bw={bw}", stack, bw)
    for bsz in NARROW_SYSTEMS:
        stack_row(f"B={bsz} n=16000 bw=5 (systems)",
                  torch.stack([band_of(16000, 5, dev, s % 16) for s in range(bsz)]), 5)
    for bw in NARROW_BWS:
        stack_row(f"B=16 n=16384 bw={bw}", torch.stack([band_of(16384, bw, dev, s) for s in range(16)]), bw)
    return out


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def batched_band_solves(dev) -> dict:
    """B12 (``batched_banded_solve_vmem``) at :data:`NARROW_STACKS`, over
    :data:`NARROW_SYSTEMS` at (16000, 5) and, on a tree whose B12 takes a
    plan, at 32 x (4096, 64) over :data:`SWEEP_WARPS` a block, at 16 and
    1056 x (16000, 5) over :data:`BAND_STACK_WARPS`, and on the per-warp
    kernel (``band_solve_kernel``, the one B12 ran before it took
    B7's staged kernel) at the three stacks.  Where B12 runs B7's kernel
    each call is checked bitwise, system by system, against B7
    (``banded_solve_kernelized``, or ``banded._solve`` under a forced plan)
    on that system alone; on an older tree, within 1e-5 normwise of the
    plain version.  {label: (ms one call, ms back to back)}."""
    from repro_torch.core.banded import banded_solve_blocked
    from repro_torch.kernels import banded

    staged = hasattr(banded.batched_banded_solve_vmem, "last_plan")  # B12 on B7's kernel, with a plan

    def solve(lu, b, bw, plan):
        return (banded.batched_banded_solve_vmem(lu, b, bw=bw) if plan is None
                else banded.batched_banded_solve_vmem(lu, b, bw=bw, plan=plan))

    def checked(label, lu, b, bw, plan=None):
        got = solve(lu, b, bw, plan)
        torch.cuda.synchronize()
        if staged:
            for s in range(lu.shape[0]):
                alone = (banded.banded_solve_kernelized(lu[s], b[s], bw=bw) if plan is None
                         else banded._solve(lu[s], b[s], bw=bw, plan=plan))
                if not torch.equal(got[s], alone):
                    raise RuntimeError(f"batched_banded_solve_vmem {label}: system {s} differs from B7 on it")
        else:
            want = banded_solve_blocked(lu, b, bw=bw)
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= 1e-5:
                raise RuntimeError(f"batched_banded_solve_vmem {label}: normwise {err:.2e}")
        t = out[label] = timed(lambda: solve(lu, b, bw, plan))
        n = lu.shape[1]
        report = banded.batched_banded_solve_vmem.last_plan if staged else "the per-warp kernel"
        print(f"batched_banded_solve_vmem {label} (plan {report}), one call / back to back: {t[0]:.4f} / "
              f"{t[1]:.4f} ms, {1e3 * t[0] / (2 * -(-n // 32)):.3f} us a strip", flush=True)
        return t

    def stack_of(bsz, n, bw, seed=0):
        if bw == 64:  # the Poisson ensemble, member s with diagonal 4.05 + 0.01 s
            a = poisson_band(64, dev).expand(bsz, -1, -1).clone()
            a[:, :, 64] += 0.01 * torch.arange(bsz, device=dev)[:, None]
        else:
            a = torch.stack([band_of(n, bw, dev, seed + s % 16) for s in range(bsz)])
        g = torch.Generator(device=dev).manual_seed(bsz + n + bw)
        return banded.batched_banded_lu_vmem(a, bw=bw), torch.randn((bsz, n), generator=g, device=dev)

    out = {}
    for bsz, n, bw in NARROW_STACKS:
        lu, b = stack_of(bsz, n, bw)
        checked(f"B={bsz} n={n} bw={bw}", lu, b, bw)
        if staged:
            warp = banded.BandSolvePlan("warp", 1, 1, 0, 0)
            checked(f"B={bsz} n={n} bw={bw} on the per-warp kernel", lu, b, bw, warp)
        if (n, bw) == (4096, 64) and staged:
            for w in SWEEP_WARPS:
                checked(f"B={bsz} n={n} bw={bw} warps={w}", lu, b, bw, banded.band_solve_plan(n, bw, 1, warps=w))
    for bsz in NARROW_SYSTEMS:
        lu, b = stack_of(bsz, 16000, 5)
        checked(f"B={bsz} n=16000 bw=5 (systems)", lu, b, 5)
        if bsz in (16, NARROW_SYSTEMS[-1]) and staged:  # fewer warps a block: more blocks an SM
            for w in BAND_STACK_WARPS:
                checked(f"B={bsz} n=16000 bw=5 warps={w}", lu, b, 5, banded.band_solve_plan(16000, 5, 1, warps=w))
    return out


def grid_folds(dev) -> dict:
    """The kernels whose grid folds the system or the diagonal block into
    one axis: B10 (``batched_lu_solve_vmem``) at ``chip_smoke.py``'s four
    stacks, each checked bitwise against the plain version, and B8
    (``banded_solve_inverted``) at the shootout band with 1 and 64 RHS
    columns, checked within 1e-4 normwise.  Each line ends with the first
    16 hex digits of the SHA-256 of the output's bytes: the inputs come
    from seeded generators, so two trees run on one card print the same
    digest where their kernels' results are bitwise the same.  {label: (ms
    one call, ms back to back)}."""
    from repro_torch.core.factorization import banded_inverted_solve, factorize_banded
    from repro_torch.kernels import banded, batched_lu

    out = {}
    for bsz, n, ms in GRID_STACKS:
        g = torch.Generator(device=dev).manual_seed(bsz + n)
        a = torch.rand((bsz, n, n), generator=g, device=dev) * 2 - 1
        a.diagonal(dim1=-2, dim2=-1).copy_(a.abs().sum(dim=-1) + 1)
        lu = batched_lu.batched_lu_vmem(a)
        for m in ms:
            b = torch.randn((bsz, n, m), generator=g, device=dev)
            got = batched_lu.batched_lu_solve_vmem(lu, b)
            if not torch.equal(got, batched_lu.batched_lu_solve_plain(lu, b)):
                raise RuntimeError(f"batched_lu_solve_vmem B={bsz} n={n} m={m} differs from its plain version")
            t = out[f"batched_lu_solve_vmem B={bsz} n={n} m={m}"] = timed(lambda: batched_lu.batched_lu_solve_vmem(lu, b))
            print(f"batched_lu_solve_vmem B={bsz} n={n} m={m}, one call / back to back: {t[0]:.4f} / {t[1]:.4f} ms; "
                  f"output sha256 {digest(got)}", flush=True)
    from repro_torch.core.factorization import dense_block_inverses
    from repro_torch.kernels import ebv_lu, trsm

    # past a grid axis only where the tree folds the column tiles (C12): a
    # refused launch would leave its error for the next one to report
    wide = (WIDE_RHS,) if hasattr(trsm.solve_tiled, "last_grid") or hasattr(trsm, "largest_step_grid") else ()
    for n, m in ((2000, 1), (2000, 64), (8000, 1), (8000, 64), *wide):
        g = torch.Generator(device=dev).manual_seed(n + m)
        a = torch.rand((n, n), generator=g, device=dev) * 2 - 1
        a.diagonal().copy_(a.abs().sum(dim=1) + 1)
        lu = ebv_lu.lu_fused(a)
        linv, uinv = dense_block_inverses(lu, block=min(n, 256))
        b = torch.randn((n, m), generator=g, device=dev)
        for name, fn in (("solve_tiled", lambda: trsm.solve_tiled(lu, b)),
                         ("solve_inverted", lambda: trsm.solve_inverted(lu, linv, uinv, b))):
            try:
                got = fn()
            except RuntimeError as err:  # a tree whose grid stops at 65,535 column tiles
                print(f"{name} n={n} m={m}: {str(err).splitlines()[0]}", flush=True)
                continue
            t = out[f"{name} n={n} m={m}"] = timed(fn)
            print(f"{name} n={n} m={m}, one call / back to back: {t[0]:.4f} / {t[1]:.4f} ms; "
                  f"output sha256 {digest(got)}", flush=True)
        del lu, linv, uinv, b
    n, bw = SOLVE_BANDS[1][:2]
    f = factorize_banded(banded.banded_lu_blocked(band_of(n, bw, dev), bw=bw), bw=bw)
    args = (f.linv, f.uinv, f.tlo, f.tup)
    for m in (1, 64):
        b = torch.randn((n, m), generator=torch.Generator(device=dev).manual_seed(m), device=dev)
        want = banded_inverted_solve(*args, b, n=n, bw=bw)
        got = banded.banded_solve_inverted(*args, b, n=n, bw=bw)
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= 1e-4:
            raise RuntimeError(f"banded_solve_inverted n={n} bw={bw} m={m}: normwise {err:.2e}")
        t = out[f"banded_solve_inverted n={n} bw={bw} m={m}"] = timed(
            lambda: banded.banded_solve_inverted(*args, b, n=n, bw=bw))
        print(f"banded_solve_inverted n={n} bw={bw} m={m}, one call / back to back: {t[0]:.4f} / {t[1]:.4f} ms; "
              f"output sha256 {digest(got)}", flush=True)
    return out


def b8_inputs(n: int, bw: int, m: int, dev):
    """The enriched factors and the RHS of B8 at ``(n, bw, m)``: the Poisson
    band of a 256 x 256 grid where bw = 256, else :func:`band_of`."""
    from repro_torch.core.factorization import factorize_banded
    from repro_torch.kernels import banded

    a = poisson_band(256, dev) if (n, bw) == (65536, 256) else band_of(n, bw, dev)
    f = factorize_banded(banded.banded_lu_tiled(a, bw=bw) if bw > 32 else banded.banded_lu_blocked(a, bw=bw), bw=bw)
    b = torch.randn((n, m), generator=torch.Generator(device=dev).manual_seed(n + m), device=dev)
    return (f.linv, f.uinv, f.tlo, f.tup), b


def launch_split(fn, names: tuple, calls: int = 10) -> list[tuple[str, float]]:
    """The mean device time (us) of each launch of ``fn`` whose kernel name
    holds one of ``names``, in launch order within a call, over ``calls``
    calls traced by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")
                      and any(k in e.name for k in names)), key=lambda e: e.time_range.start)
    per = len(kernels) // calls if calls else 0
    out = []
    for j in range(per):
        us = [kernels[c * per + j].time_range.elapsed_us() for c in range(calls)]
        name = kernels[j].name.replace("(anonymous namespace)::", "").split("(")[0]
        out.append((name.removeprefix("void "), statistics.mean(us)))
    return out


def inverted_split(dev) -> dict:
    """B8 (``banded_solve_inverted``) at :data:`INVERTED_SHAPES`: one call and
    back to back, and each of its launches' device time by ``torch.profiler``
    (the two inverse products, the two tail scans, the two coupling
    products); checked within 1e-4 normwise of its plain version.
    On a tree that has them, the products on tiles and the block recurrence
    at every shape (``banded._solve_inverted(..., tiles=True)``) are timed
    beside it.
    {(n, bw, m, label): (ms one call, ms back to back, [(kernel, us), ...])}."""
    from repro_torch.core.factorization import banded_inverted_solve
    from repro_torch.kernels import banded

    out = {}
    for n, bw, m in INVERTED_SHAPES:
        args, b = b8_inputs(n, bw, m, dev)
        want = banded_inverted_solve(*args, b, n=n, bw=bw)
        got = banded.banded_solve_inverted(*args, b, n=n, bw=bw)
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= 1e-4:
            raise RuntimeError(f"banded_solve_inverted n={n} bw={bw} m={m}: normwise {err:.2e}")
        kinds = {"": lambda: banded.banded_solve_inverted(*args, b, n=n, bw=bw)}
        if hasattr(banded, "_solve_inverted"):
            kinds[" (block kernels)"] = lambda: banded._solve_inverted(*args, b, n=n, bw=bw, tiles=True)
        elif "block_kernels" in inspect.signature(banded.banded_solve_inverted).parameters:  # an older tree
            kinds[" (block kernels)"] = lambda: banded.banded_solve_inverted(*args, b, n=n, bw=bw, block_kernels=True)
        for label, fn in kinds.items():
            k1, k20 = timed(fn)
            split = launch_split(fn, ("band_gemm", "band_gemv", "band_tail", "band_scan"))
            out[(n, bw, m, label)] = (k1, k20, split)
            print(f"banded_solve_inverted{label} n={n} bw={bw} m={m}, one call / back to back: {k1:.4f} / "
                  f"{k20:.4f} ms; normwise {err:.1e}; output sha256 {digest(fn())}; launches (us): "
                  + ", ".join(f"{name} {us:.1f}" for name, us in split), flush=True)
    return out


def scan_split(dev) -> dict:
    """B8's tail scan on its own, S = 128 diagonal blocks at every band of
    :data:`SCAN_BANDS` (C = 8 bw clamped to [32, 256]), m = 1 and, at
    bw = 16, m = 64 and 512: each scan launch's device time by
    ``torch.profiler`` over S steps, so the time a step takes against the
    terms its row sums (bw).  {(n, bw, m): us a step}."""
    from repro_torch.kernels import banded

    out = {}
    for n, bw, m in SCAN_BANDS:
        args, b = b8_inputs(n, bw, m, dev)
        S = args[0].shape[0]
        split = launch_split(lambda: banded.banded_solve_inverted(*args, b, n=n, bw=bw), ("band_scan", "band_tail"))
        us = statistics.mean(t for _, t in split)
        out[(n, bw, m)] = us / S
        print(f"tail scan n={n} bw={bw} m={m} S={S}: {us:.1f} us a scan ({split[0][0]}), {1e3 * us / S:.0f} ns a step",
              flush=True)
    return out


def finite_times(dev) -> dict:
    """The kernels that the non-finite passes follow (csrc/nonfinite.cuh), on
    finite inputs at ``PERF.md``'s table shapes: B1 at :data:`FACTOR_SIZES`,
    B2 at (500, 2000) x (1, 64) columns, B3 and B4 at (2000, 8000) x (1,
    64), B7 at :data:`SOLVE_BANDS`, B9 at :data:`GRID_STACKS`' stacks and
    B12 at :data:`NARROW_STACKS`, each with its output's digest.  {label:
    (ms one call, ms back to back)}."""
    from repro_torch.core.factorization import dense_block_inverses
    from repro_torch.kernels import banded, batched_lu, ebv_lu, trsm

    out = {}

    def row(label, fn):
        got = fn()
        t = out[label] = timed(fn)
        print(f"{label}, one call / back to back: {t[0]:.4f} / {t[1]:.4f} ms; output sha256 {digest(got)}",
              flush=True)

    for n in FACTOR_SIZES:
        g = torch.Generator(device=dev).manual_seed(n)
        a = torch.rand((n, n), generator=g, device=dev) * 2 - 1
        a.diagonal().copy_(a.abs().sum(dim=1) + 1)
        row(f"lu_fused n={n}", lambda: ebv_lu.lu_fused(a))
        lu = ebv_lu.lu_fused(a)
        for m in (1, 64):
            b = torch.randn((n, m), generator=g, device=dev)
            if n <= 2000:
                row(f"solve_vmem n={n} m={m}", lambda: trsm.solve_vmem(lu, b))
            if n >= 2000:
                linv, uinv = dense_block_inverses(lu, block=256)
                row(f"solve_tiled n={n} m={m}", lambda: trsm.solve_tiled(lu, b))
                row(f"solve_inverted n={n} m={m}", lambda: trsm.solve_inverted(lu, linv, uinv, b))
    for n, bw, m in SOLVE_BANDS:
        a = poisson_band(256, dev) if bw == 256 else band_of(n, bw, dev)
        lu = banded.banded_lu_tiled(a, bw=bw) if bw > 32 else banded.banded_lu_blocked(a, bw=bw)
        b = torch.randn((n, m), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
        row(f"banded_solve_kernelized n={n} bw={bw} m={m}", lambda: banded.banded_solve_kernelized(lu, b, bw=bw))
    for bsz, n, _ in GRID_STACKS:
        g = torch.Generator(device=dev).manual_seed(bsz + n)
        a = torch.rand((bsz, n, n), generator=g, device=dev) * 2 - 1
        a.diagonal(dim1=-2, dim2=-1).copy_(a.abs().sum(dim=-1) + 1)
        row(f"batched_lu_vmem B={bsz} n={n}", lambda: batched_lu.batched_lu_vmem(a))
    for bsz, n, bw in NARROW_STACKS:
        a = torch.stack([band_of(n, bw, dev, s) for s in range(bsz)])
        lu = banded.batched_banded_lu_vmem(a, bw=bw)
        b = torch.randn((bsz, n, 1), generator=torch.Generator(device=dev).manual_seed(bsz), device=dev)
        row(f"batched_banded_solve_vmem B={bsz} n={n} bw={bw}", lambda: banded.batched_banded_solve_vmem(lu, b, bw=bw))
    return out


def poisoned_times(dev) -> dict:
    """B1 (``lu_fused``) on matrices whose factor is not finite, as a hostile
    request to the solve service gives it: a NaN at (n/3, n/2), and a zero
    first pivot, at :data:`POISONED_SIZES`: the median of 3 single calls
    after one more, with the digest of the result's NaN mask (an older
    tree's one-block pass takes seconds there).  {label: ms one call}."""
    from repro_torch.kernels import ebv_lu

    out = {}
    for n in POISONED_SIZES:
        g = torch.Generator(device=dev).manual_seed(n)
        a = torch.rand((n, n), generator=g, device=dev) * 2 - 1
        a.diagonal().copy_(a.abs().sum(dim=1) + 1)
        for kind in ("nan", "zero pivot"):
            p = a.clone()
            if kind == "nan":
                p[n // 3, n // 2] = float("nan")
            else:
                p[0, 0] = 0.0
            got = ebv_lu.lu_fused(p)
            times = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                ebv_lu.lu_fused(p)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            t = out[f"lu_fused n={n} {kind}"] = statistics.median(times)
            print(f"lu_fused n={n} {kind}, one call: {t:.4f} ms; {int(torch.isnan(got).sum())} NaN, "
                  f"mask sha256 {digest(torch.isnan(got))}", flush=True)
    return out


SECTIONS = ("factor", "update", "batched", "band", "solve", "paged", "vmem", "blocked", "narrow",
            "batched_band_solve", "grid", "inverted", "finite", "poisoned", "scan")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    wanted = set(argv) or set(SECTIONS)
    if not wanted <= set(SECTIONS):
        print(f"time_kernels: sections are {', '.join(SECTIONS)}", file=sys.stderr)
        return 2
    from repro_torch.kernels import banded, batched_lu, ebv_lu, trsm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; repro_torch from {ebv_lu.__file__}", flush=True)
    dev = torch.device("cuda")
    if "factor" in wanted:
        for n in FACTOR_SIZES:
            g = torch.Generator(device=dev).manual_seed(n)
            a = torch.rand((n, n), generator=g, device=dev) * 2 - 1
            a.diagonal().copy_(a.abs().sum(dim=1) + 1)
            k1, k20 = timed(lambda: ebv_lu.lu_fused(a))
            l1, l20 = timed(lambda: torch.linalg.lu_factor(a, pivot=False))
            print(f"lu_fused n={n}: {k1:.4f} ms, {k20:.4f} back to back; lu_factor {l1:.4f}, {l20:.4f}",
                  flush=True)
    if "update" in wanted:
        m, k, w = UPDATE_SHAPE
        g = torch.Generator(device=dev).manual_seed(m)
        l21, u12, a22 = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, w), (m, w)))
        k1, k20 = timed(lambda: ebv_lu.update(l21, u12, a22))
        l1, l20 = timed(lambda: torch.addmm(a22, l21, u12, alpha=-1))
        print(f"update {UPDATE_SHAPE}: {k1:.4f} ms, {k20:.4f} back to back; addmm {l1:.4f}, {l20:.4f}",
              flush=True)
    if "batched" in wanted and hasattr(batched_lu, "batched_solve_plan"):  # a tree with B10's two paths
        for bsz, n, m in SOLVE_SPLIT:
            g = torch.Generator(device=dev).manual_seed(n + m)
            a = torch.rand((bsz, n, n), generator=g, device=dev) * 2 - 1
            a.diagonal(dim1=-2, dim2=-1).copy_(a.abs().sum(dim=-1) + 1)
            batched_solve_sweep(batched_lu.batched_lu_vmem(a), torch.randn((bsz, n, m), generator=g, device=dev))
    if "band" in wanted and hasattr(banded, "tiled_plan"):  # a tree with B6's cluster walk
        band_cluster_sweep(poisson_band(256, dev), 256)
        band_walk_crossover()
    if "solve" in wanted:
        solve_bands(dev)
    if "paged" in wanted:
        paged_shapes(dev)
    if "vmem" in wanted and hasattr(trsm, "VMEM_MIN_ROWS"):  # a tree whose B2 has such a plan
        vmem_rows(dev)
    if "blocked" in wanted:
        blocked_steps(dev)
    if "narrow" in wanted:
        narrow_bands(dev)
    if "batched_band_solve" in wanted:
        batched_band_solves(dev)
    if "grid" in wanted:
        grid_folds(dev)
    if "inverted" in wanted:
        inverted_split(dev)
    if "finite" in wanted:
        finite_times(dev)
    if "poisoned" in wanted:
        poisoned_times(dev)
    if "scan" in wanted:
        scan_split(dev)
    return 0


def vmem_rows(dev) -> None:
    """B2 against the fewest rows a block its plan takes, beside lu_solve."""
    from repro_torch.kernels import ebv_lu, trsm

    least0, sms = trsm.VMEM_MIN_ROWS, torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        for n in SOLVE_SIZES:
            g = torch.Generator(device=dev).manual_seed(n)
            a = torch.rand((n, n), generator=g, device=dev) * 2 - 1
            a.diagonal().copy_(a.abs().sum(dim=1) + 1)
            lu = ebv_lu.lu_fused(a)
            for m in SOLVE_WIDTHS:
                b = torch.randn((n,) if m == 1 else (n, m), generator=g, device=dev)
                cells = []
                for least in LEAST_ROWS:
                    trsm.VMEM_MIN_ROWS = least
                    trsm.solve_vmem_plan.cache_clear()
                    p = trsm.solve_vmem_plan(n, m, sms)
                    k1, k20 = timed(lambda: trsm.solve_vmem(lu, b))
                    cells.append(f"R={p.rows} (P={p.blocks}) {k1:.4f} / {k20:.4f} "
                                 f"({1e3 * k20 / (2 * p.blocks):.2f} us a link)")
                piv = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
                l1, l20 = timed(lambda: torch.linalg.lu_solve(lu, piv, b[:, None] if m == 1 else b))
                print(f"solve_vmem n={n} m={m}, one call / back to back: " + "; ".join(cells)
                      + f"; lu_solve {l1:.4f} / {l20:.4f}", flush=True)
    finally:
        trsm.VMEM_MIN_ROWS = least0
        trsm.solve_vmem_plan.cache_clear()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
