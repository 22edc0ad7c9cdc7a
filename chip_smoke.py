#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense, banded and batched main paths and
the EbV-preconditioned optimizer on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the CUDA sources under ``src/repro_torch/csrc`` with ``nvcc``;
3. kernels against their plain PyTorch versions on the card; 3c the
   batched kernels (B9-B12) at the batched paths' shapes;
4. the main paths, each with its kernels' launch counters set to 0 just
   before and read just after:
   - dense: ``repro_torch.kernels.ops.linear_solve`` at n = 500, 2000,
     8000 (the paper's dense sizes) with a vector and a 64-wide RHS, then
     ``lu(enrich=True)`` + ``lu_solve(impl="cuda_inverted")`` at n = 8000;
   - banded: ``ops.banded_linear_solve`` on the paper's Table 1 bands
     (bw = 5, n = 500, 4000, 16000), the reference's banded shootout
     (n = 16384, bw = 16, m = 1 and 64) and the 5-point Poisson band of a
     256 x 256 grid (n = 65536, bw = 256), then ``banded_lu(enrich=True)``
     + ``banded_solve(impl="cuda_inverted")`` at n = 16384;
   - batched dense (4c): ``ops.linear_solve`` on stacks (B, n) = (8, 128),
     (32, 256) (the reference's autotune grid) and (8, 1024) (its cap),
     m = 1 and n, plain and ``lu(enrich=True)`` + ``lu_solve``;
   - the optimizer (4d): three ``EbvPreconditioned`` steps on the parameter
     tree of whisper-tiny (``configs/whisper_tiny.py`` as
     ``models/lm.py:init_params`` lays it out: one order-384 group of two
     systems with a (2, 384, 51968) RHS) and on the reference benchmark's
     four (128, 128) leaves; the model's forward pass is not ported yet
     (ROADMAP A13), so the gradients are drawn from a seeded generator;
   - batched banded (4e): ``ops.banded_linear_solve`` on 16 Table 1 bands
     (n = 16000, bw = 5) and a CFD ensemble of 32 five-point Poisson bands
     on a 64 x 64 grid (n = 4096, bw = 64), each with its own diagonal;
   checks the dispatches, the counters, the residuals and small answers
   against the float64 oracles;
5. times: each kernel, its plain version and a PyTorch library yardstick
   (where one exists) at the main paths' shapes (CUDA events, median of 5
   runs after one warm-up; the plain versions at the Poisson band one call,
   timed in phase 3), the bound, launches per call and peak memory;
   the ``cuda_vmem`` / ``cuda_tiled`` and ``cuda_blocked`` / ``cuda_tiled``
   crossovers; the optimizer step's time; device time by kernel;
6. the ``kernels`` JSON line, the card line and the result line.

It prints no result and exits 1 where ``torch.cuda.is_available()`` is false.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet: fp32 outside the tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Kernel against plain version, normwise max|k - p| / max|p|: both fp32,
# with other summation orders and fused multiply-adds in the kernels.
KERNEL_TOL = 1e-4
SIZES = (500, 2000, 8000)
WIDE = 64
REPS = 5
# (n, bw) of the banded main path: the paper's Table 1 bands
# (benchmarks/table1_sparse.py), the reference's banded shootout
# (benchmarks/run.py) and the 5-point Poisson band of a 256 x 256 grid
# (examples/cfd_poisson.py, bw = nx)
TABLE1 = ((500, 5), (4000, 5), (16000, 5))
SHOOTOUT = (16384, 16)
POISSON_NX = 256
# the batched kernels' bit-for-bit contract (B9-B11) and B12's tolerance
BATCHED_SOLVE_TOL = 1e-5
# (B, n) of the batched dense path: scripts/autotune.py's batched grid and
# the reference's BATCHED_VMEM_MAX_N
BATCHED_DENSE = ((8, 128), (32, 256), (8, 1024))
# whisper-tiny: d_model 384, 4 + 4 layers, d_ff 1536 (configs/whisper_tiny.py);
# vocab 51865 padded to a multiple of 128 (models/lm.py:30-31)
WHISPER = dict(d=384, vocab=51968, layers=4, ff=1536)
OPT_STEPS = 3
OPT_D, OPT_LEAVES = 128, 4  # benchmarks/run.py:184-197, opt_step_d128
# (systems, n, bw) of the batched banded path: 16 of Table 1's largest band;
# the Poisson ensemble, 32 members on a 64 x 64 grid (bw = 64)
ENSEMBLE_T1 = (16, 16000, 5)
ENSEMBLE_NX, ENSEMBLE_MEMBERS = 64, 32


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np

    from repro_torch import solvers
    from repro_torch.core.ebv import make_diagonally_dominant
    from repro_torch.core.factorization import dense_block_inverses, dense_inverted_solve
    from repro_torch.core.health import relative_residual
    from repro_torch.core.banded import banded_solve_blocked, make_banded_dd
    from repro_torch.core.factorization import banded_inverted_solve, factorize_banded
    from repro_torch import train
    from repro_torch.kernels import _build, banded, batched_lu, ebv_lu, ops, ref, trsm
    from repro_torch.solvers.backends import banded_static_impl

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process per source)", flush=True)

    def matrix(n, seed):
        return make_diagonally_dominant(torch.Generator(device=dev).manual_seed(seed), n, device=dev)

    def rhs(n, m, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn((n,) if m == 1 else (n, m), generator=g, device=dev)

    def band(n, bw, seed):
        return make_banded_dd(torch.Generator(device=dev).manual_seed(seed), n, bw, device=dev)

    def stack(bsz, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.stack([make_diagonally_dominant(g, n, device=dev) for _ in range(bsz)])

    def rhs_stack(bsz, n, m, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn((bsz, n) if m == 1 else (bsz, n, m), generator=g, device=dev)

    def band_stack(bsz, n, bw, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.stack([make_banded_dd(g, n, bw, device=dev) for _ in range(bsz)])

    def poisson_ensemble(members, nx):
        """``members`` 5-point Laplacians of an nx x nx grid in band form,
        member s with diagonal 4.05 + 0.01 s (its own shift)."""
        a = poisson_band(nx).expand(members, -1, -1).clone()
        a[:, :, nx] += 0.01 * torch.arange(members, device=dev)[:, None]
        return a

    def poisson_band(nx):
        """The 5-point Laplacian of an nx x nx grid with diagonal 4.05
        (examples/cfd_poisson.py), built directly in row-aligned band form
        (bw = nx): the dense matrix would take 16 GiB."""
        n, bw = nx * nx, nx
        i = torch.arange(n, device=dev)
        one = torch.ones(n, device=dev)
        a = torch.zeros((n, 2 * bw + 1), device=dev)
        a[:, bw] = 4.05
        a[:, bw - 1] = torch.where(i % nx > 0, -one, 0 * one)       # left neighbour in the grid row
        a[:, bw + 1] = torch.where(i % nx < nx - 1, -one, 0 * one)  # right neighbour
        a[:, 0] = torch.where(i >= nx, -one, 0 * one)               # the grid row below
        a[:, 2 * bw] = torch.where(i < n - nx, -one, 0 * one)       # the grid row above
        return a

    # ---- 3. kernels against their plain versions -------------------------
    print("phase 3: kernel vs plain (normwise max|k-p|/max|p|, L and U of a factor apart; "
          f"tolerance {KERNEL_TOL:.0e})", flush=True)
    max_err = {}

    def compare(name, shape, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: shape {tuple(got.shape)} or non-finite values")
        abs_err = float((got.double() - want.double()).abs().max())
        rel = abs_err / float(want.double().abs().max())
        max_err[name] = max(max_err.get(name, 0.0), abs_err)
        print(f"  {name:15s} {shape:14s} max_abs {abs_err:.3e}  rel {rel:.3e}", flush=True)
        if not rel <= KERNEL_TOL:
            fail(f"{name} {shape}: kernel disagrees with its plain version ({rel:.3e})")

    def compare_lu(name, shape, got, want):
        # L (strictly below the diagonal, ~1e-3) and U (~n/2 on the diagonal)
        # each against its own largest entry, so neither hides in the other
        compare(name, f"{shape} L", got.tril(-1), want.tril(-1))
        compare(name, f"{shape} U", got.triu(), want.triu())

    lus = {}
    for n in SIZES:
        lus[n] = ebv_lu.lu_fused(matrix(n, n))
    a2 = matrix(2000, 2000)
    compare_lu("lu_fused", "n=2000", lus[2000], ebv_lu.lu_fused_plain(a2))
    inverses = {n: dense_block_inverses(lus[n], block=256) for n in SIZES}
    for m in (1, WIDE):
        b = rhs(2000, m, 7)
        compare("solve_vmem", f"n=2000 m={m}", trsm.solve_vmem(lus[2000], b),
                trsm.solve_vmem_plain(lus[2000], b))
        for n in (2000, 8000):
            b = rhs(n, m, 8)
            linv, uinv = inverses[n]
            compare("solve_tiled", f"n={n} m={m}", trsm.solve_tiled(lus[n], b),
                    trsm.solve_tiled_plain(lus[n], b))
            compare("solve_inverted", f"n={n} m={m}", trsm.solve_inverted(lus[n], linv, uinv, b),
                    dense_inverted_solve(lus[n], linv, uinv, b))

    def compare_band_lu(name, shape, got, want, bw):
        # L (columns 0..bw-1) and U (bw..2bw) of the packed band apart
        compare(name, f"{shape} L", got[:, :bw], want[:, :bw])
        compare(name, f"{shape} U", got[:, bw:], want[:, bw:])

    def once(fn):
        """``fn()`` and its time in ms on the card, one call."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # (n, bw, factor kernels, RHS widths, B8 too): each banded kernel at the
    # shapes the banded main path gives it (Table 1's largest band for
    # cuda_blocked, the shootout and the Poisson band for cuda_tiled, B7 at
    # all three), plus n = 4096, bw = 256, where B5 and B8 meet the wide band
    pn = POISSON_NX * POISSON_NX
    apoisson = poisson_band(POISSON_NX)
    plain_once = {}  # the plain versions' time, one call; phase 5 reads it at the Poisson band
    for n, bw, factors, widths, inverted in (
            (16000, 5, ("banded_lu_blocked",), (1,), False),
            (*SHOOTOUT, ("banded_lu_blocked", "banded_lu_tiled"), (1, WIDE), True),
            (4096, 256, ("banded_lu_blocked", "banded_lu_tiled"), (1, WIDE), True),
            (pn, POISSON_NX, ("banded_lu_tiled",), (1,), False)):
        a = apoisson if n == pn else band(n, bw, n + bw)
        plain, plain_ms = once(lambda: banded.banded_lu_plain(a, bw=bw))
        plain_once[f"n={n} bw={bw}"] = plain_ms
        for name in factors:
            got = getattr(banded, name)(a, bw=bw)
            compare_band_lu(name, f"n={n} bw={bw}", got, plain, bw)
            print(f"    bitwise equal to the plain version: {bool(torch.equal(got, plain))}", flush=True)
        f = factorize_banded(plain, bw=bw) if inverted else None
        for m in widths:
            b = rhs(n, m, 12)
            shape = f"n={n} bw={bw} m={m}"
            want, plain_once[shape] = once(lambda: banded_solve_blocked(plain, b, bw=bw))
            compare("banded_solve_kernelized", shape, banded.banded_solve_kernelized(plain, b, bw=bw), want)
            if inverted:
                compare("banded_solve_inverted", shape,
                        banded.banded_solve_inverted(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw),
                        banded_inverted_solve(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw))
    pshape = f"n={pn} bw={POISSON_NX}"
    print(f"  plain versions at the Poisson band, one call each: factor {plain_once[pshape]:.1f} ms, "
          f"solve m=1 {plain_once[pshape + ' m=1']:.1f} ms", flush=True)

    # ---- 3c. the batched kernels against their plain versions -------------
    print("phase 3c: batched kernels vs plain (B9, B10, B11 bit for bit; B12 normwise, "
          f"tolerance {BATCHED_SOLVE_TOL:.0e})", flush=True)

    def compare_bitwise(name, shape, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: shape {tuple(got.shape)} or non-finite values")
        abs_err = float((got.double() - want.double()).abs().max())
        max_err[name] = max(max_err.get(name, 0.0), abs_err)
        equal = bool(torch.equal(got, want))
        print(f"  {name:25s} {shape:24s} max_abs {abs_err:.3e}  bitwise equal: {equal}", flush=True)
        if not equal:
            fail(f"{name} {shape}: kernel differs from its plain version")

    d, vocab = WHISPER["d"], WHISPER["vocab"]
    bstacks = {(bsz, n): stack(bsz, n, 850 + n) for bsz, n in BATCHED_DENSE + ((2, d),)}
    blus = {}
    for (bsz, n), a in bstacks.items():
        blus[(bsz, n)] = batched_lu.batched_lu_vmem(a)
        compare_bitwise("batched_lu_vmem", f"B={bsz} n={n}", blus[(bsz, n)],
                        batched_lu.batched_lu_plain(a))
    for (bsz, n), lu in blus.items():
        for m in ((vocab,) if n == d else (1, n)):
            b = rhs_stack(bsz, n, m, 870 + n + m)
            compare_bitwise("batched_lu_solve_vmem", f"B={bsz} n={n} m={m}",
                            batched_lu.batched_lu_solve_vmem(lu, b),
                            batched_lu.batched_lu_solve_plain(lu, b))
    ensembles = {ENSEMBLE_T1: band_stack(*ENSEMBLE_T1, 880),
                 (ENSEMBLE_MEMBERS, ENSEMBLE_NX ** 2, ENSEMBLE_NX):
                     poisson_ensemble(ENSEMBLE_MEMBERS, ENSEMBLE_NX)}
    eplain, eplain_ms = {}, {}
    for (bsz, n, bw), a in ensembles.items():
        shape = f"B={bsz} n={n} bw={bw}"
        eplain[(bsz, n, bw)], eplain_ms[shape] = once(lambda: banded.banded_lu_plain(a, bw=bw))
        compare_bitwise("batched_banded_lu_vmem", shape, banded.batched_banded_lu_vmem(a, bw=bw),
                        eplain[(bsz, n, bw)])
        b = rhs_stack(bsz, n, 1, 890 + n)
        want, eplain_ms[shape + " m=1"] = once(lambda: banded_solve_blocked(eplain[(bsz, n, bw)], b, bw=bw))
        got = banded.batched_banded_solve_vmem(eplain[(bsz, n, bw)], b, bw=bw)
        torch.cuda.synchronize()
        abs_err = float((got.double() - want.double()).abs().max())
        rel = abs_err / float(want.double().abs().max())
        max_err["batched_banded_solve_vmem"] = max(max_err.get("batched_banded_solve_vmem", 0.0), abs_err)
        print(f"  {'batched_banded_solve_vmem':25s} {shape + ' m=1':24s} max_abs {abs_err:.3e}  "
              f"rel {rel:.3e}", flush=True)
        if not (bool(torch.isfinite(got).all()) and rel <= BATCHED_SOLVE_TOL):
            fail(f"batched_banded_solve_vmem {shape}: kernel disagrees with its plain version ({rel:.3e})")

    # ---- 4. the main paths -----------------------------------------------
    print("phase 4: main path", flush=True)
    wrappers = {"lu_fused": ebv_lu.lu_fused, "solve_vmem": trsm.solve_vmem,
                "solve_tiled": trsm.solve_tiled, "solve_inverted": trsm.solve_inverted}
    cases = [(n, m, matrix(n, 100 + n), rhs(n, m, 200 + n + m)) for n in SIZES for m in (1, WIDE)]
    a8, b8 = matrix(8000, 300), rhs(8000, WIDE, 301)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    results = []
    with solvers.record_dispatches() as log:
        for n, m, a, b in cases:
            mark = len(log)
            x = ops.linear_solve(a, b)
            results.append((f"linear_solve n={n} m={m}", a, b, x, [nm for _, nm in log[mark:]],
                            ["cuda_fused", "cuda_vmem" if n <= 2048 else "cuda_tiled"]))
        mark = len(log)
        f = ops.lu(a8, enrich=True)
        x = ops.lu_solve(f, b8, impl="cuda_inverted")
        results.append((f"lu(enrich)+cuda_inverted n=8000 m={WIDE}", a8, b8, x,
                        [nm for _, nm in log[mark:]], ["cuda_fused", "cuda_inverted"]))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches on the main path: {launches}", flush=True)
    for label, a, b, x, got, want in results:
        res = float(relative_residual(a, b, x))
        print(f"  {label:40s} dispatch {got}  residual {res:.3e}", flush=True)
        if got != want:
            fail(f"{label}: dispatched {got}, expected {want}")
        if x.shape != b.shape or not bool(torch.isfinite(x).all()):
            fail(f"{label}: result of shape {tuple(x.shape)} or non-finite")
        if not res <= solvers.VERIFY_RESIDUAL_DEFAULT_BOUND:
            fail(f"{label}: residual {res:.3e} > {solvers.VERIFY_RESIDUAL_DEFAULT_BOUND}")
    # the C driver reports what it launched; 4S-3 per factor is what it should launch
    expected_lu = sum(ebv_lu.fused_launches(n) for n, _, _, _ in cases) + ebv_lu.fused_launches(8000)
    if launches["lu_fused"] != expected_lu or min(launches.values()) < 1:
        fail(f"launch counters {launches} (lu_fused expected {expected_lu})")
    a5, b5, x5 = cases[0][2], cases[0][3], results[0][3]
    want5 = ref.solve_ref(ref.lu_ref(a5.double().cpu().numpy()), b5.double().cpu().numpy())
    err5 = float(np.abs(x5.double().cpu().numpy() - want5).max() / np.abs(want5).max())
    print(f"  n=500 against the float64 oracle (kernels/ref.py): normwise {err5:.3e}", flush=True)
    if not err5 <= 1e-5:
        fail(f"n=500 answer off the float64 oracle by {err5:.3e}")

    print("phase 4b: banded main path", flush=True)
    bwrappers = {"banded_lu_blocked": banded.banded_lu_blocked, "banded_lu_tiled": banded.banded_lu_tiled,
                 "banded_solve_kernelized": banded.banded_solve_kernelized,
                 "banded_solve_inverted": banded.banded_solve_inverted}
    factor_wrapper = {"cuda_blocked": "banded_lu_blocked", "cuda_tiled": "banded_lu_tiled"}
    bcases = ([(n, bw, 1, band(n, bw, 400 + n)) for n, bw in TABLE1]
              + [(*SHOOTOUT, m, band(*SHOOTOUT, 500)) for m in (1, WIDE)]
              + [(pn, POISSON_NX, 1, apoisson)])
    brhs = [rhs(n, m, 600 + n + m) for n, _, m, _ in bcases]
    a16, b16 = band(*SHOOTOUT, 700), rhs(SHOOTOUT[0], WIDE, 701)
    expected = dict.fromkeys(bwrappers, 0)
    torch.cuda.synchronize()
    for w in bwrappers.values():
        w.launches = 0
    bresults = []
    with solvers.record_dispatches() as log:
        for (n, bw, m, a), b in zip(bcases, brhs):
            mark = len(log)
            x = ops.banded_linear_solve(a, b, bw=bw)
            factor = banded_static_impl(bw)
            bresults.append((f"banded_linear_solve n={n} bw={bw} m={m}", a, b, x, bw,
                             [nm for _, nm in log[mark:]], [factor, "cuda"]))
            expected[factor_wrapper[factor]] += 1 if factor == "cuda_blocked" else banded.tiled_launches(n, bw)
            expected["banded_solve_kernelized"] += 1
        mark = len(log)
        f = ops.banded_lu(a16, bw=SHOOTOUT[1], enrich=True)
        x = ops.banded_solve(f, b16, bw=SHOOTOUT[1], impl="cuda_inverted")
        factor = banded_static_impl(SHOOTOUT[1])
        bresults.append((f"banded_lu(enrich)+cuda_inverted n={SHOOTOUT[0]} m={WIDE}", a16, b16, x,
                         SHOOTOUT[1], [nm for _, nm in log[mark:]], [factor, "cuda_inverted"]))
        expected[factor_wrapper[factor]] += 1 if factor == "cuda_blocked" else banded.tiled_launches(*SHOOTOUT)
        expected["banded_solve_inverted"] += 6  # two batched products and a tail scan per sweep
    torch.cuda.synchronize()
    blaunches = {k: w.launches for k, w in bwrappers.items()}
    launches.update(blaunches)
    print(f"  launches on the banded main path: {blaunches} (expected {expected})", flush=True)
    for label, a, b, x, bw, got, want in bresults:
        res = float(relative_residual(a, b, x, bw=bw))
        print(f"  {label:46s} dispatch {got}  residual {res:.3e}", flush=True)
        if got != want:
            fail(f"{label}: dispatched {got}, expected {want}")
        if x.shape != b.shape or not bool(torch.isfinite(x).all()):
            fail(f"{label}: result of shape {tuple(x.shape)} or non-finite")
        if not res <= solvers.VERIFY_RESIDUAL_DEFAULT_BOUND:
            fail(f"{label}: residual {res:.3e} > {solvers.VERIFY_RESIDUAL_DEFAULT_BOUND}")
    if blaunches != expected or min(blaunches.values()) < 1:
        fail(f"banded launch counters {blaunches}, expected {expected}, each at least 1")
    a5, b5, x5 = bresults[0][1], bresults[0][2], bresults[0][3]
    want5 = ref.banded_solve_ref(ref.banded_lu_ref(a5.double().cpu().numpy(), 5),
                                 b5.double().cpu().numpy(), 5)
    err5 = float(np.abs(x5.double().cpu().numpy() - want5).max() / np.abs(want5).max())
    print(f"  n=500 bw=5 against the float64 oracle (kernels/ref.py): normwise {err5:.3e}", flush=True)
    if not err5 <= 1e-5:
        fail(f"n=500 bw=5 answer off the float64 oracle by {err5:.3e}")

    def check_results(results, residual_bw=0):
        for label, a, b, x, got, want in results:
            res = float(relative_residual(a, b, x, bw=residual_bw))
            print(f"  {label:52s} dispatch {got}  residual {res:.3e}", flush=True)
            if got != want:
                fail(f"{label}: dispatched {got}, expected {want}")
            if x.shape != b.shape or not bool(torch.isfinite(x).all()):
                fail(f"{label}: result of shape {tuple(x.shape)} or non-finite")
            if not res <= solvers.VERIFY_RESIDUAL_DEFAULT_BOUND:
                fail(f"{label}: residual {res:.3e} > {solvers.VERIFY_RESIDUAL_DEFAULT_BOUND}")

    def zero(wrappers):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0

    def read(wrappers, expected, label):
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items()}
        print(f"  launches on the {label}: {got} (expected {expected})", flush=True)
        if got != expected or min(got.values()) < 1:
            fail(f"{label} launch counters {got}, expected {expected}, each at least 1")
        return got

    print("phase 4c: batched dense path", flush=True)
    dwrappers = {"batched_lu_vmem": batched_lu.batched_lu_vmem,
                 "batched_lu_solve_vmem": batched_lu.batched_lu_solve_vmem}
    dcases = [(bsz, n, m, stack(bsz, n, 900 + n), rhs_stack(bsz, n, m, 950 + n + m))
              for bsz, n in BATCHED_DENSE for m in (1, n)]
    zero(dwrappers)
    dresults = []
    with solvers.record_dispatches() as log:
        for bsz, n, m, a, b in dcases:
            for enrich in (False, True):
                mark = len(log)
                if enrich:
                    x = ops.lu_solve(ops.lu(a, enrich=True), b)
                else:
                    x = ops.linear_solve(a, b)
                label = f"{'lu(enrich)+lu_solve' if enrich else 'linear_solve'} B={bsz} n={n} m={m}"
                dresults.append((label, a, b, x, [nm for _, nm in log[mark:]], ["cuda_vmem"] * 2))
    calls = 2 * len(dcases)
    batched_launches = read(dwrappers, {k: calls for k in dwrappers}, "batched dense path")
    check_results(dresults)
    bsz, n, _, a, b = dcases[0]
    want = ref.batched_solve_ref(ref.batched_lu_ref(a.double().cpu().numpy()), b.double().cpu().numpy())
    err = float(np.abs(dresults[0][3].double().cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  B={bsz} n={n} m=1 against the float64 oracle (kernels/ref.py): normwise {err:.3e}", flush=True)
    if not err <= 1e-5:
        fail(f"B={bsz} n={n} answer off the float64 oracle by {err:.3e}")

    print("phase 4d: the EbV-preconditioned optimizer", flush=True)

    def whisper_tiny_tree(gen):
        """Parameters of configs/whisper_tiny.py as models/lm.py:init_params
        lays them out: bf16 weights, fp32 norm scales; the per-layer leaves
        stacked over the layers (3-D, so AdamW steps them)."""
        L, ff = WHISPER["layers"], WHISPER["ff"]
        shapes = {"embed": (vocab, d), "unembed": (d, vocab), "ln_f.scale": (d,),
                  "enc_ln_f.scale": (d,)}
        for pre, cross in (("blocks", True), ("enc_blocks", False)):
            for att in ("attn", "cross") if cross else ("attn",):
                for w in ("wq", "wk", "wv", "wo"):
                    shapes[f"{pre}.{att}.{w}"] = (L, d, d)
            for ln in ("ln_attn", "ln_cross", "ln_mlp") if cross else ("ln_attn", "ln_mlp"):
                shapes[f"{pre}.{ln}.scale"] = (L, d)
            shapes[f"{pre}.mlp.wu"], shapes[f"{pre}.mlp.wd"] = (L, d, ff), (L, ff, d)
        out = {}
        for name, shape in sorted(shapes.items()):
            if name.endswith("scale"):
                out[name] = torch.ones(shape, device=dev)
            else:
                scale = 0.02 if name == "embed" else shape[-2] ** -0.5
                out[name] = (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
        return out

    def draw_grads(params, gen):
        for p in params.values():
            p.grad = torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)

    solves = []  # (a3, r3, x3) of every preconditioner solve in the run

    def recording(fn):
        def linear_solve(a, b, **kw):
            x = fn(a, b, **kw)
            solves.append((a, b, x))
            return x
        return linear_solve

    gen = torch.Generator(device=dev).manual_seed(2024)
    trees = {"whisper-tiny": {k: torch.nn.Parameter(v) for k, v in whisper_tiny_tree(gen).items()},
             f"opt_step_d{OPT_D}": {f"w{i}": torch.nn.Parameter(0.02 * torch.randn(
                 (OPT_D, OPT_D), generator=gen, device=dev)) for i in range(OPT_LEAVES)}}
    nparams = sum(p.numel() for p in trees["whisper-tiny"].values())
    print(f"  whisper-tiny tree: {len(trees['whisper-tiny'])} leaves, {nparams} parameters", flush=True)
    opts = {name: train.EbvPreconditioned(list(ps.values()), lr=train.warmup_cosine(3e-4, 2, OPT_STEPS))
            for name, ps in trees.items()}
    start = {name: {k: p.detach().clone() for k, p in ps.items()} for name, ps in trees.items()}
    first_grads = {}
    plain_ls = ops.linear_solve
    ops.linear_solve = recording(plain_ls)
    zero(dwrappers)
    oresults = []
    try:
        with solvers.record_dispatches() as log:
            for name, ps in trees.items():
                for step in range(OPT_STEPS):
                    draw_grads(ps, gen)
                    if step == 0:
                        first_grads[name] = {k: p.grad.clone() for k, p in ps.items()}
                    mark = len(log)
                    opts[name].step()
                    oresults.append((f"{name} step {step + 1}",
                                     [(p.op, p.n, p.batch, p.rhs, nm) for p, nm in log[mark:]]))
    finally:
        ops.linear_solve = plain_ls
    opt_launches = read(dwrappers, {k: 3 * OPT_STEPS for k in dwrappers}, "optimizer path")
    for k in dwrappers:
        batched_launches[k] += opt_launches[k]
    # whisper-tiny: the stacked norm scales (L, d) are 2-D too, one order-L
    # group of five systems; embed and unembed the order-d group of two
    L = WHISPER["layers"]
    want_log = {"whisper-tiny": [("factor", L, 5, 0, "cuda_vmem"), ("solve", L, 5, d, "cuda_vmem"),
                                 ("factor", d, 2, 0, "cuda_vmem"), ("solve", d, 2, vocab, "cuda_vmem")],
                f"opt_step_d{OPT_D}": [("factor", OPT_D, OPT_LEAVES, 0, "cuda_vmem"),
                                       ("solve", OPT_D, OPT_LEAVES, OPT_D, "cuda_vmem")]}
    for label, got in oresults:
        print(f"  {label:24s} dispatch {got}", flush=True)
        if got != want_log[label.split(" step")[0]]:
            fail(f"{label}: dispatched {got}")
    for a3, r3, x3 in solves:
        res = float(relative_residual(a3, r3, x3))
        print(f"  preconditioner solve {tuple(r3.shape)}: worst system's residual {res:.3e}", flush=True)
        if x3.shape != r3.shape or not bool(torch.isfinite(x3).all()) or not res <= 1e-4:
            fail(f"preconditioner solve {tuple(r3.shape)}: residual {res:.3e} or non-finite")
    for name, ps in trees.items():
        for k, p in ps.items():
            if not bool(torch.isfinite(p).all()) or torch.equal(p.detach(), start[name][k]):
                fail(f"{name} {k}: not finite or not updated")
    # the optimizer's own systems through the kernels and their plain versions
    a3, r3, _ = next(s for s in solves if s[0].shape[-1] == d)
    lu3 = batched_lu.batched_lu_vmem(a3)
    compare_bitwise("batched_lu_vmem", f"optimizer B=2 n={d}", lu3, batched_lu.batched_lu_plain(a3))
    compare_bitwise("batched_lu_solve_vmem", f"optimizer m={vocab}",
                    batched_lu.batched_lu_solve_vmem(lu3, r3), batched_lu.batched_lu_solve_plain(lu3, r3))
    # the d128 tree's first step on the card against the same step on the CPU
    name = f"opt_step_d{OPT_D}"
    cps = {k: torch.nn.Parameter(v.cpu().clone()) for k, v in start[name].items()}
    copt = train.EbvPreconditioned(list(cps.values()), lr=train.warmup_cosine(3e-4, 2, OPT_STEPS))
    for k, p in cps.items():
        p.grad = first_grads[name][k].cpu()
    copt.step()
    gps = {k: torch.nn.Parameter(v.clone()) for k, v in start[name].items()}
    gopt = train.EbvPreconditioned(list(gps.values()), lr=train.warmup_cosine(3e-4, 2, OPT_STEPS))
    for k, p in gps.items():
        p.grad = first_grads[name][k].clone()
    gopt.step()
    for k in cps:
        du = gps[k].detach().cpu() - start[name][k].cpu()
        dc = cps[k].detach() - start[name][k].cpu()
        err = float((du - dc).abs().max() / dc.abs().max())
        print(f"  {name} step 1 {k}: update on the card vs the CPU, normwise {err:.3e}", flush=True)
        if not err <= 1e-4:
            fail(f"{name} {k}: the card's step differs from the CPU's by {err:.3e}")

    print("phase 4e: batched banded path (the CFD ensemble)", flush=True)
    ewrappers = {"batched_banded_lu_vmem": banded.batched_banded_lu_vmem,
                 "batched_banded_solve_vmem": banded.batched_banded_solve_vmem}
    ecases = [(bsz, n, bw, a, rhs_stack(bsz, n, 1, 960 + n)) for (bsz, n, bw), a in ensembles.items()]
    small = (4, 500, 5)
    ecases.append((*small, band_stack(*small, 970), rhs_stack(small[0], small[1], 1, 971)))
    zero(ewrappers)
    eresults = []
    with solvers.record_dispatches() as log:
        for bsz, n, bw, a, b in ecases:
            mark = len(log)
            x = ops.banded_linear_solve(a, b, bw=bw)
            eresults.append((f"banded_linear_solve B={bsz} n={n} bw={bw} m=1", a, b, x, bw,
                             [nm for _, nm in log[mark:]]))
    ens_launches = read(ewrappers, {k: len(ecases) for k in ewrappers}, "batched banded path")
    batched_launches.update(ens_launches)
    for label, a, b, x, bw, got in eresults:
        check_results([(label, a, b, x, got, ["cuda_vmem"] * 2)], residual_bw=bw)
    bsz, n, bw, a, b = ecases[-1]
    want = ref.batched_banded_solve_ref(ref.batched_banded_lu_ref(a.double().cpu().numpy(), bw),
                                        b.double().cpu().numpy(), bw)
    err = float(np.abs(eresults[-1][3].double().cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  B={bsz} n={n} bw={bw} against the float64 oracle (kernels/ref.py): normwise {err:.3e}",
          flush=True)
    if not err <= 1e-5:
        fail(f"B={bsz} n={n} bw={bw} answer off the float64 oracle by {err:.3e}")

    # ---- 5. times --------------------------------------------------------
    print(f"phase 5: times (ms, median of {REPS} after 1 warm-up; card: {card})", flush=True)

    def timed(fn):
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
        return statistics.median(times)

    def library(fn):
        try:
            return timed(fn)
        except (RuntimeError, NotImplementedError) as err:  # a yardstick only
            print(f"    library call unavailable: {err}", flush=True)
            return None

    def kernel_breakdown(fn):
        """(kernel name, device µs, launches) of one call, largest first: the
        device's own events (kernels, copies), not the host ops that launched
        them, so the times add up to the device's busy time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.self_device_time_total > 0 and e.device_type != DeviceType.CPU
                and not getattr(e, "is_user_annotation", False)]  # a span over kernels listed anyway
        if not rows:
            print("    the profiler saw no device time: not measured", flush=True)
        return sorted(rows, key=lambda r: -r[1])

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    rows = {}

    def record(name, shape, ms, plain_ms, lib_ms, flops, nbytes, per_call):
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        b_ms, b_by = bound(flops, nbytes)
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
        print(f"  {name:15s} {shape:12s} kernel {ms:.4f}  plain {fmt(plain_ms)}  library {fmt(lib_ms)}  "
              f"bound {b_ms:.4f} ({b_by})  launches/call {per_call}  peak {peak:.0f} MiB", flush=True)
        rows[(name, shape)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                   bound_by=b_by, per_call=per_call)
        torch.cuda.reset_peak_memory_stats()

    def per_call(wrapper, fn):
        """Launches one call of ``fn`` adds to ``wrapper``'s counter."""
        before = wrapper.launches
        fn()
        return wrapper.launches - before

    torch.cuda.reset_peak_memory_stats()
    for n in SIZES:
        a = matrix(n, n)
        plain = timed(lambda: ebv_lu.lu_fused_plain(a)) if n <= 2000 else None
        lib = library(lambda: torch.linalg.lu_factor(a, pivot=False))
        kernel = lambda: ebv_lu.lu_fused(a)
        record("lu_fused", f"n={n}", timed(kernel), plain, lib,
               2 * n**3 / 3, 2 * n * n * 4, per_call(ebv_lu.lu_fused, kernel))
    for n in SIZES:
        lu = lus[n]
        piv = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
        linv, uinv = inverses[n]
        S, B = linv.shape[0], linv.shape[1]
        for m in (1, WIDE):
            b = rhs(n, m, 9)
            b2 = b[:, None] if m == 1 else b
            lib = library(lambda: torch.linalg.lu_solve(lu, piv, b2))
            # the two triangular sweeps: 2n^2 m flops, the LU read once, b in, x out
            sweep = (2 * m * n * n, n * n * 4 + 2 * n * m * 4)
            if n <= 2000:
                kernel = lambda: trsm.solve_vmem(lu, b)
                record("solve_vmem", f"n={n} m={m}", timed(kernel),
                       timed(lambda: trsm.solve_vmem_plain(lu, b)), lib, *sweep,
                       per_call(trsm.solve_vmem, kernel))
            if n >= 2000:
                kernel = lambda: trsm.solve_tiled(lu, b)
                record("solve_tiled", f"n={n} m={m}", timed(kernel),
                       timed(lambda: trsm.solve_tiled_plain(lu, b)), lib, *sweep,
                       per_call(trsm.solve_tiled, kernel))
                # the same sweeps; the bytes add the (S, B, B) inverses it reads
                kernel = lambda: trsm.solve_inverted(lu, linv, uinv, b)
                record("solve_inverted", f"n={n} m={m}", timed(kernel),
                       timed(lambda: dense_inverted_solve(lu, linv, uinv, b)), lib,
                       sweep[0], sweep[1] + 2 * S * B * B * 4, per_call(trsm.solve_inverted, kernel))

    # banded kernels at the banded main path's shapes; no PyTorch call
    # factors or solves a band, so there is no library yardstick
    print("  banded: library none (PyTorch has no band factor or band solve)", flush=True)
    bands = {(n, bw): a for n, bw, _, a in bcases}
    band_lu = {}
    for (n, bw), a in bands.items():
        # n (2bw^2 + bw) flops; the band read once and the factor written once
        work = (n * (2 * bw * bw + bw), 2 * n * (2 * bw + 1) * 4)
        plain = timed(lambda: banded.banded_lu_plain(a, bw=bw)) if n != pn else plain_once[f"n={n} bw={bw}"]
        for name in ("banded_lu_blocked", "banded_lu_tiled"):
            kernel = (lambda fn=bwrappers[name]: fn(a, bw=bw))
            record(name, f"n={n} bw={bw}", timed(kernel), plain, None, *work,
                   per_call(bwrappers[name], kernel))
        band_lu[(n, bw)] = banded.banded_lu_blocked(a, bw=bw)
    for n, bw, m, _ in bcases:
        lu, b = band_lu[(n, bw)], rhs(n, m, 13)
        # the two sweeps need ~4 n bw m flops; the factors, b and x cross once
        flops, nbytes = 4 * n * bw * m, n * (2 * bw + 1) * 4 + 2 * n * m * 4
        kernel = lambda: banded.banded_solve_kernelized(lu, b, bw=bw)
        plain = (timed(lambda: banded_solve_blocked(lu, b, bw=bw)) if n != pn
                 else plain_once[f"n={n} bw={bw} m={m}"])
        record("banded_solve_kernelized", f"n={n} bw={bw} m={m}", timed(kernel), plain, None,
               flops, nbytes, per_call(banded.banded_solve_kernelized, kernel))
    f16 = factorize_banded(band_lu[SHOOTOUT], bw=SHOOTOUT[1])
    S, C = f16.linv.shape[0], f16.linv.shape[1]
    n, bw = SHOOTOUT
    for m in (1, WIDE):
        b = rhs(n, m, 14)
        args = (f16.linv, f16.uinv, f16.tlo, f16.tup, b)
        kernel = lambda: banded.banded_solve_inverted(*args, n=n, bw=bw)
        # the bytes read linv/uinv (S, C, C) and tlo/tup (S, C, bw) instead of the band
        nbytes = (2 * S * C * C + 2 * S * C * bw) * 4 + 2 * n * m * 4
        record("banded_solve_inverted", f"n={n} bw={bw} m={m}", timed(kernel),
               timed(lambda: banded_inverted_solve(*args, n=n, bw=bw)), None, 4 * n * bw * m, nbytes,
               per_call(banded.banded_solve_inverted, kernel))

    # batched kernels at the batched paths' shapes; library: batched
    # torch.linalg.lu_factor(pivot=False) for B9 and lu_solve with identity
    # pivots for B10; none for the band kernels (B11, B12)
    for (bsz, n), a in bstacks.items():
        # 2n^3/3 flops per system; the stack read once and its factor written once
        work = (bsz * 2 * n ** 3 / 3, 2 * bsz * n * n * 4)
        kernel = lambda: batched_lu.batched_lu_vmem(a)
        plain = (timed(lambda: batched_lu.batched_lu_plain(a)) if n <= 256
                 else once(lambda: batched_lu.batched_lu_plain(a))[1])
        record("batched_lu_vmem", f"B={bsz} n={n}", timed(kernel), plain,
               library(lambda: torch.linalg.lu_factor(a, pivot=False)), *work,
               per_call(batched_lu.batched_lu_vmem, kernel))
    for (bsz, n), lu in blus.items():
        piv = torch.arange(1, n + 1, dtype=torch.int32, device=dev).expand(bsz, n).contiguous()
        for m in ((vocab,) if n == d else (1, n)):
            b = rhs_stack(bsz, n, m, 980 + n + m)
            b3 = b[..., None] if m == 1 else b
            # 2n^2 m flops per system; the factors, b and x cross once
            work = (bsz * 2 * n * n * m, bsz * (n * n + 2 * n * m) * 4)
            kernel = lambda: batched_lu.batched_lu_solve_vmem(lu, b)
            plain = (timed(lambda: batched_lu.batched_lu_solve_plain(lu, b)) if n * m <= 256 * 256
                     else once(lambda: batched_lu.batched_lu_solve_plain(lu, b))[1])
            record("batched_lu_solve_vmem", f"B={bsz} n={n} m={m}", timed(kernel), plain,
                   library(lambda: torch.linalg.lu_solve(lu, piv, b3)), *work,
                   per_call(batched_lu.batched_lu_solve_vmem, kernel))
    a = bstacks[BATCHED_DENSE[-1]]
    slot = solvers.get_backend("factor", "batched_dense", "torch")
    _, slot_ms = once(lambda: slot.call(solvers.Problem.from_arrays("factor", a), a))
    print(f"  the reference's slot past its cap, the plain fused_blocked_lu per system "
          f"(torch slot), B={a.shape[0]} n={a.shape[1]}, one call: {slot_ms:.1f} ms", flush=True)
    for (bsz, n, bw), a in ensembles.items():
        shape = f"B={bsz} n={n} bw={bw}"
        kernel = lambda: banded.batched_banded_lu_vmem(a, bw=bw)
        record("batched_banded_lu_vmem", shape, timed(kernel), eplain_ms[shape], None,
               bsz * n * (2 * bw * bw + bw), 2 * bsz * n * (2 * bw + 1) * 4,
               per_call(banded.batched_banded_lu_vmem, kernel))
        lu, b = eplain[(bsz, n, bw)], rhs_stack(bsz, n, 1, 990 + n)
        kernel = lambda: banded.batched_banded_solve_vmem(lu, b, bw=bw)
        record("batched_banded_solve_vmem", shape + " m=1", timed(kernel), eplain_ms[shape + " m=1"],
               None, bsz * 4 * n * bw, bsz * (n * (2 * bw + 1) + 2 * n) * 4,
               per_call(banded.batched_banded_solve_vmem, kernel))
    print("  optimizer step (host clock around a synchronized step, median of 3):", flush=True)
    opt_ms = {}
    for name, ps in trees.items():
        times = []
        for _ in range(3):
            draw_grads(ps, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opts[name].step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        opt_ms[name] = statistics.median(times)
        print(f"    {name:16s} {opt_ms[name]:.3f} ms (card: {card})", flush=True)

    print("  device time by kernel (torch.profiler, one call after a warm-up):", flush=True)
    a8 = matrix(8000, 8000)
    b8 = rhs(8000, 1, 11)
    ap = bands[(pn, POISSON_NX)]
    pfactor = bwrappers[factor_wrapper[banded_static_impl(POISSON_NX)]]
    for label, fn in (("lu_fused n=8000", lambda: ebv_lu.lu_fused(a8)),
                      ("solve_tiled n=8000 m=1", lambda: trsm.solve_tiled(lus[8000], b8)),
                      (f"{pfactor.__name__} n={pn} bw={POISSON_NX}", lambda: pfactor(ap, bw=POISSON_NX)),
                      ("whisper-tiny optimizer step", lambda: opts["whisper-tiny"].step())):
        rows_k = kernel_breakdown(fn)
        busy = sum(us for _, us, _ in rows_k) / 1e3
        print(f"    {label:24s} device busy {busy:.3f} ms in all, the {min(len(rows_k), 12)} "
              "largest:", flush=True)
        if label.endswith("optimizer step") and busy > 0:
            step = opt_ms["whisper-tiny"]
            print(f"    {label:24s} against the {step:.3f} ms step (host clock): idle share "
                  f"{max(0.0, 1 - busy / step):.3f}", flush=True)
        for name, us, count in rows_k[:12]:
            print(f"    {label:24s} {name[:48]:48s} {us / 1e3:9.3f} ms  x{count}", flush=True)

    print("  cuda_vmem / cuda_tiled crossover (kernel ms):", flush=True)
    for n in (500, 1000, 2000, 4000, 8000):
        lu = lus[n] if n in lus else ebv_lu.lu_fused(matrix(n, n))
        for m in (1, WIDE):
            b = rhs(n, m, 10)
            tv, tt = timed(lambda: trsm.solve_vmem(lu, b)), timed(lambda: trsm.solve_tiled(lu, b))
            print(f"    n={n:5d} m={m:3d}  solve_vmem {tv:.4f}  solve_tiled {tt:.4f}  "
                  f"faster: {'solve_vmem' if tv <= tt else 'solve_tiled'}", flush=True)

    print("  cuda_blocked / cuda_tiled crossover (kernel ms):", flush=True)
    for bw in (5, 8, 12, 16):
        for n in (4000, 16384, 65536):
            a = bands.get((n, bw))
            a = band(n, bw, 800 + n) if a is None else a
            tb = timed(lambda: banded.banded_lu_blocked(a, bw=bw))
            tt = timed(lambda: banded.banded_lu_tiled(a, bw=bw))
            print(f"    n={n:5d} bw={bw:3d}  banded_lu_blocked {tb:.4f}  banded_lu_tiled {tt:.4f}  "
                  f"faster: {'cuda_blocked' if tb <= tt else 'cuda_tiled'}  "
                  f"static rule: {banded_static_impl(bw)}", flush=True)

    # ---- 6. kernels line + result ----------------------------------------
    shoot = f"n={SHOOTOUT[0]} bw={SHOOTOUT[1]}"
    ens = f"B={ENSEMBLE_MEMBERS} n={ENSEMBLE_NX ** 2} bw={ENSEMBLE_NX}"
    line_shape = {"lu_fused": "n=2000", "solve_vmem": f"n=2000 m={WIDE}",
                  "solve_tiled": f"n=8000 m={WIDE}", "solve_inverted": f"n=8000 m={WIDE}",
                  "banded_lu_blocked": "n=16000 bw=5", "banded_lu_tiled": shoot,
                  "banded_solve_kernelized": f"{shoot} m={WIDE}", "banded_solve_inverted": f"{shoot} m={WIDE}",
                  "batched_lu_vmem": f"B=2 n={d}", "batched_lu_solve_vmem": f"B=2 n={d} m={vocab}",
                  "batched_banded_lu_vmem": ens, "batched_banded_solve_vmem": f"{ens} m=1"}
    source = {"lu_fused": "src/repro_torch/csrc/ebv_lu.cu", "solve_vmem": "src/repro_torch/csrc/trsm.cu",
              "solve_tiled": "src/repro_torch/csrc/trsm.cu", "solve_inverted": "src/repro_torch/csrc/trsm.cu",
              **dict.fromkeys(bwrappers, "src/repro_torch/csrc/banded.cu"),
              **dict.fromkeys(dwrappers, "src/repro_torch/csrc/batched_lu.cu"),
              **dict.fromkeys(ewrappers, "src/repro_torch/csrc/banded.cu")}
    replaces = {"lu_fused": "src/repro/kernels/ebv_lu.py:349", "solve_vmem": "src/repro/kernels/trsm.py:62",
                "solve_tiled": "src/repro/kernels/trsm.py:160",
                "solve_inverted": "src/repro/kernels/trsm.py:251",
                "banded_lu_blocked": "src/repro/kernels/banded.py:129",
                "banded_lu_tiled": "src/repro/kernels/banded.py:173",
                "banded_solve_kernelized": "src/repro/kernels/banded.py:260",
                "banded_solve_inverted": "src/repro/kernels/banded.py:324",
                "batched_lu_vmem": "src/repro/kernels/batched_lu.py:28",
                "batched_lu_solve_vmem": "src/repro/kernels/batched_lu.py:66",
                "batched_banded_lu_vmem": "src/repro/kernels/banded.py:393",
                "batched_banded_solve_vmem": "src/repro/kernels/banded.py:430"}
    launches.update(batched_launches)
    kernels = []
    for name in {**wrappers, **bwrappers, **dwrappers, **ewrappers}:
        row = rows[(name, line_shape[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": source[name], "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": line_shape[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
