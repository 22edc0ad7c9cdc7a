#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the CUDA sources under ``src/repro_torch/csrc`` with ``nvcc``;
3. kernels against their plain PyTorch versions on the card;
4. the main path — ``repro_torch.kernels.ops.linear_solve`` at
   n = 500, 2000, 8000 (the paper's dense sizes) with a vector and a
   64-wide RHS, then ``lu(enrich=True)`` + ``lu_solve(impl="cuda_inverted")``
   at n = 8000 — with the kernels' launch counters set to 0 just before and
   read just after; checks the dispatches, the counters, the residuals and
   the n = 500 answer against the float64 oracle;
5. times: each kernel, its plain version and a PyTorch library yardstick
   at the main path's shapes (CUDA events, median of 5 runs after one
   warm-up), the bound, launches per call and peak memory; the
   ``cuda_vmem`` / ``cuda_tiled`` crossover;
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
    from repro_torch.kernels import _build, ebv_lu, ops, ref, trsm

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

    # ---- 4. the main path ------------------------------------------------
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
        """(kernel name, device µs, launches) of one call, largest first."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.self_device_time_total > 0]
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

    print("  device time by kernel (torch.profiler, one call after a warm-up):", flush=True)
    a8 = matrix(8000, 8000)
    b8 = rhs(8000, 1, 11)
    for label, fn in (("lu_fused n=8000", lambda: ebv_lu.lu_fused(a8)),
                      ("solve_tiled n=8000 m=1", lambda: trsm.solve_tiled(lus[8000], b8))):
        for name, us, count in kernel_breakdown(fn):
            print(f"    {label:24s} {name[:48]:48s} {us / 1e3:9.3f} ms  x{count}", flush=True)

    print("  cuda_vmem / cuda_tiled crossover (kernel ms):", flush=True)
    for n in (500, 1000, 2000, 4000, 8000):
        lu = lus[n] if n in lus else ebv_lu.lu_fused(matrix(n, n))
        for m in (1, WIDE):
            b = rhs(n, m, 10)
            tv, tt = timed(lambda: trsm.solve_vmem(lu, b)), timed(lambda: trsm.solve_tiled(lu, b))
            print(f"    n={n:5d} m={m:3d}  solve_vmem {tv:.4f}  solve_tiled {tt:.4f}  "
                  f"faster: {'solve_vmem' if tv <= tt else 'solve_tiled'}", flush=True)

    # ---- 6. kernels line + result ----------------------------------------
    line_shape = {"lu_fused": "n=2000", "solve_vmem": f"n=2000 m={WIDE}",
                  "solve_tiled": f"n=8000 m={WIDE}", "solve_inverted": f"n=8000 m={WIDE}"}
    source = {"lu_fused": "src/repro_torch/csrc/ebv_lu.cu", "solve_vmem": "src/repro_torch/csrc/trsm.cu",
              "solve_tiled": "src/repro_torch/csrc/trsm.cu", "solve_inverted": "src/repro_torch/csrc/trsm.cu"}
    replaces = {"lu_fused": "src/repro/kernels/ebv_lu.py:349", "solve_vmem": "src/repro/kernels/trsm.py:62",
                "solve_tiled": "src/repro/kernels/trsm.py:160",
                "solve_inverted": "src/repro/kernels/trsm.py:251"}
    kernels = []
    for name in wrappers:
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
