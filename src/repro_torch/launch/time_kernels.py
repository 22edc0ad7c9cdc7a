"""Time the dense factor B1 (``kernels/ebv_lu.py:lu_fused``) and the rank-k
update B14 (``kernels/ebv_lu.py:update``) on the card, beside their library
calls (``torch.linalg.lu_factor(pivot=False)``, ``torch.addmm``), and the
dense solve B2 (``kernels/trsm.py:solve_vmem``) against the fewest rows a
block its plan takes (``trsm.VMEM_MIN_ROWS``, 32; 1 gives one block per SM).

    PYTHONPATH=src python src/repro_torch/launch/time_kernels.py

It runs as a file and imports ``repro_torch`` absolutely, so it times the
package that ``PYTHONPATH`` names: with another checkout's ``src`` there it
times that checkout's kernels, which is how two trees are compared on one
card in one call (run them A, B, B, A).  Each row is the median of 5 calls
between CUDA events after a warm-up call, and the mean of 20 calls back to
back between two events (the device's time without the host's before each
launch).  The first line is the card's name and power limit.
"""
import statistics
import subprocess
import sys

import torch

REPS = 5
BACK_TO_BACK = 20
FACTOR_SIZES = (500, 2000, 8000)
UPDATE_SHAPE = (1792, 256, 1792)  # (m, k, w): chip_smoke.py's B14 row
SOLVE_SIZES, SOLVE_WIDTHS, LEAST_ROWS = (500, 2000), (1, 64), (1, 16, 32, 64)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import ebv_lu, trsm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; repro_torch from {ebv_lu.__file__}", flush=True)
    dev = torch.device("cuda")
    for n in FACTOR_SIZES:
        g = torch.Generator(device=dev).manual_seed(n)
        a = torch.rand((n, n), generator=g, device=dev) * 2 - 1
        a.diagonal().copy_(a.abs().sum(dim=1) + 1)
        k1, k20 = timed(lambda: ebv_lu.lu_fused(a))
        l1, l20 = timed(lambda: torch.linalg.lu_factor(a, pivot=False))
        print(f"lu_fused n={n}: {k1:.4f} ms, {k20:.4f} back to back; lu_factor {l1:.4f}, {l20:.4f}", flush=True)
    m, k, w = UPDATE_SHAPE
    g = torch.Generator(device=dev).manual_seed(m)
    l21, u12, a22 = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, w), (m, w)))
    k1, k20 = timed(lambda: ebv_lu.update(l21, u12, a22))
    l1, l20 = timed(lambda: torch.addmm(a22, l21, u12, alpha=-1))
    print(f"update {UPDATE_SHAPE}: {k1:.4f} ms, {k20:.4f} back to back; addmm {l1:.4f}, {l20:.4f}", flush=True)
    if not hasattr(trsm, "VMEM_MIN_ROWS"):  # a tree whose B2 has no such plan
        return 0
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
