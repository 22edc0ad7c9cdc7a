#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense, banded and batched main paths, the
EbV-preconditioned optimizer, the legacy dense factors, the accuracy tiers,
the solve service, the LM serving engine and the trainer (the dense family,
whisper's encdec family, the moe family: mixtral, granite, the ssm family:
mamba2, and the hybrid family: hymba) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the CUDA sources under ``src/repro_torch/csrc`` with ``nvcc``;
3. kernels against their plain PyTorch versions on the card (B1 at every
   size the dense paths factor, n = 500, 1024, 2000 and 4096, also at
   n = 1, 100, 255 and 2049 and with ``block=50``, and at n = 8000 against
   the plain version or, if that would take over about a minute,
   ``lu_factor(pivot=False)``; B2 at n = 500, 1024, 2000, 2048, 4000 and
   8000 with 1, 8 and 64 RHS columns, each launch's plan checked against its
   Python mirror, and at n = 32000 (no room for a copy of a streamed
   diagonal tile) with 1 and 64 against ``solve_triangular``; B3 and
   B4 also at n = 1, 100 and 2049 with 1, 33 and 300 RHS columns; the band
   factors B5 and B6 bit for bit, B6 at the Poisson band on its cluster
   walk and at a bw = 600 band, past every cluster, on its device-memory
   walk; B7 at every band with 1 and 64 RHS columns); 3b B5 bit for bit on
   its warp walk (bw = 1, 2, 5, 11, 16, 31) and on the ring and
   device-memory walks (bw = 32, 200) at n = bw + 1, 2bw + 3, 257 and 4000,
   on bands with entries outside the matrix, the walk checked against
   ``band_lu_walk``, and on a zero pivot, and there too the batched band
   factor B11 (a stack of 3) and the scalar band factor B18 bit for bit on
   the walks they share with B5; 3c the batched kernels (B9-B12)
   at the batched paths' shapes (B11 and B12 at the three stacks of 4e, B12
   also system by system bitwise B7 on each alone, its plan checked), B9
   also where its plan changes, B10 also on both of its paths at shapes on
   either side of its plan's split (each plan checked against its Python
   mirror), B9 and B10 also at granite-moe-1b-a400m's EbV groups ((2, 24)
   with m = 1024 and (2, 1024) with m = 49280), mamba2-1.3b's ((5, 48)
   with m = 4096) and hymba-1.5b's ((8, 32) with m = 3200); 3d the legacy
   dense kernels (B14-B17) at the legacy paths' shapes, B14 also at ragged
   edges, fp32 and bf16, B15's U12 bit for bit (also the n = 8000 step in
   fp32 and bf16) and a U12 column holding an inf (fault C6: NaN throughout
   in U12 and A22, as in the plain version), B17 also at odd n,
   on each side of its resident/streamed split and on zero pivots (NaN and
   inf positions against the plain version's), and the legacy
   scalar band factor (B18) at the band the service escalates to it, finite,
   NaN-poisoned as the service's (its pivot 5) and with an inf in a pivot
   row's upper tail (fault C7: NaN and inf positions and finite values
   against the plain version's); 3e the
   paged decode attention (B13) at the served shape and at a decode-heavy
   one (32 rows of 4096 positions), fp32 and bf16, with holes, through its
   wrapper and forced onto clusters of every size, 1 to 16 CTAs, and so at
   whisper-tiny's served shape (8 rows of 28 pages, H = KV = 6, Dh = 64)
   and granite-moe-1b-a400m's (8 rows of 48 pages, H = 16, KV = 8, two
   query heads a KV head, Dh = 64);
   3f 70,000
   systems through B10 (n = 4, bit for bit) and B12 (n = 8, bw = 1, within
   1e-5, five systems bitwise B7) in one launch each (fault C8), and a
   tridiagonal band of 65,537 diagonal blocks (n = 2,097,157) through B8
   in six launches, within 1e-5 of B7 (fault C9); 3g the factors and
   solves on non-finite values (faults C10, C11: B1 at n = 40 with block 16
   and at n = 500, B9 at 3 x 24 and the optimizer's 2 x 384, B2, B3 and
   B10 at n = 40 and 2000, B7 and B12 at (97, 5) and (16000, 5)), NaN, inf
   and -inf positions equal to the plain versions' and the finite values
   within the tolerance or bit for bit, and B3 and B4 at n = 64 with
   4,194,305 RHS columns, 65,537 column tiles on one grid axis (fault C12);
   B8 also at the Poisson band, its tail scans on one warp bit for bit the
   block kernel's;
4. the main paths, each with its kernels' launch counters set to 0 just
   before and read just after:
   - dense: ``repro_torch.kernels.ops.linear_solve`` at n = 500, 2000,
     8000 (the paper's dense sizes) with a vector and a 64-wide RHS, then
     ``lu(enrich=True)`` + ``lu_solve(impl="cuda_inverted")`` at n = 8000;
   - banded: ``ops.banded_linear_solve`` on the paper's Table 1 bands
     (bw = 5, n = 500, 4000, 16000), the reference's banded shootout
     (n = 16384, bw = 16, m = 1 and 64) and the 5-point Poisson band of a
     256 x 256 grid (n = 65536, bw = 256) and a bw = 600 band (n = 2000,
     past every cluster of B6), then ``banded_lu(enrich=True)`` +
     ``banded_solve(impl="cuda_inverted")`` at n = 16384;
   - batched dense (4c): ``ops.linear_solve`` on stacks (B, n) = (8, 128),
     (32, 256) (the reference's autotune grid) and (8, 1024) (its cap),
     m = 1 and n, plain and ``lu(enrich=True)`` + ``lu_solve``;
   - the optimizer (4d): three ``EbvPreconditioned`` steps on the parameter
     tree of whisper-tiny (``configs/whisper_tiny.py`` as
     ``models/lm.py:init_params`` lays it out: one order-384 group of two
     systems with a (2, 384, 51968) RHS; its leaves' names, shapes, dtypes
     and order held to ``models/lm.py:_train_shapes``) and on the reference
     benchmark's four (128, 128) leaves, the gradients drawn from a seeded
     generator (phase 4k computes whisper-tiny's own);
   - batched banded (4e): ``ops.banded_linear_solve`` on 16 Table 1 bands
     (n = 16000, bw = 5) and a CFD ensemble of 32 five-point Poisson bands
     on a 64 x 64 grid (n = 4096, bw = 64), each with its own diagonal;
   - the legacy forced factors (4f): ``ops.linear_solve(impl="cuda_vmem")``
     at n = 500, 2000, 4096 and ``impl="cuda_blocked"`` at n = 500, 2000,
     8000; the exported ``kernels.ebv_lu.update`` (no op of the reference
     calls it) on the driver's first trailing block at n = 2000;
   - the accuracy tiers (4g): ``linear_solve(tolerance=1e-5)`` at n = 4096
     (``bf16_ir``), ``linear_solve(rank=256, tolerance=1e-3)`` on a rank-256
     operand at n = 2048 (``rand_lu``), one whisper-tiny
     ``EbvPreconditioned(solve_tolerance="auto")`` step (the batched
     ``bf16_ir``);
   - the solve service (4h): one ``SolveService`` on the card, four
     flushes of 8 requests on each of dense n = 1024, 2000, 4096 and
     Table 1's band n = 16000 (RHS widths 1 and 4 in turn), flush 2 mixed
     with a 1e-5 request, a rank-256 request, a NaN-poisoned and a
     zero-pivot n = 1024 matrix and a NaN-poisoned band (whose escalation
     runs B18); its flush-mates against an undisturbed service, bit for bit;
   - serving (4i): llama3-8b at full width (``configs/llama3_8b.py``, weights
     drawn on the card from a seed) through ``serve.Engine`` dense and paged
     (pages of 16) on the same 8 greedy requests (4 slots, bucket 16,
     prompts of 64-512 tokens, two sharing a 256-token prefix, one with an
     EOS token), the paged decode step's logits against the dense one's
     teacher-forced over 8 steps, and ``python -m repro_torch.launch.serve
     --arch llama3_8b --paged``;
   - training (4j; run after phase 5, whose decode step needs the serving
     model's memory): llama3-8b at full width cut to 4 layers, global batch
     8 x 512, 5 ``train.loop.make_train_step`` steps with AdamW and 5 with
     EbV, each from a fresh model on one repeated pipeline batch: (a) finite
     losses, the last below the first; (b) ``train_loss`` at step 0 against
     one full fp32 ``x @ unembed`` and ``F.cross_entropy``; (c) under EbV
     one batched factor and solve (B9, B10) per order group per step, the
     groups read from the leaf shapes (one of two order-4 systems, the
     stacked norm scales); (d) ``llama3_8b.reduced()`` in fp32, 3 steps on
     the card against the CPU, both optimizers, 1 and 2 microbatches; (e)
     ``repro_torch.launch.train --reduced --steps 6 --ckpt-every 2`` in this
     process, then ``python -m repro_torch.launch.train`` with the same
     flags from its checkpoints cut after step 4: it resumes at step 4 and
     its parameters equal the first run's; the
     step time (forward-backward and optimizer apart), tokens/s, the idle
     share, peak memory and the step's bound;
   - whisper-tiny (4k, after 4j): at full width and depth
     (``configs/whisper_tiny.py``, 4 + 4 layers, bf16, weights drawn on the
     card from a seed, the frontend's stub frames from seed 0): (a)
     ``serve.Engine`` dense and paged (pages of 16) on 16 greedy requests
     (8 slots, bucket 16, prompts of 16-224 and 32-224 new tokens, max_len
     448): tokens/s, ms per decode step, B13 launched ``num_layers`` times
     per paged decode step, the paged decode step's logits against the
     dense one's teacher-forced over 8 steps; (b) 5 AdamW and 5 EbV
     ``make_train_step`` steps on one repeated 64 x 448 batch: losses that
     fall, step time (forward-backward and optimizer apart), tokens/s
     against the bound, idle share, peak memory, and under EbV the order-4
     group of five stacked norm scales and the order-384 group of embed and
     unembed (m = 51968), each one factor (B9, two launches) and one solve
     (B10) a step; (c) ``whisper_tiny.reduced()`` in fp32, 3 steps on the
     card against the CPU, both optimizers, 1 and 2 microbatches; then
     ``python -m repro_torch.launch.serve --arch whisper_tiny --paged`` and
     ``python -m repro_torch.launch.train --arch whisper_tiny --optimizer
     ebv --steps 3`` on the card;
   - the moe family (4l, after 4k), weights drawn on the card from seeds:
     (a) mixtral-8x22b at full width (``configs/mixtral_8x22b.py``, bf16),
     its depth cut from 56 to 2 layers (10.8 GB), through ``serve.Engine``
     dense (the paged cache takes no sliding window) on 8 greedy requests
     (4 slots, bucket 16, prompts of 4,000-4,500 tokens, some prefilled at
     their exact length past the window, 128-256 new tokens, every row
     decoding past position 4096, max_len 8192), then 4 rows teacher-forced
     over 8 decode steps past the window against one full forward of each
     row with the window mask (capacity factor E / k: no drops; the decode
     steps take the full forward's router choices, and those that would
     differ are counted, each a near tie): normwise within 5e-2; (b) granite-moe-1b-a400m at
     full width and depth (``configs/granite_moe_1b_a400m.py``) served
     dense and paged on 16 greedy requests (8 slots, prompts of 64-512
     tokens, 32-256 new), B13 launched 24 times a paged decode step, the
     paged step's logits against the dense one's teacher-forced over 8
     steps (the paged step taking the dense step's router choices, those
     that would differ counted, each a near tie) within 5e-2; (c) 5 AdamW and 5 EbV
     ``make_train_step`` steps on one repeated 8 x 512 batch (B9 four and
     B10 two launches an EbV step: the order-24 and the order-1024 group),
     then one EbV step on 8 x 2560 = 20,480 tokens, a full group of 16,384
     and a tail of 4,096 through the MoE layer's grouped path; (d) both
     ``.reduced()`` configs in fp32, 3 steps on the card against the CPU,
     both optimizers, 1 and 2 microbatches; (e) ``python -m
     repro_torch.launch.serve --arch granite_moe_1b_a400m --paged`` and
     ``--arch mixtral_8x22b --reduced`` in two subprocesses at once;
   - the ssm and hybrid families (4m, after 4l), weights drawn on the card
     from seeds, nothing cut: (a) mamba2-1.3b (``configs/mamba2_1_3b.py``,
     48 layers, bf16) through ``serve.Engine`` dense (nothing to page) on
     16 greedy requests (8 slots, buckets of 64, prompts of 300-1,500
     tokens, each carrying pads, 64-128 new tokens), each of the first 8
     prompts' prefill padded to its bucket against its exact-length
     prefill (logits, conv tails, state; normwise within one bf16 unit,
     2^-8), and those 8 rows teacher-forced over 8 decode steps against
     one full forward of each (the recurrent update against the chunked
     scan), in bf16 and again with the model cast to fp32: fp32 within
     1e-4, and the bf16 decode no further from the fp32 full forward than
     1.25 times the bf16 full forward is; (b) hymba-1.5b
     (``configs/hymba_1_5b.py``, 32 layers, bf16) served dense on 8 requests (4 slots, prompts of 1,900-2,400 tokens,
     those whose bucket passes the window of 2048 prefilled at their exact
     length, 128 new tokens), 4 rows teacher-forced past the window under
     the same gates; (c) both trained, 5 AdamW and 5 EbV ``make_train_step``
     steps on one repeated 8 x 512 batch (B9 two and B10 one launch an
     EbV step: mamba2's order-48 group of five leaves, hymba's order-32
     group of eight); (d) both ``.reduced()`` configs in fp32, 3 steps on
     the card against the CPU, both optimizers, 1 and 2 microbatches; (e)
     ``python -m repro_torch.launch.serve --arch mamba2_1_3b`` and
     ``python -m repro_torch.launch.train --arch hymba_1_5b --optimizer
     ebv --steps 3`` in two subprocesses at once;
   checks the dispatches, the counters, the residuals and small answers
   against the float64 oracles;
5. times: each kernel, its plain version and a PyTorch library yardstick
   (where one exists) at the main paths' shapes (CUDA events, median of 5
   runs after one warm-up; the plain versions at the Poisson band one call,
   timed in phase 3, ``lu_vmem``'s at n = 4096 and the scalar band
   factor's one call), the bound,
   launches per call and peak memory;
   the ``cuda_vmem`` / ``cuda_tiled`` and ``cuda_blocked`` / ``cuda_tiled``
   crossovers (the latter also on wide bands, where ``cuda_tiled`` is B6's
   cluster walk); B2's plan and time a link; B17's, B16's and B9's time a
   pivot and resident share; B10's plan and time a strip, and each of its
   paths and cluster sizes beside batched ``lu_solve``; B11 and B18 beside
   the parent tree's times (``WALK_PARENT_MS``); B6's time a pivot
   and a group at the Poisson band over its CTAs and pivots a group, and
   its slab steps against its cluster walk at bw = 16, 32 and 64; B7 at
   Table 1's largest band, the shootout band (m = 64) and the Poisson band
   over its warps a block and staged strips, beside the per-warp kernel
   it replaced; B5, B11 and B18 on the warp walk (B11 over its systems
   and bw); B12 at its three stacks beside the per-warp kernel it ran
   before (the parent's kernel, in the same call), over its systems and
   warps a block at (16000, 5) and over its warps a block at 32 x (4096,
   64); B13 at both of its shapes over its CTAs a cluster
   (``src/repro_torch/launch/time_kernels.py``'s sweeps); the
   optimizer step's time; device time by kernel (B1, B3 and
   B4 at n = 8000 among them) and each dense factor and solve step's time
   beside the host's enqueue time per launch; B13 at the
   served and the decode-heavy shape and at whisper-tiny's and granite's
   served shapes; B9 and B10 at granite's, mamba2's and hymba's EbV
   groups; one
   full-width decode step against
   its weight-bytes bound, with its device idle share;
6. the ``kernels`` JSON line, the card line and the result line.

It prints no result and exits 1 where ``torch.cuda.is_available()`` is false.
"""
import dataclasses
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
# B2 (solve_vmem) in phase 3: the dense sizes up to the dispatch cap, the
# service's n = 1024 and 8-column flushes (phase 4h), n = 4000, where less
# than half the rows' columns fit shared memory, and n = 8000 (more than
# 132 blocks of 32 rows: the wide path)
VMEM_SOLVE_N, VMEM_SOLVE_M = (500, 1024, 2000, 2048, 4000, 8000), (1, 8, 64)
VMEM_LARGE_N = 32000  # B2 past the room for a copy of its diagonal tile
# B3 and B4 at shapes across their tiles (phase 3): n = 1, under one tile,
# ragged; RHS widths narrow (<= 4 columns), wide (<= 64) and several tiles
RAGGED_N, RAGGED_M = (1, 100, 2049), (1, 33, 300)
REPS = 5
BACK_TO_BACK = 20
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
# B6's cluster walk against the one-block walk B5 on bands past the slab of
# one block (bw >= 85 at the default step of 256 pivots), n = 16384
WIDE_BANDS = (32, 64, 85, 128, 169, 256)
# B5 in phase 3b: its warp walk's bands (bw <= 31: the tridiagonal, Table 1's
# bw = 5, the static rule's last bw = 11, 16 and 31) and the ring and
# device-memory walks past it (32, 200), each at n = bw + 1, 2bw + 3, 257, 4000
WALK_BANDS = (1, 2, 5, 11, 16, 31, 32, 200)
# B9 also where its plan changes (kernels/batched_lu.py:batched_lu_plan): the
# first n past one block's shared memory, odd n, n = 1000 with rows streamed
# below theta, 100 systems of 2-CTA clusters (more than the card holds at
# once) and 133 systems of one block each
BATCHED_EDGES = ((1, 241), (3, 385), (5, 1000), (100, 384), (133, 384))
# whisper-tiny: d_model 384, 4 + 4 layers, d_ff 1536 (configs/whisper_tiny.py);
# vocab 51865 padded to a multiple of 128 (models/lm.py:30-31)
WHISPER = dict(d=384, vocab=51968, layers=4, ff=1536)
OPT_STEPS = 3
OPT_D, OPT_LEAVES = 128, 4  # benchmarks/run.py:184-197, opt_step_d128
# (systems, n, bw) of the batched banded path: 16 of Table 1's largest band;
# the Poisson ensemble, 32 members on a 64 x 64 grid (bw = 64)
ENSEMBLE_T1 = (16, 16000, 5)
ENSEMBLE_NX, ENSEMBLE_MEMBERS = 64, 32
ENSEMBLE_SMALL = (4, 500, 5)  # four of Table 1's smallest band
# C8: a stack past a grid's y extent (65,535) for B10 and B12; C9: a
# tridiagonal band of 65,537 diagonal blocks of 32 rows for B8 (past z's)
C8_SYSTEMS, C9_ROWS = 70_000, 2_097_157
# C12: B3 and B4 on 65,537 column tiles of 64 (b, y and x 1.07 GB each)
WIDE_RHS = (64, 4_194_305)
# the legacy kernels: B14 and B15 against their plain versions normwise
# (their products sum in another order than cuBLAS); B16 and B17 bit for bit;
# bf16 B14 at the reference test's absolute tolerance (tests/test_kernels.py)
LEGACY_TOL = 1e-5
BF16_UPDATE_ATOL = 0.5
BF16_UPDATE_TOL = 2e-2  # normwise, a few bf16 units (tests/test_torch_cuda.py)
# B14 at ragged edges (no 16-byte rows at w = 33, 65), one element, a narrow tall block
UPDATE_EDGES = ((100, 7, 33), (129, 16, 65), (1, 1, 1), (1000, 256, 8))
VMEM_SIZES = (500, 2000, 4096)   # lu_vmem up to the reference's cap
# B17 also at odd n, at the cap less one, on each side of the resident /
# streamed split (every row in shared memory up to n = 2641 in fp32 and 3698
# in bf16), and on zero pivots: (n, row p made equal to row p-1, so pivot p
# is exactly zero; p = 0: a zero first pivot)
VMEM_EDGES = ((3, "float32"), (263, "float32"), (1001, "float32"), (4095, "float32"), (2641, "float32"),
              (2642, "float32"), (263, "bfloat16"), (1001, "bfloat16"), (3698, "bfloat16"),
              (3699, "bfloat16"), (4096, "bfloat16"))
VMEM_ZERO_PIVOTS = ((263, 0, "float32"), (1001, 700, "bfloat16"), (4096, 2000, "float32"))
# the whisper-tiny optimizer step before B9's cluster kernel (PERF.md section 5)
OPT_STEP_BEFORE_MS = 20.9
# B11 and B18 before the warp walk took bw <= 31: the ring walk's time, ms,
# median of 5 single calls by src/repro_torch/launch/time_kernels.py narrow
# on the tree before it (H100 80GB HBM3, 700 W; PERF.md section 6)
WALK_PARENT_MS = {"batched_banded_lu_vmem B=4 n=500 bw=5": 0.2197,
                  "batched_banded_lu_vmem B=16 n=16000 bw=5": 5.9142,
                  "batched_banded_lu_vmem B=32 n=4096 bw=64": 4.2601,
                  "banded_lu_kernelized n=16000 bw=5": 7.6982}
BLOCKED_SIZES = (500, 2000, 8000)
LEGACY_BLOCK, LEGACY_CT = 256, 256  # the driver's defaults (solvers/backends.py)
# the tiers: Table 2's largest size under the cap; the reference's
# rand_lu_n2048_k256 bench row
IR_N, IR_TOL = 4096, 1e-5
RANK_N, RANK_K = 2048, 256
# the service: serve_bench's n = 1024, the paper's 2000, the cap 4096 and
# Table 1's largest band; 8 requests each per flush, four flushes
SERVE_DENSE = (1024, 2000, 4096)
SERVE_BAND = (16000, 5)
SERVE_REQS, SERVE_FLUSHES = 8, 4
# serving (3e, 4i, 5): llama3-8b at full width on 4 slots, bucket 16, pages
# of 16; 8 greedy requests of 64-512 prompt tokens and 32-64 new tokens,
# two sharing a 256-token prefix; max_len 512 + 64
LM_ARCH, LM_SLOTS, LM_BUCKET, PAGE = "llama3_8b", 4, 16, 16
LM_REQS, LM_MAX_LEN, SHARED_PREFIX, TEACHER_STEPS = 8, 576, 256, 8
DECODE_HEAVY = (32, 256)  # rows x pages: 4096 positions a row
# B6's device-memory walk: a band no cluster's CTAs hold (bw past ~490), and
# the solve B7 on it (two staged strips); n = 2000 keeps the plain factor short
PAST_CLUSTERS = (2000, 600)
# B13 against its plain version, normwise: the sums run in another order;
# in bf16 p and the output round to bf16 (one unit 2^-8)
PAGED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the paged decode step's logits against the dense one's, normwise: bf16
# attention outputs that differ by a rounding, carried through 32 layers
LOGITS_TOL = 5e-2
# phase 4l (a), (b): a router choice made where another was replayed must be
# a near tie, its probability within ROUTE_GAP_TOL of the replayed one's (as
# tests/test_torch_moe.py holds bf16), and at most ROUTE_DIFFER_SHARE of the
# choices may differ
ROUTE_GAP_TOL, ROUTE_DIFFER_SHARE = 1e-2, 5e-2
# training (4j): llama3-8b at full width (configs/llama3_8b.py), its depth cut
# to 4 layers (32 do not fit 80 GB under EbV: ~24 B a parameter between its
# two passes); global batch 8 x 512 tokens, one repeated pipeline batch
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 512, 5
PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense
# (b) train_loss against one full fp32 logits product and F.cross_entropy,
# relative: the chunked CE's sums in another order; (d) 3 reduced fp32 steps
# on the card against the CPU, normwise a leaf; (e) a resumed run against an
# uninterrupted one, normwise a leaf: the embedding's backward sums by atomics
TRAIN_CE_TOL, TRAIN_CPU_TOL, TRAIN_RESUME_TOL = 1e-3, 1e-4, 1e-5
# (d) an entry whose gradient RMS over the steps is above 0 and under this
# share of its leaf's largest is round-off sized (the round-off: ~1e-6 of
# the leaf's largest, measured), and Adam, lr x m / sqrt(v), carries its
# sign at lr scale; such entries may make up at most LOOSE_SHARE of a leaf
# and are held to SPREAD_FACTOR times the most that gradients times
# (1 + GRAD_NOISE N(0, 1)) move them on the CPU in NOISE_DRAWS draws, or to
# TRAIN_CPU_TOL where that is larger.  An entry whose first step's gradient
# alone is that small on both sides (Adam's first step moves it by lr x
# g / |g|) is held to TRAIN_CPU_TOL against a CPU run whose first step takes
# the card's gradient on it
COND_GRAD, LOOSE_SHARE, GRAD_NOISE, NOISE_DRAWS, SPREAD_FACTOR = 1e-5, 1e-2, 1e-6, 3, 4.0
# whisper-tiny (3e, 4k, 5): at full width and depth (configs/whisper_tiny.py:
# 4 + 4 layers, d 384, 6 heads of Dh 64, one a KV head, d_ff 1536, vocab
# 51865, bf16), served on 8 slots (bucket 16, pages of 16) to 16 greedy
# requests of 16-224 prompt and 32-224 new tokens within whisper's decoder
# context of 448; trained on one repeated global batch of 64 x 448 tokens
WHISPER_ARCH, WHISPER_SLOTS, WHISPER_REQS, WHISPER_MAX_LEN = "whisper_tiny", 8, 16, 448
WHISPER_TRAIN = (64, 448)
# the moe family (3c, 3e, 4l, 5): granite-moe-1b-a400m at full width and
# depth (configs/granite_moe_1b_a400m.py: 24 layers, d 1024, 16 / 8 heads of
# Dh 64, 32 experts of d_ff 512, top-8, vocab 49155 padded to 49280, bf16),
# served on 8 slots (bucket 16, pages of 16) to 16 greedy requests of 64-512
# prompt and 32-256 new tokens (max_len 512 + 256), trained on one repeated
# 8 x 512 batch and once on 8 x 2560 = 20,480 tokens (a full group of 16,384
# tokens and a padded tail: models/moe.py:GROUP_TOKENS); under EbV its
# order-24 group (the stacked norm scales, m = 1024) and its order-1024 group
# (embed and unembed, m = 49280)
GRANITE_ARCH, GRANITE_SLOTS, GRANITE_REQS, GRANITE_MAX_LEN = "granite_moe_1b_a400m", 8, 16, 768
GRANITE_PROMPTS, GRANITE_NEW = (64, 512), (32, 256)
GRANITE = dict(d=1024, vocab=49280, layers=24)
GRANITE_LONG = (8, 2560)
# mixtral-8x22b (4l): at full width (configs/mixtral_8x22b.py: d 6144, 48 / 8
# heads of Dh 128, 8 experts of d_ff 16384, top-2, vocab 32768, window 4096,
# bf16), its depth cut from 56 to 2 layers, which keeps the whole run inside
# its time limit (one layer is ~2.50 G parameters, 5.0 GB; 56 are ~282 GB);
# served dense (the paged cache takes no window) on 4
# slots to 8 greedy requests of 4,000-4,500 prompt and 128-256 new tokens,
# every row decoding past position 4096, max_len 8192
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_SLOTS, MIXTRAL_REQS, MIXTRAL_MAX_LEN = "mixtral_8x22b", 2, 4, 8, 8192
MIXTRAL_PROMPTS, MIXTRAL_NEW = (4000, 4500), (128, 256)
# the batched kernels' stacks (B, n) beside the RHS widths the EbV
# optimizer's groups give B10: whisper-tiny's order 384 (embed and unembed,
# m = 51968), granite's order 24 (m = 1024) and 1024 (m = 49280)
# the ssm and hybrid families (3c, 4m, 5): mamba2-1.3b at full width and
# depth (configs/mamba2_1_3b.py: 48 layers, d 2048, d_inner 4096, 64 SSM heads
# of 64, state 128, chunk 256, conv 4, vocab 50280 padded to 50304, bf16),
# served dense (no attention cache to page) on 8 slots in buckets of 64 to 16
# greedy requests of 300-1,500 prompt tokens (none a multiple of 64: every
# prompt carries pads) and 64-128 new; hymba-1.5b at full width and depth
# (configs/hymba_1_5b.py: 32 layers, d 1600, 25 / 5 heads of Dh 64 in a
# window of 2048 beside 50 SSM heads of 64, state 16, d_ff 5504, vocab 32001
# padded to 32128, bf16), served dense (windows take no pages) on 4 slots to
# 8 requests of 1,900-2,400 prompt and 128 new tokens; both trained on one
# repeated 8 x 512 batch.  Under EbV mamba2's order-48 group (five stacked
# leaves, the widest its (48, 4096) norm scale) and hymba's order-32 group
# (eight, the widest (32, 3200))
SSM_ARCH, SSM_SLOTS, SSM_REQS, SSM_BUCKET, SSM_MAX_LEN = "mamba2_1_3b", 8, 16, 64, 1664
SSM_PROMPTS, SSM_NEW = (300, 1500), (64, 128)
SSM = dict(layers=48, d_inner=4096)
HYMBA_ARCH, HYMBA_SLOTS, HYMBA_REQS, HYMBA_MAX_LEN, HYMBA_NEW = "hymba_1_5b", 4, 8, 2560, 128
HYMBA_PROMPTS = (1900, 2400)
HYMBA = dict(layers=32, d_inner=3200)
# a prefill padded to its bucket against the same prompt's exact-length
# prefill, normwise (logits, conv tails, state): one bf16 unit, 2^-8, the
# least that GEMMs of another row count could round apart if the library
# took another kernel for them (measured 0 in every run on an H100)
PAD_TOL = 2.0 ** -8
# the teacher-forced check in fp32 (the models cast): the recurrent update
# against the chunked scan, sums in other orders (measured 1.0e-5 and 1.6e-5
# on an H100 for mamba2 and hymba)
SSM_F32_TOL = 1e-4
# in bf16: the served decode's distance from the fp32 full forward over the
# bf16 full forward's, normwise (measured 1.009 and 0.881 on an H100 for
# mamba2 and hymba: bf16 rounding through 48 / 32 layers, ~6-8e-2, either way)
DECODE_FLOOR_FACTOR = 1.25
GROUP_RHS = {(2, WHISPER["d"]): (WHISPER["vocab"],), (2, GRANITE["layers"]): (GRANITE["d"],),
             (2, GRANITE["d"]): (GRANITE["vocab"],), (5, SSM["layers"]): (SSM["d_inner"],),
             (8, HYMBA["layers"]): (HYMBA["d_inner"],)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def train_runs(dev, card: str, tag: str, cfg, batch, fresh, groups: dict, tokens: int, bounds) -> dict:
    """TRAIN_STEPS AdamW and TRAIN_STEPS EbV ``train.loop.make_train_step``
    steps, each run from ``fresh()`` on the repeated ``batch``: the step by
    CUDA events (the optimizer's apart; the median of the last 3), the host
    clock, tokens/s, one more step profiled (the device's busy time and
    largest operations, the idle share), peak memory and each of ``bounds``
    ((ms, what) pairs).  Fails unless the losses are finite and fall, and
    unless EbV runs one factor (B9, with its non-finite pass from n = 3)
    and one solve (B10) of each order group of ``groups`` ({order:
    systems}) a step, AdamW none.  Returns the EbV run's launches."""
    import gc
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import solvers, train
    from repro_torch.kernels import batched_lu
    from repro_torch.train import loop

    tc = loop.TrainConfig(steps=TRAIN_STEPS)
    wrappers = {"batched_lu_vmem": batched_lu.batched_lu_vmem,
                "batched_lu_solve_vmem": batched_lu.batched_lu_solve_vmem}
    launches = {}
    for name in ("adamw", "ebv"):
        params = fresh()
        opt = train.get_optimizer(name, list(params.values()),
                                  train.warmup_cosine(tc.learning_rate, 2, TRAIN_STEPS))
        step_fn = loop.make_train_step(cfg, opt)
        opt_events, plain_step = [], opt.step

        def timed_opt_step(closure=None, plain_step=plain_step, opt_events=opt_events):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = plain_step(closure)
            e.record()
            opt_events.append((s, e))
            return out

        opt.step = timed_opt_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        losses, step_ms, host_ms, logs = [], [], [], []
        with solvers.record_dispatches() as log:
            for _ in range(TRAIN_STEPS):
                mark = len(log)
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.record()
                met = step_fn(params, batch)
                e.record()
                losses.append(float(met["loss"]))
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                step_ms.append(s.elapsed_time(e))
                logs.append([(p.op, p.n, p.batch, nm) for p, nm in log[mark:]])
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        opt_ms = [a.elapsed_time(b) for a, b in opt_events]
        # the device's busy share over one more step, by torch.profiler; the
        # device's activity alone: device_ops reads nothing of the host's, whose
        # events took ~20 s more to collect and sum at mamba2's ~24,000 kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_fn(params, batch)
            torch.cuda.synchronize()
        ops = device_ops(prof)
        busy = sum(r[1] for r in ops)
        last = slice(TRAIN_STEPS - 3, TRAIN_STEPS)
        med, med_opt = statistics.median(step_ms[last]), statistics.median(opt_ms[last])
        med_host = statistics.median(host_ms[last])
        idle = f"{max(0.0, 1 - busy / med_host):.3f}" if busy > 0 else "not measured"
        bound = "; ".join(f"bound {what} = {ms:.2f} ms ({ms / med:.3f} of the step)" for ms, what in bounds)
        print(f"  {tag} {name}: losses {[round(v, 4) for v in losses]}; step {med:.1f} ms (events, median of "
              f"the last 3: forward-backward {med - med_opt:.1f}, optimizer {med_opt:.1f}), host clock "
              f"{med_host:.1f} ms, {tokens / med * 1e3:,.0f} tokens/s; device busy {busy:.1f} ms of a profiled "
              f"step, idle share {idle}; peak memory {peak / 1e9:.2f} GB (max_memory_allocated); {bound}; "
              f"card: {card}", flush=True)
        print(f"  {tag} {name}: a profiled step's largest device operations: "
              + ", ".join(f"{k[:48]} {v:.1f} ms x{c}" for k, v, c in ops[:6]), flush=True)
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            fail(f"{tag} {name}: losses {losses}: not finite or not falling")
        per_step = [(op, n, groups[n], "cuda_vmem") for n in sorted(groups) for op in ("factor", "solve")]
        # B9 adds its non-finite pass from n = 3 (kernels/batched_lu.py)
        want = ({"batched_lu_vmem": TRAIN_STEPS * sum(1 + (n >= 3) for n in groups),
                 "batched_lu_solve_vmem": TRAIN_STEPS * len(groups)} if name == "ebv"
                else dict.fromkeys(wrappers, 0))
        print(f"  {tag} {name}: launches {got} (expected {want}); dispatches a step {logs[0]}", flush=True)
        if got != want or logs != ([per_step] * TRAIN_STEPS if name == "ebv" else [[]] * TRAIN_STEPS):
            fail(f"{tag} {name}: launches {got} or dispatches {logs}")
        if name == "ebv":
            launches = got
        del params, opt, step_fn, prof
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def device_ops(prof) -> list:
    """(name, device ms, count) of a profile's device events, largest first:
    the device's own events (kernels, copies), not the host ops that
    launched them, so the times add up to the device's busy time."""
    from torch.autograd import DeviceType

    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.self_device_time_total > 0 and ev.device_type != DeviceType.CPU
            and not getattr(ev, "is_user_annotation", False)]  # a span over kernels listed anyway
    return sorted(rows, key=lambda r: -r[1])


def ebv_groups(shapes: dict) -> dict:
    """{order: systems} of the EbV optimizer's order groups over leaves of
    ``shapes`` ({name: (shape, dtype)}): 2-D, min(shape) <= 1024."""
    groups = {}
    for s, _ in shapes.values():
        if len(s) == 2 and min(s) <= 1024:
            groups[min(s)] = groups.get(min(s), 0) + 1
    return groups


def card_against_cpu(dev, tag: str, rcfg, start: dict, batches, cases) -> None:
    """``rcfg`` (a reduced fp32 config) on the CPU and on the card from the
    leaves ``start``: the first batch's gradients, then 3
    ``make_train_step`` steps of each (optimizer, microbatches, learning
    rate) of ``cases``; the gradients, the first moments ``mu`` and the
    leaves normwise a leaf, the losses relative.  Gated (TRAIN_CPU_TOL on
    the gradients, ``mu`` and the leaves, 1e-5 on the losses) at the
    trainer's default learning rate.  Adam moves an entry by about lr *
    sign(g) however small g is, so an entry whose gradient is round-off
    sized moves by the sign of the round-off.  Such entries, a gradient
    RMS (``nu``) on either side above 0 and under COND_GRAD of its leaf's
    largest, may make up at most LOOSE_SHARE of a leaf, and are held to
    the larger of TRAIN_CPU_TOL and SPREAD_FACTOR times the largest
    spread that NOISE_DRAWS more runs, on the CPU with every step's
    gradients times (1 + GRAD_NOISE xi), xi ~ N(0, 1), show on them.  An
    entry whose first step's gradient alone is round-off sized, under
    COND_GRAD of its leaf's largest on the CPU and on the card, has its
    first move, lr * g / |g|, set by that round-off's sign and later moves
    as any other: it is held to TRAIN_CPU_TOL against one more CPU run
    whose first step takes the card's gradient on those entries.  Every
    other entry is held to TRAIN_CPU_TOL.  ``batches(device)``: the 3
    steps' batches."""
    import math

    import torch

    from repro_torch import train
    from repro_torch.models import lm
    from repro_torch.train import loop

    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())

    def run(d, name, mb, lr, noise_seed=None, first_from=None):
        """The run on ``d``; ``noise_seed``: every step's gradients times
        (1 + GRAD_NOISE xi); ``first_from``: {leaf: (gradient, mask)} set
        into the first step's gradients.  Returns the first batch's
        gradients, the leaves, the losses, the moments and the first
        step's gradients as the optimizer took them."""
        ps = {k: torch.nn.Parameter(v.detach().clone().to(d)) for k, v in start.items()}
        steps = batches(d)
        grads = torch.autograd.grad(lm.train_loss(ps, steps[0], rcfg)[0], list(ps.values()))
        o = train.get_optimizer(name, list(ps.values()), train.warmup_cosine(lr, 2, 10))
        gen = torch.Generator().manual_seed(noise_seed) if noise_seed is not None else None
        step, first = o.step, {}

        def seen_step():
            with torch.no_grad():
                if not first:
                    for k, p in ps.items():
                        if first_from is not None:
                            g, mask = (t.to(d) for t in first_from[k])
                            p.grad[mask] = g[mask]
                        first[k] = p.grad.cpu().clone()
                if gen is not None:
                    for p in ps.values():
                        p.grad.mul_(1 + GRAD_NOISE * torch.randn(p.shape, generator=gen).to(d))
            return step()

        o.step = seen_step
        fn = loop.make_train_step(rcfg, o, microbatches=mb)
        losses = [float(fn(ps, b)["loss"]) for b in steps]
        return ([g.cpu() for g in grads], {k: p.detach().cpu() for k, p in ps.items()}, losses,
                {k: {key: o.state[p][key].cpu() for key in ("mu", "nu")} for k, p in ps.items()}, first)

    for name, mb, lr in cases:
        cpu, card = run(torch.device("cpu"), name, mb, lr), run(dev, name, mb, lr)
        gated = lr == loop.TrainConfig().learning_rate
        sched = train.warmup_cosine(lr, 2, 10)
        adam_most = 2 * sum(sched(s) for s in range(1, len(cpu[2]) + 1))  # the most Adam moves an entry
        lax, first_lax = {}, {}
        for k in cpu[1]:
            rms = torch.maximum(cpu[3][k]["nu"], card[3][k]["nu"]).sqrt()
            lax[k] = (rms > 0) & (rms < COND_GRAD * rms.max())
            g0, g1 = cpu[4][k].abs(), card[4][k].abs()
            small = COND_GRAD * float(torch.maximum(g0, g1).max())
            first_lax[k] = (g0 < small) & (g1 < small) & ((g0 > 0) | (g1 > 0)) & ~lax[k]
        n_first = sum(int(m.sum()) for m in first_lax.values())
        replay = (run(torch.device("cpu"), name, mb, lr, first_from={k: (card[4][k], m) for k, m in first_lax.items()})
                  if gated and n_first else None)
        noisy = [run(torch.device("cpu"), name, mb, lr, 2915 + i) for i in range(NOISE_DRAWS)] if gated else []
        gworst = max(rel(g, w) for g, w in zip(card[0], cpu[0]))
        mworst = max(rel(card[3][k]["mu"], st["mu"]) for k, st in cpu[3].items())
        worst = loose = share = replayed = 0.0
        n_loose, spreads, most = 0, [0.0] * len(noisy), math.inf
        for k, w in cpu[1].items():
            scale = float(w.abs().max())
            worst = max(worst, float((card[1][k] - w).abs()[~(lax[k] | first_lax[k])].max()) / scale)
            if bool(lax[k].any()):
                n_loose += int(lax[k].sum())
                share = max(share, float(lax[k].float().mean()))
                loose = max(loose, float((card[1][k] - w).abs()[lax[k]].max()) / scale)
                spreads = [max(s, float((n[1][k] - w).abs()[lax[k]].max()) / scale) for s, n in zip(spreads, noisy)]
                most = min(most, adam_most / scale)
            if replay is not None and bool(first_lax[k].any()):
                replayed = max(replayed, float((card[1][k] - replay[1][k]).abs()[first_lax[k]].max()) / scale)
        loose_tol = max([TRAIN_CPU_TOL] + [SPREAD_FACTOR * s for s in spreads])
        lworst = max(abs(a - b) / abs(b) for a, b in zip(card[2], cpu[2]))
        print(f"  {tag} {rcfg.name} reduced, fp32, {name}, microbatches {mb}, lr {lr}: the card against the "
              f"CPU, first gradients worst leaf normwise {gworst:.3e}, after 3 steps mu {mworst:.3e}, worst leaf "
              f"{worst:.3e}; {n_loose} entries (at most {share:.2e} of a leaf) with a gradient RMS above 0 and "
              f"under {COND_GRAD:g} of the leaf's largest, worst leaf on them {loose:.3e}, "
              + (f"the CPU with its gradients times 1 + {GRAD_NOISE:g} N(0, 1) "
                 f"{', '.join(f'{s:.3e}' for s in spreads)} from the CPU ({NOISE_DRAWS} draws), twice the "
                 f"steps' summed lr over their leaves' largest {f'{most:.3e}' if n_loose else '-'}; {n_first} "
                 f"more entries "
                 f"with a first gradient alone so small, worst leaf on them against the CPU run that takes the "
                 f"card's first gradient there {replayed:.3e}; losses {lworst:.3e} (tolerances "
                 f"{TRAIN_CPU_TOL:.0e}, {TRAIN_CPU_TOL:.0e}, {TRAIN_CPU_TOL:.0e}, share {LOOSE_SHARE:g}, "
                 f"{loose_tol:.3e}, {TRAIN_CPU_TOL:.0e}, 1e-05)" if gated
                 else f"{n_first} more entries with a first gradient alone so small; losses {lworst:.3e} "
                      f"(not gated)"), flush=True)
        if gated and not (gworst <= TRAIN_CPU_TOL and mworst <= TRAIN_CPU_TOL and worst <= TRAIN_CPU_TOL
                          and share <= LOOSE_SHARE and loose <= loose_tol and replayed <= TRAIN_CPU_TOL
                          and lworst <= 1e-5):
            fail(f"{rcfg.name} {name} microbatches {mb}: the card's steps differ from the CPU's")


def train_phase(dev, card: str) -> dict:
    """Phase 4j: the training path, llama3-8b at full width and 4 layers,
    5 AdamW and 5 EbV steps, each from a fresh model on one repeated batch,
    with gates (a)-(e) (see the module docstring).  Returns the batched
    kernels' launches on the EbV run."""
    import gc
    import math
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train import loop

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH).replace(num_layers=TRAIN_LAYERS)
    tc = loop.TrainConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    batch = loop.make_batch_fn(cfg, tc, device=dev)(next(pipe)["tokens"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shapes = lm._train_shapes(cfg)
    nparams = sum(math.prod(s) for s, _ in shapes.values())
    # the weights of the matmuls: every leaf but the embedding (a gather) and the norm scales
    n_matmul = sum(math.prod(s) for k, (s, _) in shapes.items() if k != "embed" and not k.endswith("scale"))
    bound_ms = 8 * n_matmul * tokens / PEAK_BF16_FLOPS * 1e3  # 6 N T, and the forward again under remat
    groups = ebv_groups(shapes)
    print(f"  {cfg.name}: {TRAIN_LAYERS} layers (cut from 32), d={cfg.d_model}, {cfg.num_heads} heads, "
          f"{cfg.num_kv_heads} KV heads, d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{nparams / 1e9:.3f} G parameters in {len(shapes)} stacked leaves, {n_matmul / 1e9:.3f} G in "
          f"matmuls; batch {TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} tokens a step; EbV order groups "
          f"(order: systems) {groups}; memory in use before {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)
    if groups != {TRAIN_LAYERS: 2}:
        fail(f"EbV order groups {groups}: expected one group of two order-{TRAIN_LAYERS} systems "
             "(the stacked norm scales)")

    def fresh():
        params = lm.train_params(lm.init_params(torch.Generator(device=dev).manual_seed(2700), cfg))
        gc.collect()
        torch.cuda.empty_cache()
        return params

    # (b) the chunked CE against one full fp32 product and F.cross_entropy
    params = fresh()
    with torch.no_grad():
        ce0 = float(lm.train_loss(params, batch, cfg)[1]["ce"])
        hidden = lm._final_hidden(params, batch, cfg)  # its layer view holds the weights
        x, toks = hidden[0], hidden[3]
        logits = x[:, :-1].float() @ params["unembed"].float()
        full = float(F.cross_entropy(logits.reshape(-1, logits.shape[-1]), toks[:, 1:].reshape(-1)))
        del hidden, x, logits
    rel = abs(ce0 - full) / abs(full)
    print(f"  (b) train_loss at step 0: CE {ce0:.6f}; one fp32 x @ unembed with F.cross_entropy {full:.6f}; "
          f"relative {rel:.3e} (tolerance {TRAIN_CE_TOL:.0e})", flush=True)
    if not rel <= TRAIN_CE_TOL:
        fail(f"train_loss {ce0} against the full fp32 CE {full}")

    del params  # each run draws its own
    launches = train_runs(dev, card, "(a, c)", cfg, batch, fresh, groups, tokens,
                          [(bound_ms, f"8 x {n_matmul / 1e9:.3f} G x {tokens} tokens / 989 TFLOP/s bf16")])

    # (d) llama3_8b.reduced() in fp32: 3 steps on the card against the CPU at
    # the trainer's default learning rate, and the first batch's gradients;
    # the same at lr 1e-2 is printed, not gated
    rcfg = get_config(LM_ARCH).reduced()
    rng = np.random.default_rng(2701)
    rbatches = [rng.integers(0, rcfg.vocab_size, (4, 64)).astype(np.int32) for _ in range(3)]
    start = lm.train_params(lm.init_params(2702, rcfg, device="cpu"))
    card_against_cpu(dev, "(d)", rcfg, start, lambda d: [{"tokens": torch.from_numpy(b).to(d)} for b in rbatches],
                     [(name, mb, tc.learning_rate) for name in ("adamw", "ebv") for mb in (1, 2)]
                     + [("adamw", 1, 1e-2), ("ebv", 1, 1e-2)])

    # (e) the launcher, checkpointed, cut after step 4's checkpoint and run
    # again in a new process: it resumes at step 4 and ends where the
    # uninterrupted run (the same entry point, in this process) ends
    from repro_torch.launch import train as launch_train

    base = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(base, ignore_errors=True)
    whole, resumed = os.path.join(base, "whole"), os.path.join(base, "resumed")
    args = ["--arch", LM_ARCH, "--reduced", "--steps", "6", "--ckpt-every", "2", "--device", dev.type,
            "--ckpt-dir"]
    t0 = time.perf_counter()
    launch_train.main(args + [whole])
    print(f"  (e) repro_torch.launch.train.main({' '.join(args)} {os.path.relpath(whole, ROOT)}) in this "
          f"process: {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.copytree(whole, resumed)
    shutil.rmtree(os.path.join(resumed, "step_000000006"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"] + args + [resumed], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")), capture_output=True,
                          text=True, timeout=300)
    print(f"  (e) python -m repro_torch.launch.train {' '.join(args)} {os.path.relpath(resumed, ROOT)}: exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.1f} s (process start included); "
          f"{proc.stdout.strip().splitlines()}", flush=True)
    if proc.returncode:
        fail(f"the training launcher: {proc.stderr.strip()[-2000:]}")
    if "[train] resumed from step 4" not in proc.stdout:
        fail("the second launcher run did not resume at step 4")
    with np.load(os.path.join(whole, "step_000000006", "arrays.npz")) as a, \
            np.load(os.path.join(resumed, "step_000000006", "arrays.npz")) as b:
        worst = {"0": 0.0, "1": 0.0}  # the parameters, the optimizer state
        for k in a.files:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            if x.size:
                err = float(np.abs(x - y).max() / max(np.abs(x).max(), 1e-30))
                worst[k[0]] = max(worst[k[0]], err)
    print(f"  (e) resumed at step 4 against the uninterrupted run at step 6: parameters worst leaf normwise "
          f"{worst['0']:.3e}, optimizer state {worst['1']:.3e} (tolerance {TRAIN_RESUME_TOL:.0e})", flush=True)
    if not worst["0"] <= TRAIN_RESUME_TOL:
        fail(f"the resumed run's parameters differ from the uninterrupted run's by {worst['0']:.3e}")
    shutil.rmtree(base, ignore_errors=True)
    print(f"  phase 4j: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def serve_runs(tag: str, model, cfg, reqs, card: str, *, max_len: int, slots: int, paged=(False, True),
               bucket=LM_BUCKET):
    """``serve.Engine`` on ``reqs`` (buckets of ``bucket``; paged: pages of PAGE),
    for each of ``paged``, with B13's counter at 0 just before: tokens/s,
    dispatches, ms per decode step, B13 launches a decode step.  Fails
    unless every output is its prompt and then its budget of tokens in the
    vocabulary, and unless B13 launched ``num_layers`` times a paged decode
    step and never dense.  Returns ({label: outputs}, {label: engine},
    {label: B13 launches}), label "dense" or "paged"."""
    import numpy as np
    import torch

    from repro_torch.kernels import paged_attn
    from repro_torch.serve import Engine

    served, engines, b13 = {}, {}, {}
    for pg in paged:
        label = "paged" if pg else "dense"
        eng = Engine(model, cfg, max_len=max_len, slots=slots, bucket=bucket,
                     **(dict(paged=True, page_size=PAGE) if pg else {}))
        torch.cuda.synchronize()
        paged_attn.paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        served[label] = eng.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        b13[label] = paged_attn.paged_decode_attention.launches
        engines[label] = eng
        st = eng.stats
        print(f"  {tag} {cfg.name} {label}: {len(reqs)} requests, {st.generated_tokens} new tokens in "
              f"{dt * 1e3:.1f} ms (host clock) = {st.generated_tokens / dt:.1f} tokens/s; {st.prefill_dispatches} "
              f"prefill + {st.decode_dispatches} decode dispatches, {dt * 1e3 / st.decode_dispatches:.2f} ms per "
              f"decode step with the prefills; padding {st.padding_frac:.3f}; B13 launches {b13[label]} = "
              f"{b13[label] / st.decode_dispatches:.2f} per decode step"
              + (f"; pool peak {st.pool_peak_pages}/{eng.pool.capacity} pages of {PAGE}" if pg else "")
              + f" (card: {card})", flush=True)
        want = cfg.num_layers * st.decode_dispatches if pg else 0
        if b13[label] != want:
            fail(f"{cfg.name} {label}: B13 launches {b13[label]}, expected {want}")
        for i, r in enumerate(reqs):
            o, p = served[label][i], r.tokens
            if len(o) != len(p) + r.max_new_tokens or not np.array_equal(o[:len(p)], p) or o.min() < 0 \
                    or o.max() >= cfg.vocab_size:
                fail(f"{cfg.name} {label} request {i}: {len(o)} tokens for a {len(p)}-token prompt and "
                     f"{r.max_new_tokens} new")
    return served, engines, b13


def decode_step_line(tag: str, label: str, fn, pos, card: str) -> None:
    """One decode step ``fn`` at the rows' positions ``pos``: CUDA events
    (median of REPS after a warm-up), then one profiled step: the device's
    busy time, its operations and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    ms = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the device's activity alone, as train_runs
        fn()
        torch.cuda.synchronize()
    ops = device_ops(prof)
    busy, med = sum(r[1] for r in ops), statistics.median(ms)
    idle = f"{max(0.0, 1 - busy / med):.3f}" if busy > 0 else "not measured"
    print(f"  {tag} one {label} decode step, {len(pos)} rows at positions {pos.tolist()}: {med:.3f} ms (CUDA "
          f"events, median of {REPS}); device busy {busy:.3f} ms over {sum(r[2] for r in ops)} device "
          f"operations, idle share {idle} (card: {card})", flush=True)


def whisper_phase(dev, card: str) -> dict:
    """Phase 4k: whisper-tiny at full width and depth: (a) the serving engine
    dense and paged, (b) 5 AdamW and 5 EbV training steps, each from a fresh
    model on one repeated batch, (c) the reduced fp32 model on the card
    against the CPU, and both launchers in subprocesses (see the module
    docstring).  Returns the launches of B13 (the paged serve) and of B9 and
    B10 (the EbV run)."""
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.serve import GenRequest, bucket_length
    from repro_torch.train import loop

    t_phase = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    L, kvh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(2800), cfg)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {L} decoder + {cfg.encoder_layers} encoder layers, d={cfg.d_model}, {cfg.num_heads} "
          f"heads, {kvh} KV heads, Dh={dh}, d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{nparams / 1e6:.3f} M parameters, drawn on the card in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- (a) serving, dense and paged, then teacher-forced logits
    rng = np.random.default_rng(2801)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in rng.integers(16, 225, WHISPER_REQS)]
    news = [int(n) for n in rng.integers(32, 225, WHISPER_REQS)]
    reqs = [GenRequest(p, n) for p, n in zip(prompts, news)]
    served, engines, b13 = serve_runs("(a)", model, cfg, reqs, card, max_len=WHISPER_MAX_LEN,
                                      slots=WHISPER_SLOTS)
    agree = sum(int((served["dense"][i][len(p):] == served["paged"][i][len(p):]).sum())
                for i, p in enumerate(prompts))
    print(f"  (a) served tokens that agree, paged and dense: {agree}/{sum(news)} = {agree / sum(news):.3f} "
          f"(not gated: near ties on random weights)", flush=True)

    fixed = max(bucket_length(len(p), LM_BUCKET) for p in prompts)  # the engine's one bucket
    enc_len = max(fixed // 4, 1)
    nrow, np_ = WHISPER_SLOTS, WHISPER_MAX_LEN // PAGE
    dcache = lm.init_caches(cfg, nrow, WHISPER_MAX_LEN, enc_len=enc_len, device=dev)
    pcache = lm.init_paged_caches(cfg, nrow, nrow * np_ + 1, PAGE, enc_len=enc_len, device=dev)
    table = (1 + torch.arange(nrow * np_, device=dev, dtype=torch.int32)).reshape(nrow, np_)
    frames = lm.stub_frames(1, enc_len, cfg, 0, device=dev)  # the engine's
    ar = torch.arange(WHISPER_MAX_LEN, device=dev)
    for r in range(nrow):
        s0 = len(prompts[r])
        toks = np.zeros((1, fixed), np.int32)
        toks[0, :s0] = prompts[r]
        raw, _ = lm.prefill(model, {"tokens": toks, "frames": frames}, cfg, last=[s0 - 1], raw_kv=True)
        npg = -(-fixed // PAGE)
        for key in ("k", "v"):
            fresh = raw["attn"][key][:, 0]  # (L, fixed, KV, Dh)
            dcache["attn"][key][:, r, :fixed] = fresh
            pages = torch.nn.functional.pad(fresh, (0, 0, 0, 0, 0, npg * PAGE - fixed))
            pcache["attn"][f"{key}_pages"][:, table[r, :npg].long()] = pages.reshape(L, npg, PAGE, kvh, dh)
            dcache[f"cross_{key}"][:, r] = raw[f"cross_{key}"][:, 0]
            pcache[f"cross_{key}"][:, r] = raw[f"cross_{key}"][:, 0]
        dcache["attn"]["pos"][:, r] = torch.where(ar < s0, ar, -1).to(torch.int32)
    pos = torch.tensor([len(prompts[r]) for r in range(nrow)], dtype=torch.int32, device=dev)
    worst = 0.0
    for t in range(TEACHER_STEPS):
        tok = torch.tensor([[int(served["dense"][r][len(prompts[r]) + t])] for r in range(nrow)], device=dev)
        _, dl = lm.decode_step(model, dcache, tok, pos, cfg)
        _, pl = lm.decode_step(model, pcache, tok, pos, cfg, page_table=table)
        if not bool(torch.isfinite(pl).all()) or pl.shape != dl.shape:
            fail(f"whisper paged logits at step {t}: shape {tuple(pl.shape)} or non-finite")
        worst = max(worst, float((pl - dl).abs().max() / dl.abs().max()))
        pos += 1
    print(f"  (a) teacher-forced over {TEACHER_STEPS} steps, {nrow} rows: paged against dense logits, worst "
          f"normwise {worst:.3e} (tolerance {LOGITS_TOL:.0e})", flush=True)
    if not worst <= LOGITS_TOL:
        fail(f"whisper paged decode logits {worst:.3e} from the dense ones")
    tok = torch.zeros((nrow, 1), dtype=torch.long, device=dev)
    for label, fn in (("dense", lambda: lm.decode_step(model, dcache, tok, pos, cfg)),
                      ("paged", lambda: lm.decode_step(model, pcache, tok, pos, cfg, page_table=table))):
        decode_step_line("(a)", label, fn, pos, card)
    del model, engines, dcache, pcache, served, fn, _
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) training
    tb, ts = WHISPER_TRAIN
    tc = loop.TrainConfig(steps=TRAIN_STEPS, seq_len=ts, global_batch=tb)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=ts, global_batch=tb, seed=0)
    batch = loop.make_batch_fn(cfg, tc, device=dev)(next(pipe)["tokens"])
    tokens, se = tb * ts, batch["frames"].shape[1]
    shapes = lm._train_shapes(cfg)
    # the weights of the matmuls (every leaf but the embedding, a gather, and
    # the norm scales) and the tokens each multiplies: the encoder's layers
    # and the cross K/V projections see the frames, the rest the tokens
    mat = {k: math.prod(s) for k, (s, _) in shapes.items() if k != "embed" and not k.endswith("scale")}
    seen = {k: tb * se if k.startswith("enc_blocks.") or k in ("blocks.cross.wk", "blocks.cross.wv") else tokens
            for k in mat}
    n_matmul = sum(mat.values())
    bound_ms = 8 * n_matmul * tokens / PEAK_BF16_FLOPS * 1e3
    seen_ms = 8 * sum(mat[k] * seen[k] for k in mat) / PEAK_BF16_FLOPS * 1e3
    groups = ebv_groups(shapes)
    print(f"  (b) {sum(math.prod(s) for s, _ in shapes.values()) / 1e6:.3f} M parameters in {len(shapes)} stacked "
          f"leaves, {n_matmul / 1e6:.3f} M in matmuls; batch {tb} x {ts} = {tokens} tokens and {tb} x {se} "
          f"frames a step; EbV order groups (order: systems) {groups}", flush=True)
    if groups != {L: 5, cfg.d_model: 2}:
        fail(f"whisper EbV order groups {groups}: expected five order-{L} systems (the stacked norm scales) "
             f"and two of order {cfg.d_model} (embed, unembed)")

    def fresh():
        params = lm.train_params(lm.init_params(torch.Generator(device=dev).manual_seed(2802), cfg))
        gc.collect()
        torch.cuda.empty_cache()
        return params

    launches = train_runs(dev, card, "(b)", cfg, batch, fresh, groups, tokens, [
        (bound_ms, f"8 x {n_matmul / 1e6:.3f} M x {tokens} tokens / 989 TFLOP/s bf16"),
        (seen_ms, f"with the encoder's weights and the cross K/V over the {tb} x {se} frames")])
    del batch

    # ---- (c) the reduced fp32 model: 3 steps on the card against the CPU
    rcfg = get_config(WHISPER_ARCH).reduced()
    rng = np.random.default_rng(2803)
    rbatches = [rng.integers(0, rcfg.vocab_size, (4, 64)).astype(np.int32) for _ in range(3)]
    rframes = rng.standard_normal((4, 16, rcfg.d_model)).astype(np.float32)
    start = lm.train_params(lm.init_params(2804, rcfg, device="cpu"))
    card_against_cpu(dev, "(c)", rcfg, start,
                     lambda d: [{"tokens": torch.from_numpy(b).to(d), "frames": torch.from_numpy(rframes).to(d)}
                                for b in rbatches],
                     [(name, mb, tc.learning_rate) for name in ("adamw", "ebv") for mb in (1, 2)])

    # ---- the launchers, on the card by default, in two subprocesses at once
    run_launchers([(["repro_torch.launch.serve", "--arch", WHISPER_ARCH, "--paged"],
                    "served 4 requests (64 new tokens)"),
                   (["repro_torch.launch.train", "--arch", WHISPER_ARCH, "--optimizer", "ebv", "--steps", "3"],
                    "[train] step     0 loss")])
    print(f"  phase 4k: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"paged_decode_attention": b13["paged"], **launches}


def run_launchers(specs) -> None:
    """``python -m`` each of ``specs`` ((arguments, a line its output must
    hold)) in subprocesses at once, on the card by default; fails unless
    each exits 0 within 300 s and prints its line."""
    runs = []
    t0 = time.perf_counter()
    for args, expect in specs:
        runs.append((args, expect, subprocess.Popen(
            [sys.executable, "-m"] + args, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))))
    for args, expect, proc in runs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for _, _, p in runs:
                p.kill()
            fail(f"python -m {args[0]}: no exit in 300 s")
        print(f"  python -m {' '.join(args)}: exit {proc.returncode}, done {time.perf_counter() - t0:.1f} s "
              f"after the start (process start and weight draw included)", flush=True)
        for out_line in out.strip().splitlines():
            print(f"    {out_line}", flush=True)
        if proc.returncode or expect not in out:
            fail(f"python -m {args[0]}: {err.strip()[-2000:]}")


def drawn(dev, cfg, seed: int):
    """``lm.init_params(cfg)`` drawn on the card from ``seed``, with a line
    naming its shape, its size and the draw's time."""
    import torch

    from repro_torch.models import lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    parts = [f"{cfg.num_layers} layers", f"d={cfg.d_model}"]
    if cfg.num_heads:
        parts.append(f"{cfg.num_heads} / {cfg.num_kv_heads} heads of Dh {cfg.resolved_head_dim}"
                     + (f" in a window of {cfg.sliding_window}" if cfg.sliding_window else ""))
        parts.append(f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-{cfg.experts_per_token}"
                     if cfg.family == "moe" else f"d_ff {cfg.d_ff}")
    if cfg.family in ("ssm", "hybrid"):
        parts.append(f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, d_inner {cfg.d_inner}, state "
                     f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    print(f"  {cfg.name}: {', '.join(parts)}, vocab {cfg.vocab_size}, {cfg.dtype}: {n / 1e9:.3f} G parameters "
          f"({2 * n / 1e9:.2f} GB), drawn on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    return model


def freed() -> None:
    """Collect what the phase dropped and give the card's cached blocks back."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def teacher_forced(model, cfg, seqs, starts, max_len: int, on_step=None):
    """Each row ``seqs[r]`` prefilled at its exact length ``starts[r]`` into
    one dense cache, then TEACHER_STEPS decode steps of its own tokens,
    against one full forward of the row.  ``on_step(stage, i)``, where
    given, runs before each full forward and prefill (``"full"``,
    ``"prefill"``, ``i`` the row) and each decode step (``"decode"``, ``i``
    the step).  Returns (caches, pos, the worst normwise gap of a row's
    step, each row's full-forward logits (T, V), each step's decode logits
    (rows, V))."""
    import torch

    from repro_torch.models import common, lm

    dev = model.unembed.device
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    hook = on_step or (lambda stage, i: None)
    nrow = len(seqs)
    with torch.no_grad():
        full = []
        for r in range(nrow):
            hook("full", r)
            x = lm._final_hidden(model, {"tokens": seqs[r][None, :starts[r] + TEACHER_STEPS]}, cfg)[0]
            full.append(common.matmul_f32(x[0, starts[r]:starts[r] + TEACHER_STEPS], model.unembed))
            del x
        caches = lm.init_caches(cfg, nrow, max_len, device=dev)
        for r in range(nrow):
            hook("prefill", r)
            one, _ = lm.prefill(model, {"tokens": seqs[r][None, :starts[r]]}, cfg, cache_len=max_len)
            for part, leaves in one.items():
                for key, v in leaves.items():
                    caches[part][key][:, r] = v[:, 0]
            del one
        pos = torch.tensor(starts, dtype=torch.int32, device=dev)
        worst, steps = 0.0, []
        for t in range(TEACHER_STEPS):
            hook("decode", t)
            tok = torch.tensor([[int(seqs[r][starts[r] + t])] for r in range(nrow)], device=dev)
            _, logits = lm.decode_step(model, caches, tok, pos, cfg)
            if not bool(torch.isfinite(logits).all()):
                fail(f"{cfg.name} decode logits at step {t}: non-finite")
            worst = max(worst, max(rel(logits[r, 0], full[r][t]) for r in range(nrow)))
            steps.append(logits[:, 0])
            pos += 1
    return caches, pos, worst, full, steps


class Routing:
    """The MoE layer's router choices (``models/moe.py:route``) call by call,
    recorded in ``calls``; or, with ``replay`` a list of them, taken from
    it in order, while the choices the layer would have made itself are
    counted where they differ (``differ`` of ``total``, and the largest
    gap between the probabilities of a differing pair, ``gap``)."""

    def __init__(self):
        self.calls, self.replay = [], None
        self.differ = self.total = 0
        self.gap = 0.0

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe.route
        moe.route = self._hook
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def _hook(self, p, xt, cfg):
        probs, top_p, own = self._route(p, xt, cfg)
        if self.replay is None:
            self.calls.append(own)
            return probs, top_p, own
        want = self.replay.pop(0)
        top_p, differ, gap = self._moe.replay_choices(probs, own, want)
        self.differ += differ
        self.total += own.numel()
        self.gap = max(self.gap, gap)
        return probs, top_p, want

    def near_ties(self) -> bool:
        return self.gap <= ROUTE_GAP_TOL and self.differ <= ROUTE_DIFFER_SHARE * self.total


def moe_phase(dev, card: str) -> dict:
    """Phase 4l: the moe family.  (a) mixtral-8x22b at full width and 4
    layers served dense, its decode steps past the window teacher-forced
    against full forwards; (b) granite-moe-1b-a400m at full width and depth
    served dense and paged, the paged decode step teacher-forced against
    the dense one; (c) granite trained, 5 AdamW and 5 EbV steps on one
    repeated 8 x 512 batch, then one EbV step on 20,480 tokens through the
    grouped path; (d) both reduced fp32 configs on the card against the
    CPU; (e) the serving launcher on both, in two subprocesses (see the
    module docstring).  Returns the launches of B13 (the paged serve) and
    of B9 and B10 (the EbV steps)."""
    import math

    import numpy as np
    import torch

    from repro_torch import train
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import batched_lu
    from repro_torch.models import lm, moe
    from repro_torch.serve import GenRequest, bucket_length
    from repro_torch.train import loop

    t_phase = time.perf_counter()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())

    # ---- (a) mixtral-8x22b, MIXTRAL_LAYERS layers, served dense past its window
    cfg = get_config(MIXTRAL_ARCH).replace(num_layers=MIXTRAL_LAYERS)
    w = cfg.sliding_window
    model = drawn(dev, cfg, 2900)
    rng = np.random.default_rng(2901)
    lengths = rng.integers(MIXTRAL_PROMPTS[0], MIXTRAL_PROMPTS[1] + 1, MIXTRAL_REQS)
    lengths[:2] = (w - 6, w + 1)  # one bucket that fills the ring, one just past it
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    news = [int(n) for n in rng.integers(MIXTRAL_NEW[0], MIXTRAL_NEW[1] + 1, MIXTRAL_REQS)]
    reqs = [GenRequest(p, n) for p, n in zip(prompts, news)]
    served, engines, _ = serve_runs("(a)", model, cfg, reqs, card, max_len=MIXTRAL_MAX_LEN, slots=MIXTRAL_SLOTS,
                                    paged=(False,))
    exact = [len(p) for p in prompts if bucket_length(len(p), LM_BUCKET) > w]
    print(f"  (a) prompts of {sorted(lengths.tolist())} tokens: {len(exact)} past the window of {w} once padded to "
          f"buckets of {LM_BUCKET}, prefilled at their exact length; each row's last position "
          f"{min(len(p) + n - 1 for p, n in zip(prompts, news))} or more", flush=True)
    del engines

    # teacher-forced: each of MIXTRAL_SLOTS rows prefilled to a start past the
    # window, then TEACHER_STEPS decode steps of its served tokens, against one
    # full forward of the row with the window mask.  The capacity factor E / k
    # lets no expert drop a token in either, so the rows share nothing, and the
    # decode steps take the full forward's router choices (Routing): a flipped
    # near tie in bf16 would move a row's logits by more than the window's work
    tcfg = cfg.replace(moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    nrow = MIXTRAL_SLOTS
    seqs = [served["dense"][r] for r in range(nrow)]
    starts = [max(len(prompts[r]), w + 4) for r in range(nrow)]
    routes, prefill_differ = [], 0

    def route(stage, i):
        nonlocal prefill_differ
        if stage == "full":  # record the row's choices
            rt.calls = []
            routes.append(rt.calls)
        elif stage == "prefill":
            rt.replay = [c[:starts[i]] for c in routes[i]]
        else:
            if i == 0:
                prefill_differ = rt.differ
            rt.replay = [torch.stack([routes[r][layer][starts[r] + i] for r in range(nrow)])
                         for layer in range(tcfg.num_layers)]

    with Routing() as rt:
        caches, pos, worst, _, _ = teacher_forced(model, tcfg, seqs, starts, MIXTRAL_MAX_LEN, route)
    ring = caches["attn"]["k"].shape[2]
    print(f"  (a) teacher-forced at positions {starts} + 0..{TEACHER_STEPS - 1}, {nrow} rows on a ring of {ring} "
          f"slots: decode logits against a full forward of each row, worst normwise {worst:.3e} (tolerance "
          f"{LOGITS_TOL:.0e}); router choices the prefills and decode steps would have made otherwise: "
          f"{prefill_differ} and {rt.differ - prefill_differ} of {rt.total}, the largest probability gap of such "
          f"a pair {rt.gap:.3e} (capacity factor {tcfg.moe_capacity_factor:g}: no drops; tolerances "
          f"{ROUTE_DIFFER_SHARE:g} of the choices, a gap of {ROUTE_GAP_TOL:g})", flush=True)
    if ring != w or not worst <= LOGITS_TOL or not rt.near_ties():
        fail(f"mixtral: a ring of {ring} slots, decode logits {worst:.3e} from the full forward's, or "
             f"{rt.differ} of {rt.total} router choices differ, by up to {rt.gap:.3e}")
    tok = torch.zeros((nrow, 1), dtype=torch.long, device=dev)
    decode_step_line("(a)", f"{cfg.name} dense", lambda: lm.decode_step(model, caches, tok, pos, cfg), pos, card)
    del model, caches, routes, served, rt
    freed()

    # ---- (b) granite-moe-1b-a400m served dense and paged
    cfg = get_config(GRANITE_ARCH)
    L, kvh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    model = drawn(dev, cfg, 2910)
    rng = np.random.default_rng(2911)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(GRANITE_PROMPTS[0], GRANITE_PROMPTS[1] + 1, GRANITE_REQS)]
    news = [int(n) for n in rng.integers(GRANITE_NEW[0], GRANITE_NEW[1] + 1, GRANITE_REQS)]
    reqs = [GenRequest(p, n) for p, n in zip(prompts, news)]
    served, engines, b13 = serve_runs("(b)", model, cfg, reqs, card, max_len=GRANITE_MAX_LEN, slots=GRANITE_SLOTS)
    agree = sum(int((served["dense"][i][len(p):] == served["paged"][i][len(p):]).sum())
                for i, p in enumerate(prompts))
    print(f"  (b) served tokens that agree, paged and dense: {agree}/{sum(news)} = {agree / sum(news):.3f} "
          f"(not gated: near ties on random weights)", flush=True)
    del engines

    # teacher-forced: the rows' prompts prefilled once into a dense cache and
    # into pool pages, then TEACHER_STEPS steps of each; the paged step takes
    # the dense step's router choices, and those it would have made itself are
    # counted where they differ
    nrow, np_ = GRANITE_SLOTS, GRANITE_MAX_LEN // PAGE
    dcache = lm.init_caches(cfg, nrow, GRANITE_MAX_LEN, device=dev)
    pcache = lm.init_paged_caches(cfg, nrow, nrow * np_ + 1, PAGE, device=dev)
    table = (1 + torch.arange(nrow * np_, device=dev, dtype=torch.int32)).reshape(nrow, np_)
    ar = torch.arange(GRANITE_MAX_LEN, device=dev)
    for r in range(nrow):
        s0 = len(prompts[r])
        raw, _ = lm.prefill(model, {"tokens": prompts[r][None]}, cfg, raw_kv=True)
        npg = -(-s0 // PAGE)
        for key in ("k", "v"):
            fresh = raw["attn"][key][:, 0]  # (L, s0, KV, Dh)
            dcache["attn"][key][:, r, :s0] = fresh
            pages = torch.nn.functional.pad(fresh, (0, 0, 0, 0, 0, npg * PAGE - s0))
            pcache["attn"][f"{key}_pages"][:, table[r, :npg].long()] = pages.reshape(L, npg, PAGE, kvh, dh)
        dcache["attn"]["pos"][:, r] = torch.where(ar < s0, ar, -1).to(torch.int32)
    pos = torch.tensor([len(prompts[r]) for r in range(nrow)], dtype=torch.int32, device=dev)
    worst = 0.0
    with Routing() as rt:
        for t in range(TEACHER_STEPS):
            tok = torch.tensor([[int(served["dense"][r][len(prompts[r]) + t])] for r in range(nrow)], device=dev)
            rt.calls, rt.replay = [], None
            _, dl = lm.decode_step(model, dcache, tok, pos, cfg)
            rt.replay = list(rt.calls)
            _, pl = lm.decode_step(model, pcache, tok, pos, cfg, page_table=table)
            if not bool(torch.isfinite(pl).all()) or pl.shape != dl.shape:
                fail(f"granite paged logits at step {t}: shape {tuple(pl.shape)} or non-finite")
            worst = max(worst, rel(pl, dl))
            pos += 1
    print(f"  (b) teacher-forced over {TEACHER_STEPS} steps, {nrow} rows: paged against dense logits, worst "
          f"normwise {worst:.3e} (tolerance {LOGITS_TOL:.0e}); router choices of the paged steps that differ from "
          f"the dense steps': {rt.differ} of {rt.total}, the largest probability gap of such a pair "
          f"{rt.gap:.3e} (tolerances {ROUTE_DIFFER_SHARE:g} of the choices, a gap of {ROUTE_GAP_TOL:g})", flush=True)
    if not worst <= LOGITS_TOL or not rt.near_ties():
        fail(f"granite paged decode logits {worst:.3e} from the dense ones, or {rt.differ} of {rt.total} "
             f"router choices differ, by up to {rt.gap:.3e}")
    tok = torch.zeros((nrow, 1), dtype=torch.long, device=dev)
    for label, fn in (("dense", lambda: lm.decode_step(model, dcache, tok, pos, cfg)),
                      ("paged", lambda: lm.decode_step(model, pcache, tok, pos, cfg, page_table=table))):
        decode_step_line("(b)", f"{cfg.name} {label}", fn, pos, card)
    del model, dcache, pcache, served, fn
    freed()

    # ---- (c) granite training
    tc = loop.TrainConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    batch = loop.make_batch_fn(cfg, tc, device=dev)(next(pipe)["tokens"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shapes = lm._train_shapes(cfg)
    # the weights of the matmuls (every leaf but the embedding, a gather, and
    # the norm scales), an expert's at the share k / E of the tokens it sees
    share = cfg.experts_per_token / cfg.num_experts
    mat = {k: math.prod(s) * (share if k.startswith("blocks.moe.w") else 1)
           for k, (s, _) in shapes.items() if k != "embed" and not k.endswith("scale")}
    n_active = sum(mat.values())
    bound_ms = 8 * n_active * tokens / PEAK_BF16_FLOPS * 1e3
    cap_ms = bound_ms + 8 * sum(v for k, v in mat.items() if k.startswith("blocks.moe.w")) * tokens \
        * (cfg.moe_capacity_factor - 1) / PEAK_BF16_FLOPS * 1e3
    groups = ebv_groups(shapes)
    print(f"  (c) {sum(math.prod(s) for s, _ in shapes.values()) / 1e9:.3f} G parameters in {len(shapes)} stacked "
          f"leaves, {n_active / 1e6:.1f} M active in matmuls; batch {TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} tokens "
          f"a step; EbV order groups (order: systems) {groups}", flush=True)
    if groups != {L: 2, cfg.d_model: 2}:
        fail(f"granite EbV order groups {groups}: expected two order-{L} systems (the stacked norm scales) "
             f"and two of order {cfg.d_model} (embed, unembed)")

    def fresh():
        params = lm.train_params(lm.init_params(torch.Generator(device=dev).manual_seed(2912), cfg))
        freed()
        return params

    launches = train_runs(dev, card, "(c)", cfg, batch, fresh, groups, tokens, [
        (bound_ms, f"8 x {n_active / 1e6:.1f} M active x {tokens} tokens / 989 TFLOP/s bf16"),
        (cap_ms, f"with the experts' capacity rows, cf = {cfg.moe_capacity_factor:g}")])
    del batch

    # one EbV step on GRANITE_LONG tokens: a full group of GROUP_TOKENS and a
    # padded tail, every MoE call counted by its rows and valid_count
    lb, ls = GRANITE_LONG
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=ls, global_batch=lb, seed=1)
    batch = loop.make_batch_fn(cfg, loop.TrainConfig(seq_len=ls, global_batch=lb), device=dev)(
        next(pipe)["tokens"])
    params = fresh()
    opt = train.get_optimizer("ebv", list(params.values()), train.warmup_cosine(tc.learning_rate, 2, TRAIN_STEPS))
    step_fn = loop.make_train_step(cfg, opt)
    wrappers = {"batched_lu_vmem": batched_lu.batched_lu_vmem,
                "batched_lu_solve_vmem": batched_lu.batched_lu_solve_vmem}
    calls, local = [], moe._moe_local

    def counted(p, xt, cfg, valid_count=None):
        calls.append((xt.shape[0], valid_count))
        return local(p, xt, cfg, valid_count)

    moe._moe_local = counted
    try:
        for wr in wrappers.values():
            wr.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        met = step_fn(params, batch)
        e.record()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    finally:
        moe._moe_local = local
    got = {k: wr.launches for k, wr in wrappers.items()}
    ms, loss = s.elapsed_time(e), float(met["loss"])
    kinds = sorted(set(calls))
    print(f"  (c) one EbV step on {lb} x {ls} = {lb * ls} tokens: loss {loss:.4f}, aux {float(met['aux']):.4f}; "
          f"{ms:.1f} ms (events; host clock {host * 1e3:.1f} ms), {lb * ls / ms * 1e3:,.0f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; MoE calls (rows, valid_count) {kinds}, {len(calls)} "
          f"in all (the forward and the checkpointed recompute); launches {got} (card: {card})", flush=True)
    tail = lb * ls - moe.GROUP_TOKENS
    want_calls = [(moe.GROUP_TOKENS, moe.GROUP_TOKENS), (moe.GROUP_TOKENS, tail)]
    if not math.isfinite(loss) or kinds != sorted(want_calls) or len(calls) != 2 * 2 * L \
            or got != {"batched_lu_vmem": 4, "batched_lu_solve_vmem": 2}:
        fail(f"granite's {lb * ls}-token EbV step: loss {loss}, MoE calls {kinds} ({len(calls)}), launches {got}")
    for k, v in got.items():
        launches[k] += v
    del params, opt, step_fn, batch, met
    freed()

    # ---- (d) the reduced fp32 configs, 3 steps on the card against the CPU,
    # at a sequence past mixtral's reduced window of 32
    for arch in (GRANITE_ARCH, MIXTRAL_ARCH):
        rcfg = get_config(arch).reduced()
        rng = np.random.default_rng(2913)
        rbatches = [rng.integers(0, rcfg.vocab_size, (4, 64)).astype(np.int32) for _ in range(3)]
        start = lm.train_params(lm.init_params(2914, rcfg, device="cpu"))
        card_against_cpu(dev, "(d)", rcfg, start,
                         lambda d, rbatches=rbatches: [{"tokens": torch.from_numpy(b).to(d)} for b in rbatches],
                         [(name, mb, tc.learning_rate) for name in ("adamw", "ebv") for mb in (1, 2)])

    # ---- (e) the serving launcher, on the card by default, in two subprocesses at once
    run_launchers([(["repro_torch.launch.serve", "--arch", GRANITE_ARCH, "--paged"],
                    "served 4 requests (64 new tokens)"),
                   (["repro_torch.launch.serve", "--arch", MIXTRAL_ARCH, "--reduced"],
                    "served 4 requests (64 new tokens)")])
    print(f"  phase 4l: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"paged_decode_attention": b13["paged"], **launches}


def ssm_phase(dev, card: str) -> dict:
    """Phase 4m: the ssm and hybrid families at full width and depth.  (a)
    mamba2-1.3b served dense, each of the first SSM_SLOTS prompts' padded
    prefill against its exact-length one, then those rows teacher-forced
    over TEACHER_STEPS decode steps against full forwards; (b) hymba-1.5b
    the same past its window (no pad check); (c) both trained, 5 AdamW and
    5 EbV steps on one repeated 8 x 512 batch; (d) both reduced fp32
    configs on the card against the CPU; (e) the serving launcher on
    mamba2 and the training launcher on hymba, in two subprocesses (see the
    module docstring).  Returns the launches of B9 and B10 (the EbV steps)."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.serve import GenRequest, bucket_length
    from repro_torch.train import loop

    t_phase = time.perf_counter()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())

    def lap(part):
        print(f"  {part} done {time.perf_counter() - t_phase:.1f} s into phase 4m", flush=True)

    def decode_checks(tag, model, cfg, seqs, starts, max_len):
        """The rows teacher-forced in bf16, one decode step timed, then the
        model cast to fp32 (IEEE, TF32 off) and the rows teacher-forced
        again.  In fp32 the recurrence must meet the chunked scan within
        SSM_F32_TOL.  In bf16 the served decode must be no further from the
        fp32 full forward than DECODE_FLOOR_FACTOR times the bf16 full
        forward is: both carry bf16 rounding through every layer, and a
        fault of the bf16 recurrence adds to it."""
        caches, pos, worst, full, steps = teacher_forced(model, cfg, seqs, starts, max_len)
        tok = torch.zeros((len(seqs), 1), dtype=torch.long, device=dev)
        decode_step_line(tag, f"{cfg.name} dense", lambda: lm.decode_step(model, caches, tok, pos, cfg), pos, card)
        ring = caches["attn"]["k"].shape[2] if "attn" in caches else None
        del caches
        cfg32 = cfg.replace(dtype="float32")
        model.float()
        _, _, worst32, full32, _ = teacher_forced(model, cfg32, seqs, starts, max_len)
        pairs = [(r, t) for r in range(len(seqs)) for t in range(TEACHER_STEPS)]
        floor = max(rel(full[r][t], full32[r][t]) for r, t in pairs)
        own = max(rel(steps[t][r], full32[r][t]) for r, t in pairs)
        window = f", and the ring of {ring} slots" if ring else ""
        print(f"  {tag} teacher-forced at positions {starts} + 0..{TEACHER_STEPS - 1}, {len(seqs)} rows: decode "
              f"logits (the recurrent state update{window}) against a full forward of each row (the chunked scan), "
              f"worst normwise: fp32 {worst32:.3e} (tolerance {SSM_F32_TOL:.0e}); bf16 {worst:.3e} (not gated); "
              f"from the fp32 full forward, the bf16 decode {own:.3e} and the bf16 full forward {floor:.3e}, a "
              f"ratio of {own / floor:.3f} (tolerance {DECODE_FLOOR_FACTOR:g})", flush=True)
        if not (worst32 <= SSM_F32_TOL and own <= DECODE_FLOOR_FACTOR * floor):
            fail(f"{cfg.name}: decode logits {worst32:.3e} (fp32) from the full forward's, or the bf16 decode "
                 f"{own:.3e} from the fp32 forward, past {DECODE_FLOOR_FACTOR:g} x the bf16 forward's {floor:.3e}")
        if cfg.sliding_window and ring != cfg.sliding_window:
            fail(f"{cfg.name}: a ring of {ring} slots, not the window's {cfg.sliding_window}")

    # ---- (a) mamba2-1.3b served dense, pad-invariant prefill, teacher-forced
    cfg = get_config(SSM_ARCH)
    if (cfg.num_layers, cfg.d_inner) != (SSM["layers"], SSM["d_inner"]):
        fail(f"{cfg.name}: {cfg.num_layers} layers of d_inner {cfg.d_inner}, not SSM's {SSM}")
    model = drawn(dev, cfg, 3000)
    rng = np.random.default_rng(3001)
    lengths = rng.integers(SSM_PROMPTS[0], SSM_PROMPTS[1] + 1, SSM_REQS)
    lengths += lengths % SSM_BUCKET == 0  # every prompt carries pads in its bucket
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    news = [int(n) for n in rng.integers(SSM_NEW[0], SSM_NEW[1] + 1, SSM_REQS)]
    reqs = [GenRequest(p, n) for p, n in zip(prompts, news)]
    served, engines, _ = serve_runs("(a)", model, cfg, reqs, card, max_len=SSM_MAX_LEN, slots=SSM_SLOTS,
                                    paged=(False,), bucket=SSM_BUCKET)
    st = engines["dense"].stats
    print(f"  (a) prompts of {sorted(lengths.tolist())} tokens in buckets of {SSM_BUCKET}: padding "
          f"{st.padding_frac:.3f} of the prefilled tokens", flush=True)
    del engines

    # each of the first SSM_SLOTS prompts padded to its bucket (pads of
    # random tokens) against its exact-length prefill
    worst = {"logits": 0.0, "conv": 0.0, "state": 0.0}
    with torch.no_grad():
        for r in range(SSM_SLOTS):
            s0 = len(prompts[r])
            lb = bucket_length(s0, SSM_BUCKET)
            padded = np.concatenate([prompts[r], rng.integers(0, cfg.vocab_size, lb - s0).astype(np.int32)])
            ec, el = lm.prefill(model, {"tokens": prompts[r][None]}, cfg)
            pc, pl = lm.prefill(model, {"tokens": padded[None]}, cfg, last=[s0 - 1])
            if not bool(torch.isfinite(pl).all()):
                fail(f"{cfg.name} padded prefill of {s0} tokens: non-finite logits")
            worst["logits"] = max(worst["logits"], rel(pl, el))
            worst["state"] = max(worst["state"], rel(pc["ssm"]["state"], ec["ssm"]["state"]))
            for key in ("conv_x", "conv_b", "conv_c"):
                worst["conv"] = max(worst["conv"], rel(pc["ssm"][key].float(), ec["ssm"][key].float()))
            del ec, pc
    print(f"  (a) {SSM_SLOTS} prompts prefilled padded to buckets of {SSM_BUCKET} against their exact length: "
          f"worst normwise logits {worst['logits']:.3e}, conv tails {worst['conv']:.3e}, state "
          f"{worst['state']:.3e} (tolerance {PAD_TOL:.3e}, one bf16 unit)", flush=True)
    if not max(worst.values()) <= PAD_TOL:
        fail(f"{cfg.name}: a padded prefill differs from the exact-length one: {worst}")
    seqs = [served["dense"][r] for r in range(SSM_SLOTS)]
    decode_checks("(a)", model, cfg, seqs, [len(prompts[r]) for r in range(SSM_SLOTS)], SSM_MAX_LEN)
    del model, served
    freed()
    lap("(a)")

    # ---- (b) hymba-1.5b served dense past its window, teacher-forced
    hcfg = get_config(HYMBA_ARCH)
    if (hcfg.num_layers, hcfg.d_inner) != (HYMBA["layers"], HYMBA["d_inner"]):
        fail(f"{hcfg.name}: {hcfg.num_layers} layers of d_inner {hcfg.d_inner}, not HYMBA's {HYMBA}")
    w = hcfg.sliding_window
    model = drawn(dev, hcfg, 3010)
    rng = np.random.default_rng(3011)
    lengths = rng.integers(HYMBA_PROMPTS[0], HYMBA_PROMPTS[1] + 1, HYMBA_REQS)
    lengths[:2] = (w - 6, w + 1)  # one bucket that fills the ring, one just past it
    prompts = [rng.integers(0, hcfg.vocab_size, n).astype(np.int32) for n in lengths]
    reqs = [GenRequest(p, HYMBA_NEW) for p in prompts]
    served, engines, _ = serve_runs("(b)", model, hcfg, reqs, card, max_len=HYMBA_MAX_LEN, slots=HYMBA_SLOTS,
                                    paged=(False,))
    exact = [len(p) for p in prompts if bucket_length(len(p), LM_BUCKET) > w]
    print(f"  (b) prompts of {sorted(lengths.tolist())} tokens: {len(exact)} past the window of {w} once padded "
          f"to buckets of {LM_BUCKET}, prefilled at their exact length", flush=True)
    del engines
    seqs = [served["dense"][r] for r in range(HYMBA_SLOTS)]
    starts = [min(max(len(prompts[r]), w + 4), len(seqs[r]) - TEACHER_STEPS) for r in range(HYMBA_SLOTS)]
    decode_checks("(b)", model, hcfg, seqs, starts, HYMBA_MAX_LEN)
    del model, served
    freed()
    lap("(b)")

    # ---- (c) training, both families
    tc = loop.TrainConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    launches = {}
    for c, seed, want in ((cfg, 3002, {SSM["layers"]: 5}), (hcfg, 3012, {HYMBA["layers"]: 8})):
        pipe = TokenPipeline(vocab_size=c.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
        batch = loop.make_batch_fn(c, tc, device=dev)(next(pipe)["tokens"])
        shapes = lm._train_shapes(c)
        # the weights of the matmuls: every leaf but the embedding (a gather),
        # the norm scales, the gates, the conv taps and the (L, H) leaves
        mat = {k: math.prod(s) for k, (s, _) in shapes.items()
               if len(s) == 3 and k != "embed" and ".conv_" not in k}
        n_matmul = sum(mat.values()) + math.prod(shapes["unembed"][0])
        bound_ms = 8 * n_matmul * tokens / PEAK_BF16_FLOPS * 1e3
        groups = ebv_groups(shapes)
        print(f"  (c) {c.name}: {sum(math.prod(s) for s, _ in shapes.values()) / 1e9:.3f} G parameters in "
              f"{len(shapes)} stacked leaves, {n_matmul / 1e9:.3f} G in matmuls; batch {TRAIN_BATCH} x {TRAIN_SEQ} = "
              f"{tokens} tokens a step; EbV order groups (order: systems) {groups}, the widest right-hand side "
              f"{max(max(s) for s, _ in shapes.values() if len(s) == 2 and min(s) <= 1024)}", flush=True)
        if groups != want:
            fail(f"{c.name} EbV order groups {groups}: expected {want}")

        def fresh(c=c, seed=seed):
            params = lm.train_params(lm.init_params(torch.Generator(device=dev).manual_seed(seed), c))
            freed()
            return params

        got = train_runs(dev, card, "(c)", c, batch, fresh, groups, tokens, [
            (bound_ms, f"8 x {n_matmul / 1e9:.3f} G x {tokens} tokens / 989 TFLOP/s bf16")])
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        del batch
        freed()
    lap("(c)")

    # ---- (d) the reduced fp32 configs, 3 steps on the card against the CPU,
    # at a sequence of four chunks (and past hymba's reduced window of 32)
    for arch in (SSM_ARCH, HYMBA_ARCH):
        rcfg = get_config(arch).reduced()
        rng = np.random.default_rng(3003)
        rbatches = [rng.integers(0, rcfg.vocab_size, (4, 64)).astype(np.int32) for _ in range(3)]
        start = lm.train_params(lm.init_params(3004, rcfg, device="cpu"))
        card_against_cpu(dev, "(d)", rcfg, start,
                         lambda d, rbatches=rbatches: [{"tokens": torch.from_numpy(b).to(d)} for b in rbatches],
                         [(name, mb, tc.learning_rate) for name in ("adamw", "ebv") for mb in (1, 2)])
    lap("(d)")

    # ---- (e) the launchers, on the card by default, in two subprocesses at once
    run_launchers([(["repro_torch.launch.serve", "--arch", SSM_ARCH], "served 4 requests (64 new tokens)"),
                   (["repro_torch.launch.train", "--arch", HYMBA_ARCH, "--optimizer", "ebv", "--steps", "3"],
                    "[train] step     0 loss")])
    print(f"  phase 4m: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def main() -> int:
    t_start = time.perf_counter()
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
    from repro_torch.core.blocked import fused_block_size
    from repro_torch.core.factorization import banded_inverted_solve, factorize_banded
    from repro_torch import train
    from repro_torch.kernels import _build, banded, batched_lu, ebv_lu, ops, ref, trsm
    from repro_torch.core import refine
    from repro_torch.core.pivoted import PivotedFactors
    from repro_torch.serve import Engine, GenRequest, SolveService, bucket_length, fingerprint
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attn
    from repro_torch.models import lm
    from repro_torch.solvers.backends import RAND_LU_RESIDUAL_BOUND, banded_static_impl, blocked_launches
    # B10 on both paths (kernels/batched_lu.py:batched_solve_plan) at shapes
    # on either side of the plan's split, the optimizer's group among them;
    # B6's cluster walk over its CTAs and pivots a group
    from repro_torch.launch import time_kernels
    from repro_torch.launch.time_kernels import SOLVE_SPLIT

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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

    def compare(name, shape, got, want, tol=KERNEL_TOL):
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{name} {shape}: shape {tuple(got.shape)} or non-finite values")
        abs_err = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max())
        # nothing to scale by (L of a 1 x 1 factor): only equality passes
        rel = abs_err / scale if scale else (0.0 if abs_err == 0 else float("inf"))
        max_err[name] = max(max_err.get(name, 0.0), abs_err)
        print(f"  {name:15s} {shape:14s} max_abs {abs_err:.3e}  rel {rel:.3e}", flush=True)
        if not rel <= tol:
            fail(f"{name} {shape}: kernel disagrees with its plain version ({rel:.3e})")

    def compare_lu(name, shape, got, want):
        # L (strictly below the diagonal, ~1e-3) and U (~n/2 on the diagonal)
        # each against its own largest entry, so neither hides in the other
        compare(name, f"{shape} L", got.tril(-1), want.tril(-1))
        compare(name, f"{shape} U", got.triu(), want.triu())

    def once(fn):
        """``fn()`` and its time in ms on the card, one call."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    lus = {n: ebv_lu.lu_fused(matrix(n, n)) for n in SIZES}
    fused_plain_ms = {}
    for n in SIZES[:-1]:
        want, fused_plain_ms[n] = once(lambda: ebv_lu.lu_fused_plain(matrix(n, n)))
        compare_lu("lu_fused", f"n={n}", lus[n], want)
    # the service's n = 1024 and the bf16_ir tier's and the service's
    # n = 4096 (phases 4g, 4h); n = 255, a step of 128 and a ragged one;
    # block=50, which steps by 48 columns, a width no update tile divides
    for n, blk in ((SERVE_DENSE[0], 256), (IR_N, 256), (255, 256), (600, 50)):
        a = matrix(n, 950 + n)
        compare_lu("lu_fused", f"n={n}" + (f" block={blk}" if blk != 256 else ""),
                   ebv_lu.lu_fused(a, block=blk), ebv_lu.lu_fused_plain(a, block=blk))
    # n = 8000 against an independent factor: the plain version, one call, if
    # its host-bound loop (~S^2 small launches, S = n / B) should end within
    # about a minute by the n = 2000 call's time; lu_factor(pivot=False) if not
    steps = {n: -(-n // fused_block_size(n, 256)) for n in (2000, 8000)}
    plain8_est = fused_plain_ms[2000] * (steps[8000] / steps[2000]) ** 2 / 1e3
    plain8_ms = None  # phase 5 reads it
    if plain8_est <= 60:
        want8, plain8_ms = once(lambda: ebv_lu.lu_fused_plain(matrix(8000, 8000)))
        print(f"  lu_fused n=8000 against the plain version (estimated {plain8_est:.0f} s from n=2000; "
              f"took {plain8_ms / 1e3:.1f} s)", flush=True)
    else:
        want8 = torch.linalg.lu_factor(matrix(8000, 8000), pivot=False)[0]
        print(f"  lu_fused n=8000 against torch.linalg.lu_factor(pivot=False) (the plain version estimated "
              f"at {plain8_est:.0f} s from n=2000)", flush=True)
    compare_lu("lu_fused", "n=8000", lus[8000], want8)
    del want8
    inverses = {n: dense_block_inverses(lus[n], block=256) for n in SIZES}
    # B2 at the dense path's sizes up to the dispatch cap (SOLVE_VMEM_MAX_N =
    # 2048), the service's flush shapes (n = 1024, 8 columns) and past the
    # resident split (n = 4000): one launch of the plan its Python mirror names
    for n in VMEM_SOLVE_N:
        lu = lus[n] if n in lus else ebv_lu.lu_fused(matrix(n, n))
        for m in VMEM_SOLVE_M:
            b = rhs(n, m, 7 + m)
            compare("solve_vmem", f"n={n} m={m}", trsm.solve_vmem(lu, b), trsm.solve_vmem_plain(lu, b))
            want = trsm.solve_vmem_plan(n, m, sms)
            if trsm.solve_vmem.last_plan != tuple(want)[:6]:
                fail(f"solve_vmem n={n} m={m}: plan {trsm.solve_vmem.last_plan} differs from the mirror's {want}")
        print(f"    plan solve_vmem n={n}: {want.blocks} blocks of R = {want.rows} rows, theta {want.theta}, "
              f"resident share {want.resident:.3f}, {want.bytes} B of shared memory a block (m={m})", flush=True)
    # past about 240 rows a block no copy of a streamed diagonal tile fits:
    # held against the same sweeps by torch.linalg.solve_triangular (the
    # plain version's column loop takes minutes at this n)
    lu = ebv_lu.lu_fused(matrix(VMEM_LARGE_N, 31))
    for m in (1, WIDE):
        b = rhs(VMEM_LARGE_N, m, 32 + m)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = trsm.solve_vmem(lu, b)
        end.record()
        end.synchronize()
        want = trsm.solve_vmem_plan(VMEM_LARGE_N, m, sms)
        bm = b[:, None] if m == 1 else b
        x = torch.linalg.solve_triangular(lu, torch.linalg.solve_triangular(lu, bm, upper=False, unitriangular=True),
                                          upper=True)
        compare("solve_vmem", f"n={VMEM_LARGE_N} m={m}", got, x[:, 0] if m == 1 else x)
        if trsm.solve_vmem.last_plan != tuple(want)[:6] or want.copy:
            fail(f"solve_vmem n={VMEM_LARGE_N} m={m}: plan {trsm.solve_vmem.last_plan}, the mirror's {want}")
        print(f"    plan solve_vmem n={VMEM_LARGE_N} m={m}: {want.blocks} blocks of R = {want.rows} rows, theta "
              f"{want.theta}, no copy of a streamed diagonal tile, {want.bytes} B a block; the first call "
              f"{start.elapsed_time(end):.3f} ms (events; card: {card})", flush=True)
    del lu, got, x
    for m in (1, WIDE):
        for n in (2000, 8000):
            b = rhs(n, m, 8)
            linv, uinv = inverses[n]
            compare("solve_tiled", f"n={n} m={m}", trsm.solve_tiled(lus[n], b),
                    trsm.solve_tiled_plain(lus[n], b))
            compare("solve_inverted", f"n={n} m={m}", trsm.solve_inverted(lus[n], linv, uinv, b),
                    dense_inverted_solve(lus[n], linv, uinv, b))
    # B3 and B4 across their splits: n = 1, n under one 128-tile, a ragged
    # n = 2049 (B4 also from 128- and 512-blocks, the latter in two passes);
    # narrow, wide and several wide tiles
    for n in RAGGED_N:
        a = matrix(n, 900 + n)
        lu = ebv_lu.lu_fused(a)
        compare_lu("lu_fused", f"n={n}", lu, ebv_lu.lu_fused_plain(a))
        for m in RAGGED_M:
            b = rhs(n, m, 910 + m)
            compare("solve_tiled", f"n={n} m={m}", trsm.solve_tiled(lu, b), trsm.solve_tiled_plain(lu, b))
            for blk in (128, 256, 512) if n > 128 else (256,):
                linv, uinv = dense_block_inverses(lu, block=blk)
                compare("solve_inverted", f"n={n} m={m} B={linv.shape[1]}",
                        trsm.solve_inverted(lu, linv, uinv, b), dense_inverted_solve(lu, linv, uinv, b))

    def compare_band_lu(name, shape, got, want, bw):
        # L (columns 0..bw-1) and U (bw..2bw) of the packed band apart
        compare(name, f"{shape} L", got[:, :bw], want[:, :bw])
        compare(name, f"{shape} U", got[:, bw:], want[:, bw:])

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
            (pn, POISSON_NX, ("banded_lu_tiled",), (1,), True),
            (*PAST_CLUSTERS, ("banded_lu_tiled",), (1, WIDE), False)):
        a = apoisson if n == pn else band(n, bw, n + bw)
        plain, plain_ms = once(lambda: banded.banded_lu_plain(a, bw=bw))
        plain_once[f"n={n} bw={bw}"] = plain_ms
        for name in factors:
            got = getattr(banded, name)(a, bw=bw)
            compare_band_lu(name, f"n={n} bw={bw}", got, plain, bw)
            equal = bool(torch.equal(got, plain))
            plan = f"; plan {banded.banded_lu_tiled.last_plan}" if name == "banded_lu_tiled" else ""
            print(f"    bitwise equal to the plain version: {equal}{plan}", flush=True)
            if not equal:  # the band factors round every operation as the plain version does
                fail(f"{name} n={n} bw={bw}: not bitwise equal to its plain version")
        f = factorize_banded(plain, bw=bw) if inverted else None
        for m in widths:
            b = rhs(n, m, 12)
            shape = f"n={n} bw={bw} m={m}"
            want, plain_once[shape] = once(lambda: banded_solve_blocked(plain, b, bw=bw))
            compare("banded_solve_kernelized", shape, banded.banded_solve_kernelized(plain, b, bw=bw), want)
            print(f"    plan {banded.banded_solve_kernelized.last_plan}", flush=True)
            if inverted:
                got = banded.banded_solve_inverted(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw)
                compare("banded_solve_inverted", shape, got,
                        banded_inverted_solve(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw))
                # the narrow products and the warp scans sum as the tiles and the block scan do
                same = bool(torch.equal(got, banded._solve_inverted(f.linv, f.uinv, f.tlo, f.tup, b, n=n, bw=bw,
                                                                    tiles=True)))
                print(f"    bitwise equal to the block kernels: {same}", flush=True)
                if not same:
                    fail(f"banded_solve_inverted {shape}: differs from the block kernels")
    pshape = f"n={pn} bw={POISSON_NX}"
    print(f"  plain versions at the Poisson band, one call each: factor {plain_once[pshape]:.1f} ms, "
          f"solve m=1 {plain_once[pshape + ' m=1']:.1f} ms", flush=True)

    # ---- 3b. B5's walks at the bands on either side of the warp walk ------
    print("phase 3b: B5 (banded_lu_blocked), B11 (batched_banded_lu_vmem, 3 systems) and B18 "
          f"(banded_lu_kernelized) bit for bit on the warp walk (bw <= {banded.WARP_WALK_MAX_BW}) and on "
          "the ring and device-memory walks past it; bands with entries outside the matrix", flush=True)

    def any_band(n, bw, seed):
        # a diagonally dominant band whose entries outside the matrix are not zero
        g = torch.Generator(device=dev).manual_seed(seed)
        a = torch.rand((n, 2 * bw + 1), generator=g, device=dev) * 2 - 1
        a[:, bw] = a.abs().sum(dim=1) + 1
        return a

    for bw in WALK_BANDS:
        for n in (bw + 1, 2 * bw + 3, 257, 4000):
            a = any_band(n, bw, 1900 + 7 * n + bw)
            got, want = banded.banded_lu_blocked(a, bw=bw), banded.banded_lu_plain(a, bw=bw)
            torch.cuda.synchronize()
            walk, equal = banded.banded_lu_blocked.last_path, bool(torch.equal(got, want))
            max_err["banded_lu_blocked"] = max(max_err["banded_lu_blocked"],
                                               float((got.double() - want.double()).abs().max()))
            print(f"  {'banded_lu_blocked':18s} n={n:5d} bw={bw:3d} {walk:19s} bitwise equal: {equal}", flush=True)
            if not equal or walk != banded.band_lu_walk(n, bw):
                fail(f"banded_lu_blocked n={n} bw={bw}: {walk} (mirror: {banded.band_lu_walk(n, bw)}), "
                     f"bitwise equal {equal}")
            s3 = torch.stack([a, any_band(n, bw, 2900 + n + bw), any_band(n, bw, 3900 + n + bw)])
            for name, x, plain_fn in (("batched_banded_lu_vmem", s3, banded.banded_lu_plain),
                                      ("banded_lu_kernelized", a, banded.banded_lu_scalar_plain)):
                fn = getattr(banded, name)
                got, want = fn(x, bw=bw), plain_fn(x, bw=bw)
                torch.cuda.synchronize()
                walk, equal = fn.last_path, bool(torch.equal(got, want))
                max_err[name] = max(max_err.get(name, 0.0), float((got.double() - want.double()).abs().max()))
                print(f"  {name:22s} n={n:5d} bw={bw:3d} {walk:19s} bitwise equal: {equal}", flush=True)
                if not equal or walk != banded.band_lu_walk(n, bw):
                    fail(f"{name} n={n} bw={bw}: {walk} (mirror: {banded.band_lu_walk(n, bw)}), "
                         f"bitwise equal {equal}")
    a = any_band(300, 5, 1990)
    a[0, 5] = 0  # a zero first pivot: inf and NaN where the plain version has them
    got, want = banded.banded_lu_blocked(a, bw=5), banded.banded_lu_plain(a, bw=5)
    torch.cuda.synchronize()
    gnan, wnan = torch.isnan(got), torch.isnan(want)
    same = bool(torch.equal(gnan, wnan)) and bool(torch.equal(got.masked_fill(gnan, 0), want.masked_fill(wnan, 0)))
    print(f"  {'banded_lu_blocked':18s} n=  300 bw=  5 zero pivot: NaN {int(wnan.sum())}, inf "
          f"{int(torch.isinf(want).sum())} in the plain version; positions and finite values equal: {same}",
          flush=True)
    if not same or bool(torch.isfinite(want).all()):
        fail("banded_lu_blocked on a zero pivot differs from its plain version")

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
    bstacks = {(bsz, n): stack(bsz, n, 850 + n) for bsz, n in BATCHED_DENSE + tuple(GROUP_RHS)}
    blus = {}
    for (bsz, n), a in bstacks.items():
        blus[(bsz, n)] = batched_lu.batched_lu_vmem(a)
        compare_bitwise("batched_lu_vmem", f"B={bsz} n={n}", blus[(bsz, n)],
                        batched_lu.batched_lu_plain(a))
    room = batched_lu.cluster_room(dev)
    print(f"  clusters of 2 / 4 / 8 / 16 CTAs of B9's cluster kernel the card holds at once: "
          f"{' / '.join(str(room[c]) for c in batched_lu.CLUSTER_SIZES)}", flush=True)

    def batched_plan_line(bsz, n):
        """The plan the C entry launched, checked against its Python mirror."""
        kind, ctas, theta, nbytes, active = batched_lu.batched_lu_vmem.last_plan
        want = batched_lu.batched_lu_plan(bsz, n, sms, room)
        kind = ("staged", "global", "cluster")[kind]
        extra = (f", theta {theta}, {nbytes} B of shared memory a CTA, resident share "
                 f"{want.walk.resident:.3f}, {active} such clusters at once" if kind == "cluster" else "")
        print(f"    plan B={bsz} n={n}: {kind}, {ctas} CTA(s) a system{extra}", flush=True)
        if (kind, ctas) != (want.kind, want.ctas) or (
                kind == "cluster" and (theta, nbytes) != (want.walk.theta, want.walk.bytes)):
            fail(f"batched_lu_vmem B={bsz} n={n}: plan {batched_lu.batched_lu_vmem.last_plan} "
                 f"differs from the mirror's {want}")

    for (bsz, n), a in bstacks.items():
        batched_lu.batched_lu_vmem(a)
        batched_plan_line(bsz, n)
    for bsz, n in BATCHED_EDGES:
        a = stack(bsz, n, 860 + n)
        compare_bitwise("batched_lu_vmem", f"B={bsz} n={n}", batched_lu.batched_lu_vmem(a),
                        batched_lu.batched_lu_plain(a))
        batched_plan_line(bsz, n)
    for (bsz, n), lu in blus.items():
        for m in GROUP_RHS.get((bsz, n), (1, n)):
            b = rhs_stack(bsz, n, m, 870 + n + m)
            compare_bitwise("batched_lu_solve_vmem", f"B={bsz} n={n} m={m}",
                            batched_lu.batched_lu_solve_vmem(lu, b),
                            batched_lu.batched_lu_solve_plain(lu, b))
    solve_room = batched_lu.solve_cluster_room(dev)
    print(f"  clusters of 2 / 4 / 8 / 16 CTAs of B10's cluster kernel the card holds at once: "
          f"{' / '.join(str(solve_room[c]) for c in batched_lu.CLUSTER_SIZES)}", flush=True)

    def solve_plan_line(bsz, n, m, path=None):
        """The plan B10's C entry reports (the shared-memory bytes its own
        count), checked against the Python plan it was given."""
        kind, cols, ctas, nbytes, active = batched_lu.batched_lu_solve_vmem.last_plan
        want = batched_lu.batched_solve_plan(bsz, n, m, sms, solve_room, path)
        got = (("none", "wide", "cluster")[kind], cols, ctas, nbytes)
        at_once = f", {active} such clusters at once" if kind == 2 else ""
        print(f"    plan B={bsz} n={n} m={m}{'' if path is None else ' forced ' + path}: {got[0]}, "
              f"{cols} columns a tile, {ctas} CTA(s), {nbytes} B of shared memory a CTA{at_once}", flush=True)
        if got != tuple(want):
            fail(f"batched_lu_solve_vmem B={bsz} n={n} m={m}: plan {got} differs from the Python plan {want}")

    split_lus = {}
    for bsz, n, m in SOLVE_SPLIT:
        lu = split_lus.get((bsz, n))
        if lu is None:
            lu = split_lus[(bsz, n)] = batched_lu.batched_lu_vmem(stack(bsz, n, 1300 + n))
        b = rhs_stack(bsz, n, m, 1310 + m)
        want = batched_lu.batched_lu_solve_plain(lu, b)
        for path in (None, "wide", "cluster"):
            got = (batched_lu.batched_lu_solve_vmem(lu, b) if path is None else
                   batched_lu._solve(lu, b, batched_lu.batched_solve_plan(bsz, n, m, sms, solve_room, path)))
            compare_bitwise("batched_lu_solve_vmem", f"B={bsz} n={n} m={m} {path or 'plan'}", got, want)
            solve_plan_line(bsz, n, m, path)
    ensembles = {ENSEMBLE_T1: band_stack(*ENSEMBLE_T1, 880),
                 (ENSEMBLE_MEMBERS, ENSEMBLE_NX ** 2, ENSEMBLE_NX):
                     poisson_ensemble(ENSEMBLE_MEMBERS, ENSEMBLE_NX),
                 ENSEMBLE_SMALL: band_stack(*ENSEMBLE_SMALL, 970)}
    eplain, eplain_ms = {}, {}
    for (bsz, n, bw), a in ensembles.items():
        shape = f"B={bsz} n={n} bw={bw}"
        eplain[(bsz, n, bw)], eplain_ms[shape] = once(lambda: banded.banded_lu_plain(a, bw=bw))
        compare_bitwise("batched_banded_lu_vmem", shape, banded.batched_banded_lu_vmem(a, bw=bw),
                        eplain[(bsz, n, bw)])
        walk = banded.batched_banded_lu_vmem.last_path
        print(f"    {walk} (mirror: {banded.band_lu_walk(n, bw)})", flush=True)
        if walk != banded.band_lu_walk(n, bw):
            fail(f"batched_banded_lu_vmem {shape}: {walk}, not {banded.band_lu_walk(n, bw)}")
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
        # B12 is B7's kernel and plan over the stack: each system bitwise B7 on it alone
        report, plan = banded.batched_banded_solve_vmem.last_plan, banded.band_solve_plan(n, bw, 1)
        print(f"    plan (path 1 staged / 0 per-warp, warps, columns a block, stages, shared-memory bytes): "
              f"{report}; band_solve_plan: {tuple(plan)}", flush=True)
        if report != (1, plan.warps, plan.cols, plan.stages, plan.bytes):
            fail(f"batched_banded_solve_vmem {shape}: launched {report}, not band_solve_plan's {plan}")
        same = sum(bool(torch.equal(got[s], banded.banded_solve_kernelized(eplain[(bsz, n, bw)][s], b[s], bw=bw)))
                   for s in range(bsz))
        print(f"    systems bitwise B7 (banded_solve_kernelized) on each alone: {same} of {bsz}", flush=True)
        if same != bsz:
            fail(f"batched_banded_solve_vmem {shape}: {bsz - same} systems differ from B7 on them alone")

    # ---- 3d. the legacy dense kernels against their plain versions --------
    print(f"phase 3d: legacy kernels vs plain (B16, B17 bit for bit; B14, B15 normwise, "
          f"tolerance {LEGACY_TOL:.0e}; bf16 B14 max_abs <= {BF16_UPDATE_ATOL})", flush=True)
    legacy_plain_ms = {}  # the plain lu_vmem at n = 4096, one call; phase 5 reads it
    for n in VMEM_SIZES:
        a = matrix(n, 1100 + n)
        plain, ms = once(lambda: ebv_lu.lu_vmem_plain(a))
        if n == VMEM_SIZES[-1]:
            legacy_plain_ms[f"n={n}"] = ms
        compare_bitwise("lu_vmem", f"n={n}", ebv_lu.lu_vmem(a), plain)
    print(f"  the plain lu_vmem at n={VMEM_SIZES[-1]}, one call: {legacy_plain_ms[f'n={VMEM_SIZES[-1]}']:.1f} ms",
          flush=True)

    def walk_plan_line(wrapper, m, ncols, dtype):
        """The plan the C entry launched, checked against its Python mirror."""
        want = ebv_lu.legacy_walk_plan(m, ncols, dtype, sms)
        print(f"    plan {wrapper.__name__} ({m}, {ncols}) {str(dtype)[6:]}: {want.parts} blocks, theta "
              f"{want.theta}, {want.bytes} B of shared memory a block, resident share {want.resident:.3f}",
              flush=True)
        if wrapper.last_plan != (want.parts, want.theta, want.bytes):
            fail(f"{wrapper.__name__} ({m}, {ncols}): plan {wrapper.last_plan} differs from the mirror's {want}")

    walk_plan_line(ebv_lu.lu_vmem, VMEM_SIZES[-1], VMEM_SIZES[-1], torch.float32)
    for n, dname in VMEM_EDGES:
        dtype = getattr(torch, dname)
        a = matrix(n, 1150 + n).to(dtype)
        compare_bitwise("lu_vmem", f"n={n} {dname}", ebv_lu.lu_vmem(a), ebv_lu.lu_vmem_plain(a))
        walk_plan_line(ebv_lu.lu_vmem, n, n, dtype)
    for n, p, dname in VMEM_ZERO_PIVOTS:
        a = matrix(n, 1180 + n).to(getattr(torch, dname))
        if p == 0:
            a[0, 0] = 0
        else:
            a[p] = a[p - 1]
        got, want = ebv_lu.lu_vmem(a), ebv_lu.lu_vmem_plain(a)
        torch.cuda.synchronize()
        gnan, wnan = torch.isnan(got), torch.isnan(want)
        same = bool(torch.equal(gnan, wnan)) and bool(torch.equal(got.masked_fill(gnan, 0),
                                                                  want.masked_fill(wnan, 0)))
        print(f"  {'lu_vmem':25s} {f'n={n} zero pivot {p} {dname}':24s} NaN {int(wnan.sum())}, inf "
              f"{int(torch.isinf(want).sum())} in the plain version; NaN and inf positions and the finite "
              f"values equal: {same}", flush=True)
        if not same or bool(torch.isfinite(want).all()):
            fail(f"lu_vmem n={n} zero pivot {p} {dname}: kernel differs from its plain version")
    for n in (2000, 8000):  # the driver's first panel
        p = matrix(n, 1200 + n)[:, :LEGACY_BLOCK]
        compare_bitwise("panel", f"m={n} b={LEGACY_BLOCK}", ebv_lu.panel(p), ebv_lu.panel_plain(p))
        walk_plan_line(ebv_lu.panel, n, LEGACY_BLOCK, torch.float32)
        p = p.to(torch.bfloat16)
        compare_bitwise("panel", f"m={n} b={LEGACY_BLOCK} bf16", ebv_lu.panel(p), ebv_lu.panel_plain(p))
    # the driver's first fused step at n = 2000: width 1744 padded to 1792, ct = 128
    a = matrix(2000, 1300)
    pan = ebv_lu.panel(a[:, :LEGACY_BLOCK])
    wpad = -(-(2000 - LEGACY_BLOCK) // 128) * 128
    top = torch.nn.functional.pad(a[:LEGACY_BLOCK, LEGACY_BLOCK:], (0, wpad - 2000 + LEGACY_BLOCK))
    trail = torch.nn.functional.pad(a[LEGACY_BLOCK:, LEGACY_BLOCK:], (0, wpad - 2000 + LEGACY_BLOCK))
    step_args = (pan, top, trail)
    u12, new_trail = ebv_lu.fused_step(*step_args, col_tile=128)
    pu12, pnew = ebv_lu.fused_step_plain(*step_args)
    compare_bitwise("fused_step", "n=2000 U12", u12, pu12)
    compare("fused_step", f"n=2000 A22", new_trail, pnew, LEGACY_TOL)
    # the driver's first step at n = 8000 (W = 7744), fp32 and bf16
    a8k = matrix(8000, 1310)
    for dtype in (torch.float32, torch.bfloat16):
        args8 = (ebv_lu.panel(a8k[:, :LEGACY_BLOCK].to(dtype)), a8k[:LEGACY_BLOCK, LEGACY_BLOCK:].to(dtype),
                 a8k[LEGACY_BLOCK:, LEGACY_BLOCK:].to(dtype))
        got_u, got_a = ebv_lu.fused_step(*args8, col_tile=64)  # W = 7744 = 121 * 64
        want_u, want_a = ebv_lu.fused_step_plain(*args8)
        dname = str(dtype)[6:]
        compare_bitwise("fused_step", f"n=8000 U12 {dname}", got_u, want_u)
        compare("fused_step", f"n=8000 A22 {dname}", got_a.float(), want_a.float(),
                LEGACY_TOL if dtype == torch.float32 else BF16_UPDATE_TOL)
    del a8k, args8, got_u, got_a, want_u, want_a
    # C6: a U12 column holding a non-finite value (an inf in A12, or an inf in
    # L11 meeting an exact zero of U12) is NaN throughout, in U12 and A22
    for poison in ("a12_inf", "l11_zero_times_inf"):
        ptop, ppan = top.clone(), pan.clone()
        if poison == "a12_inf":
            ptop[2, 1] = float("inf")
        else:
            ptop[0, 0] = 0
            ppan[1, 0] = float("inf")
        got_u, got_a = ebv_lu.fused_step(ppan, ptop, trail, col_tile=128)
        want_u, want_a = ebv_lu.fused_step_plain(ppan, ptop, trail)
        torch.cuda.synchronize()
        col = 1 if poison == "a12_inf" else 0
        same = bool(torch.equal(torch.isnan(got_u), torch.isnan(want_u))) \
            and bool(torch.equal(got_u.nan_to_num(0), want_u.nan_to_num(0))) \
            and bool(torch.equal(torch.isnan(got_a), torch.isnan(want_a)))
        finite = ~torch.isnan(want_a)
        rel = (float((got_a[finite].double() - want_a[finite].double()).abs().max()
                     / want_a[finite].double().abs().max()) if bool(finite.any()) else 0.0)
        nan_cols = int(torch.isnan(want_u).all(dim=0).sum())
        print(f"  {'fused_step':15s} n=2000 {poison}: {nan_cols} U12 column(s) NaN throughout in the plain "
              f"version; NaN positions in U12 and A22 and the finite U12 equal: {same}; finite A22 rel "
              f"{rel:.3e}", flush=True)
        if not same or not bool(torch.isnan(want_u[:, col]).all()) or not rel <= LEGACY_TOL:
            fail(f"fused_step {poison}: the kernel differs from its plain version on a non-finite column (C6)")
    g = torch.Generator(device=dev).manual_seed(1400)
    upd_args = tuple(torch.randn(shape, generator=g, device=dev)
                     for shape in ((wpad, LEGACY_BLOCK), (LEGACY_BLOCK, wpad), (wpad, wpad)))
    compare("update", f"{tuple(upd_args[0].shape[:1]) + tuple(upd_args[1].shape)}",
            ebv_lu.update(*upd_args), ebv_lu.update_plain(*upd_args), LEGACY_TOL)
    # B14 on B1's SGEMM tile at ragged edges in rows, columns and depth, one
    # element and a narrow tall block; A22 left as it was
    for shape in UPDATE_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            args = tuple(torch.randn(d, generator=g, device=dev).to(dtype)
                         for d in ((shape[0], shape[1]), (shape[1], shape[2]), (shape[0], shape[2])))
            keep = args[2].clone()
            got = ebv_lu.update(*args, row_tile=shape[0], col_tile=shape[2])
            compare("update", f"{shape} {str(dtype)[6:]}", got.float(), ebv_lu.update_plain(*args).float(),
                    LEGACY_TOL if dtype == torch.float32 else BF16_UPDATE_TOL)
            if not torch.equal(args[2], keep):
                fail(f"update {shape}: A22 changed")
    bargs = tuple(torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                  for shape in ((128, 32), (32, 64), (128, 64)))
    got = ebv_lu.update(*bargs, row_tile=64, col_tile=32)
    want = ebv_lu.update_plain(*bargs)
    torch.cuda.synchronize()
    abs_err = float((got.double() - want.double()).abs().max())
    print(f"  {'update':15s} (128, 32, 64) bf16 max_abs {abs_err:.3e}  rel "
          f"{abs_err / float(want.double().abs().max()):.3e}", flush=True)
    if got.dtype != torch.bfloat16 or not abs_err <= BF16_UPDATE_ATOL:
        fail(f"update bf16: kernel disagrees with its plain version ({abs_err:.3e})")

    # B18 at the band the service's escalation gives it (phase 4h), finite here
    sband = band(*SERVE_BAND, 1870)
    plain, legacy_plain_ms["scalar band"] = once(lambda: banded.banded_lu_scalar_plain(sband, bw=SERVE_BAND[1]))
    compare_bitwise("banded_lu_kernelized", f"n={SERVE_BAND[0]} bw={SERVE_BAND[1]}",
                    banded.banded_lu_kernelized(sband, bw=SERVE_BAND[1]), plain)
    print(f"    {banded.banded_lu_kernelized.last_path}", flush=True)
    print(f"  the plain scalar band factor at n={SERVE_BAND[0]} bw={SERVE_BAND[1]}, one call: "
          f"{legacy_plain_ms['scalar band']:.1f} ms", flush=True)
    # B18 on the service's NaN-poisoned band (phase 4h: NaN at pivot 5) and on
    # an inf in pivot row 3000's upper tail (fault C7): NaN and inf where the
    # plain version has them, every finite value equal
    for label, at, value in (("NaN pivot 5", (5, SERVE_BAND[1]), float("nan")),
                             ("inf tail of row 3000", (3000, SERVE_BAND[1] + 2), float("inf"))):
        pband = band(*SERVE_BAND, 1862)
        pband[at] = value
        got = banded.banded_lu_kernelized(pband, bw=SERVE_BAND[1])
        want = banded.banded_lu_scalar_plain(pband, bw=SERVE_BAND[1])
        torch.cuda.synchronize()
        same = all(bool(torch.equal(f(got), f(want))) for f in (torch.isnan, torch.isposinf, torch.isneginf))
        fin = torch.isfinite(want)
        same = same and bool(torch.equal(got[fin], want[fin]))
        print(f"  {'banded_lu_kernelized':25s} n={SERVE_BAND[0]} bw={SERVE_BAND[1]} {label}: NaN "
              f"{int(torch.isnan(want).sum())}, inf {int(torch.isinf(want).sum())} in the plain version; "
              f"positions and finite values equal: {same}", flush=True)
        if not same or bool(fin.all()):
            fail(f"banded_lu_kernelized {label}: differs from its plain version")

    # ---- 3e. the paged decode attention against its plain version ---------
    print(f"phase 3e: paged decode attention (B13) vs plain (normwise, tolerance {PAGED_TOL})", flush=True)
    mcfg = get_config(LM_ARCH)
    kvh, dh = mcfg.num_kv_heads, mcfg.resolved_head_dim
    served_np = LM_MAX_LEN // PAGE

    def paged_case(b, h, np_, dtype, seed, holes=True, kv=kvh, hd=dh):
        """B13's inputs: b rows of np_ distinct pages of 16 over a pool of
        b * np_ + 1 pages, h query and ``kv`` KV heads of ``hd``; with
        ``holes``, a -1 inside row 0's length and one past the last row's;
        row 0 ends mid-page."""
        g = torch.Generator(device=dev).manual_seed(seed)
        pool = b * np_ + 1
        q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
        kp = torch.randn((pool, PAGE, kv, hd), generator=g, device=dev).to(dtype)
        vp = torch.randn((pool, PAGE, kv, hd), generator=g, device=dev).to(dtype)
        table = (1 + torch.randperm(pool - 1, generator=g, device=dev)).reshape(b, np_).to(torch.int32)
        lengths = torch.full((b,), np_ * PAGE, dtype=torch.int32, device=dev)
        if holes:
            lengths[0] = (np_ - 3) * PAGE + 7
            lengths[-1] = (np_ - 2) * PAGE + 5
            table[0, 1] = -1
            table[-1, -1] = -1
        return q, kp, vp, table, lengths

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for h in (mcfg.num_heads, kvh):  # rep 4 and rep 1
            for b, np_ in ((LM_SLOTS, served_np), DECODE_HEAVY):
                if np_ != served_np and h != mcfg.num_heads:
                    continue
                args = paged_case(b, h, np_, dtype, 1500 + b + h)
                want = paged_attn.paged_decode_attention_plain(*args)
                compare("paged_decode_attention", f"B={b} NP={np_} rep={h // kvh} {dname}",
                        paged_attn.paged_decode_attention(*args), want, PAGED_TOL[dname])
                print(f"    plan {paged_attn.paged_decode_attention.last_plan}", flush=True)
                if h == mcfg.num_heads:  # forced onto clusters of every size
                    for k in time_kernels.PAGED_CTAS:
                        plan = paged_attn.paged_plan(b, h, kvh, dh, np_, PAGE, args[0].element_size(), sms,
                                                     ctas=k)
                        compare("paged_decode_attention", f"B={b} NP={np_} K={k} {dname}",
                                paged_attn._attend(*args, plan), want, PAGED_TOL[dname])
                del args, want
    # whisper-tiny's served shape (phase 4k): H = KV = 6, one query head a
    # group, Dh = 64 (a 64-wide row on 8 or 16 lanes), through the wrapper
    # and forced onto clusters of every size
    wcfg = get_config(WHISPER_ARCH)
    wh, wkv, wdh, whisper_np = wcfg.num_heads, wcfg.num_kv_heads, wcfg.resolved_head_dim, WHISPER_MAX_LEN // PAGE
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        wshape = f"B={WHISPER_SLOTS} NP={whisper_np} H=KV={wh} Dh={wdh} {dname}"
        args = paged_case(WHISPER_SLOTS, wh, whisper_np, dtype, 1550, kv=wkv, hd=wdh)
        want = paged_attn.paged_decode_attention_plain(*args)
        compare("paged_decode_attention", wshape, paged_attn.paged_decode_attention(*args), want,
                PAGED_TOL[dname])
        print(f"    plan {paged_attn.paged_decode_attention.last_plan}", flush=True)
        for k in time_kernels.PAGED_CTAS:
            plan = paged_attn.paged_plan(WHISPER_SLOTS, wh, wkv, wdh, whisper_np, PAGE, args[0].element_size(),
                                         sms, ctas=k)
            compare("paged_decode_attention", f"{wshape} K={k}", paged_attn._attend(*args, plan), want,
                    PAGED_TOL[dname])
        del args, want
    # granite-moe-1b-a400m's served shape (phase 4l): H = 16, KV = 8, two query
    # heads a KV head, Dh = 64, through the wrapper and forced onto clusters of
    # every size
    gcfg = get_config(GRANITE_ARCH)
    gh, gkv, gdh, granite_np = gcfg.num_heads, gcfg.num_kv_heads, gcfg.resolved_head_dim, GRANITE_MAX_LEN // PAGE
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        gshape = f"B={GRANITE_SLOTS} NP={granite_np} H={gh} KV={gkv} Dh={gdh} {dname}"
        args = paged_case(GRANITE_SLOTS, gh, granite_np, dtype, 1560, kv=gkv, hd=gdh)
        want = paged_attn.paged_decode_attention_plain(*args)
        compare("paged_decode_attention", gshape, paged_attn.paged_decode_attention(*args), want,
                PAGED_TOL[dname])
        print(f"    plan {paged_attn.paged_decode_attention.last_plan}", flush=True)
        for k in time_kernels.PAGED_CTAS:
            plan = paged_attn.paged_plan(GRANITE_SLOTS, gh, gkv, gdh, granite_np, PAGE, args[0].element_size(),
                                         sms, ctas=k)
            compare("paged_decode_attention", f"{gshape} K={k}", paged_attn._attend(*args, plan), want,
                    PAGED_TOL[dname])
        del args, want

    # ---- 3f. grids past 65,535 systems or diagonal blocks (C8, C9) -------
    print(f"phase 3f: {C8_SYSTEMS} systems in one launch of B10 and B12 (C8), a band of "
          f"{-(-C9_ROWS // 32)} diagonal blocks through B8 (C9)", flush=True)

    def one_launch(wrapper, call):
        before = wrapper.launches
        got = call()
        torch.cuda.synchronize()
        return got, wrapper.launches - before

    g = torch.Generator(device=dev).manual_seed(1400)
    a = torch.rand((C8_SYSTEMS, 4, 4), generator=g, device=dev) * 2 - 1
    a.diagonal(dim1=-2, dim2=-1).copy_(a.abs().sum(dim=-1) + 1)
    lu, b = batched_lu.batched_lu_vmem(a), torch.randn((C8_SYSTEMS, 4), generator=g, device=dev)
    got, count = one_launch(batched_lu.batched_lu_solve_vmem, lambda: batched_lu.batched_lu_solve_vmem(lu, b))
    compare_bitwise("batched_lu_solve_vmem", f"B={C8_SYSTEMS} n=4 m=1", got,
                    batched_lu.batched_lu_solve_plain(lu, b))
    print(f"    {count} launch(es), plan {batched_lu.batched_lu_solve_vmem.last_plan}", flush=True)
    if count != 1:
        fail(f"batched_lu_solve_vmem B={C8_SYSTEMS}: {count} launches, not 1")
    a = torch.rand((C8_SYSTEMS, 8, 3), generator=g, device=dev) * 2 - 1  # tridiagonal bands, zero off the matrix
    a[:, 0, 0] = 0.0
    a[:, -1, 2] = 0.0
    a[:, :, 1] = a.abs().sum(dim=-1) + 1
    lu, b = banded.batched_banded_lu_vmem(a, bw=1), rhs_stack(C8_SYSTEMS, 8, 1, 1420)
    got, count = one_launch(banded.batched_banded_solve_vmem,
                            lambda: banded.batched_banded_solve_vmem(lu, b, bw=1))
    compare("batched_banded_solve_vmem", f"B={C8_SYSTEMS} n=8 bw=1 m=1", got, banded_solve_blocked(lu, b, bw=1),
            BATCHED_SOLVE_TOL)
    same = [s for s in (0, 65_534, 65_535, 65_536, C8_SYSTEMS - 1)
            if torch.equal(got[s], banded.banded_solve_kernelized(lu[s], b[s], bw=1))]
    print(f"    {count} launch(es), plan {banded.batched_banded_solve_vmem.last_plan}; systems {same} bitwise "
          "B7 on each alone", flush=True)
    if count != 2 or len(same) != 5:  # the solve and the non-finite pass
        fail(f"batched_banded_solve_vmem B={C8_SYSTEMS}: {count} launches (not 2), systems {same} bitwise B7")
    lu = banded.banded_lu_blocked(band(C9_ROWS, 1, 1430), bw=1)
    f9 = factorize_banded(lu, bw=1)
    b = rhs(C9_ROWS, 1, 1440)
    got, count = one_launch(banded.banded_solve_inverted,
                            lambda: banded.banded_solve_inverted(f9.linv, f9.uinv, f9.tlo, f9.tup, b, n=C9_ROWS,
                                                                 bw=1))
    want = banded.banded_solve_kernelized(lu, b, bw=1)
    torch.cuda.synchronize()
    rel = float((got.double() - want.double()).abs().max() / want.double().abs().max())
    print(f"  banded_solve_inverted n={C9_ROWS} bw=1 (S = {f9.linv.shape[0]}) against B7: rel {rel:.3e}, "
          f"{count} launches", flush=True)
    if not (bool(torch.isfinite(got).all()) and rel <= BATCHED_SOLVE_TOL and count == 6
            and f9.linv.shape[0] > 65_535):
        fail(f"banded_solve_inverted n={C9_ROWS}: rel {rel:.3e} against B7, {count} launches, "
             f"S = {f9.linv.shape[0]}")
    del a, lu, b, got, want, f9

    # ---- 3g. non-finite values (C10, C11) and any RHS width (C12) --------
    print("phase 3g: the factors and solves on non-finite values against their plain versions (C10, C11: "
          "NaN, inf and -inf positions equal, finite values normwise or bit for bit), B3 and B4 past a "
          "grid axis of column tiles (C12)", flush=True)

    def same_non_finite(name, shape, got, want, tol=KERNEL_TOL, bitwise=False):
        torch.cuda.synchronize()
        got, want = got.double(), want.double()
        same = all(bool(torch.equal(f(got), f(want))) for f in (torch.isnan, torch.isposinf, torch.isneginf))
        fin = torch.isfinite(want)
        bad = int((~fin).sum())
        gf, wf = got.masked_fill(~fin, 0), want.masked_fill(~fin, 0)
        err = float((gf - wf).abs().max()) / max(float(wf.abs().max()), 1e-30)
        ok = same and bad > 0 and (bool(torch.equal(gf, wf)) if bitwise else err <= tol)
        print(f"  {name:25s} {shape:34s} non-finite {bad:7d}  positions equal: {same}  finite rel {err:.2e}",
              flush=True)
        if not ok:
            fail(f"{name} {shape}: the non-finite pattern or the finite values differ from the plain version")

    def poisoned(t, where):
        t = t.clone()
        for idx, v in where:
            t[idx] = v
        return t

    inf, nan = float("inf"), float("nan")
    a40, a500 = matrix(40, 1600), matrix(500, 1601)
    for where in ([((2, 30), inf)], [((30, 2), inf)], [((20, 20), nan)]):
        a = poisoned(a40, where)
        same_non_finite("lu_fused", f"n=40 block=16 {where[0][0]}", ebv_lu.lu_fused(a, block=16),
                        ebv_lu.lu_fused_plain(a, block=16))
    a = poisoned(a500, [((7, 300), inf), ((400, 20), -inf)])
    same_non_finite("lu_fused", "n=500 (7, 300) inf, (400, 20) -inf", ebv_lu.lu_fused(a),
                    ebv_lu.lu_fused_plain(a))
    for bsz, n, where in ((3, 24, [((1, 2, 20), inf)]), (2, 384, [((1, 5, 300), -inf), ((0, 200, 100), nan)])):
        a = poisoned(stack(bsz, n, 1610 + n), where)
        same_non_finite("batched_lu_vmem", f"B={bsz} n={n}", batched_lu.batched_lu_vmem(a),
                        batched_lu.batched_lu_plain(a), bitwise=True)
    for n, m, lu_at, b_at in ((40, 3, [(5, 30)], []), (40, 3, [], [(39, 1)]), (2000, 64, [(100, 1500)], [])):
        lu = poisoned(ebv_lu.lu_fused(matrix(n, 1620 + n)), [(idx, nan) for idx in lu_at])
        b = poisoned(rhs(n, m, 1630 + n), [(idx, inf) for idx in b_at])
        shape = f"n={n} m={m} " + ("lu nan" if lu_at else "b inf")
        same_non_finite("solve_vmem", shape, trsm.solve_vmem(lu, b), trsm.solve_vmem_plain(lu, b))
        blk = 16 if n == 40 else 256
        same_non_finite("solve_tiled", f"{shape} block={blk}", trsm.solve_tiled(lu, b, block=blk),
                        trsm.solve_tiled_plain(lu, b, block=blk))
        stack_lu, stack_b = torch.stack([lu, lu]), torch.stack([b, rhs(n, m, 1640 + n).reshape(b.shape)])
        same_non_finite("batched_lu_solve_vmem", f"B=2 {shape}", batched_lu.batched_lu_solve_vmem(stack_lu, stack_b),
                        batched_lu.batched_lu_solve_plain(stack_lu, stack_b), bitwise=True)
    for n, bw, m, at in ((97, 5, 2, (10, 6)), (16000, 5, 1, (5000, 7))):
        clean = banded.banded_lu_blocked(band(n, bw, 1650 + n), bw=bw)
        lu = poisoned(clean, [(at, inf)])
        b = rhs(n, m, 1660 + n)
        shape = f"n={n} bw={bw} m={m} lu{at} inf"
        same_non_finite("banded_solve_kernelized", shape, banded.banded_solve_kernelized(lu, b, bw=bw),
                        banded_solve_blocked(lu, b, bw=bw))
        stack_lu, stack_b = torch.stack([lu, clean]), torch.stack([b, b])
        same_non_finite("batched_banded_solve_vmem", f"B=2 {shape}",
                        banded.batched_banded_solve_vmem(stack_lu, stack_b, bw=bw),
                        banded_solve_blocked(stack_lu, stack_b, bw=bw), BATCHED_SOLVE_TOL)
    del a, lu, b, stack_lu, stack_b, clean
    n, m = WIDE_RHS
    lu = ebv_lu.lu_fused(matrix(n, 1670))
    linv, uinv = dense_block_inverses(lu, block=32)
    b = torch.randn((n, m), generator=torch.Generator(device=dev).manual_seed(1671), device=dev)
    for name, call, plain in (
            ("solve_tiled", lambda: trsm.solve_tiled(lu, b), lambda: trsm.solve_tiled_plain(lu, b)),
            ("solve_inverted", lambda: trsm.solve_inverted(lu, linv, uinv, b),
             lambda: dense_inverted_solve(lu, linv, uinv, b))):
        got, count = one_launch(getattr(trsm, name), call)
        compare(name, f"n={n} m={m}", got, plain(), BATCHED_SOLVE_TOL)
        grid = getattr(trsm, name).last_grid
        print(f"    {count} launches, one grid axis of {grid} blocks at most", flush=True)
        if not grid > 65_535:
            fail(f"{name} n={n} m={m}: its largest step grid is {grid} blocks, not past 65,535")
        del got
    del lu, linv, uinv, b

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
    # the C drivers report what they launched: 4S-4 per factor, one step per
    # launch of solve_tiled (2S), two of solve_inverted (4S-2), and the
    # non-finite pass after the factor, solve_vmem and solve_tiled
    expected = {"lu_fused": sum(ebv_lu.fused_launches(n) for n, _, _, _ in cases) + ebv_lu.fused_launches(8000),
                "solve_vmem": sum(2 for n, _, _, _ in cases if n <= 2048),
                "solve_tiled": sum(trsm.tiled_launches(n) for n, _, _, _ in cases if n > 2048),
                "solve_inverted": trsm.inverted_launches(8000, f.linv.shape[1])}
    if launches != expected:
        fail(f"launch counters {launches}, expected {expected}")
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
              + [(pn, POISSON_NX, 1, apoisson), (*PAST_CLUSTERS, 1, band(*PAST_CLUSTERS, 450))])
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
            expected["banded_solve_kernelized"] += 2  # the solve and the non-finite pass
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
    calls = 2 * len(dcases)  # the factor with its non-finite pass, two launches a call
    batched_launches = read(dwrappers, {"batched_lu_vmem": 2 * calls, "batched_lu_solve_vmem": calls},
                            "batched dense path")
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
    # the optimizer's workload stands for the model: the trainer's leaves of
    # configs/whisper_tiny.py, name, shape, dtype and order
    model_tree = list(lm._train_shapes(get_config(WHISPER_ARCH)).items())
    hand_tree = [(k, (tuple(p.shape), p.dtype)) for k, p in trees["whisper-tiny"].items()]
    print(f"  whisper-tiny tree against lm._train_shapes: equal {hand_tree == model_tree}", flush=True)
    if hand_tree != model_tree:
        fail(f"the hand-built whisper-tiny tree {hand_tree} is not the model's {model_tree}")
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
    opt_launches = read(dwrappers, {"batched_lu_vmem": 6 * OPT_STEPS, "batched_lu_solve_vmem": 3 * OPT_STEPS},
                        "optimizer path")
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
    zero(ewrappers)
    eresults = []
    with solvers.record_dispatches() as log:
        for bsz, n, bw, a, b in ecases:
            mark = len(log)
            x = ops.banded_linear_solve(a, b, bw=bw)
            eresults.append((f"banded_linear_solve B={bsz} n={n} bw={bw} m=1", a, b, x, bw,
                             [nm for _, nm in log[mark:]]))
    ens_launches = read(ewrappers, {"batched_banded_lu_vmem": len(ecases),
                                    "batched_banded_solve_vmem": 2 * len(ecases)}, "batched banded path")
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

    print("phase 4f: the legacy forced factors", flush=True)
    lwrappers = {"lu_vmem": ebv_lu.lu_vmem, "panel": ebv_lu.panel, "fused_step": ebv_lu.fused_step}
    fcases = ([("cuda_vmem", n, matrix(n, 1500 + n), rhs(n, 1, 1550 + n)) for n in VMEM_SIZES]
              + [("cuda_blocked", n, matrix(n, 1600 + n), rhs(n, 1, 1650 + n)) for n in BLOCKED_SIZES])
    zero(lwrappers)
    fresults = []
    with solvers.record_dispatches() as log:
        for impl, n, a, b in fcases:
            mark = len(log)
            x = ops.linear_solve(a, b, impl=impl)
            fresults.append((f"linear_solve(impl={impl}) n={n}", a, b, x, [nm for _, nm in log[mark:]],
                             [impl, "cuda_vmem" if n <= 2048 else "cuda_tiled"]))
    legacy_expected = {"lu_vmem": len(VMEM_SIZES),
                       "panel": sum(-(-n // LEGACY_BLOCK) for n in BLOCKED_SIZES),
                       "fused_step": sum(blocked_launches(n) - (-(-n // LEGACY_BLOCK)) for n in BLOCKED_SIZES)}
    legacy_launches = read(lwrappers, legacy_expected, "legacy forced path (one cooperative launch per "
                           "lu_vmem; S panels and S-1 fused steps of two launches per cuda_blocked)")
    check_results(fresults)
    _, n, a, b = fcases[0]
    want = ref.solve_ref(ref.lu_ref(a.double().cpu().numpy()), b.double().cpu().numpy())
    err = float(np.abs(fresults[0][3].double().cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  cuda_vmem n={n} against the float64 oracle (kernels/ref.py): normwise {err:.3e}", flush=True)
    if not err <= 1e-5:
        fail(f"cuda_vmem n={n} answer off the float64 oracle by {err:.3e}")
    # the exported trailing update, which no op of the reference calls: the
    # driver's first step's A22 - L21 U12 (n = 2000, phase 3d) done apart,
    # against the fused step's own
    uwrappers = {"update": ebv_lu.update}
    zero(uwrappers)
    upd = ebv_lu.update(pan[LEGACY_BLOCK:], u12, trail, row_tile=trail.shape[0], col_tile=128)
    update_launches = read(uwrappers, {"update": 1}, "exported update path")
    err = float((upd.double() - new_trail.double()).abs().max() / new_trail.double().abs().max())
    print(f"  update(L21, U12, A22) of the driver's first step against the fused step's A22: "
          f"normwise {err:.3e}", flush=True)
    if not err <= LEGACY_TOL:
        fail(f"update disagrees with the fused step's trailing update ({err:.3e})")

    print("phase 4g: the accuracy tiers", flush=True)
    twrappers = {"lu_fused": ebv_lu.lu_fused, "solve_inverted": trsm.solve_inverted}
    a_ir, b_ir = matrix(IR_N, 1700), rhs(IR_N, 1, 1701)
    g = torch.Generator(device=dev).manual_seed(1702)
    a_rank = (torch.randn((RANK_N, RANK_K), generator=g, device=dev)
              @ torch.randn((RANK_K, RANK_N), generator=g, device=dev)) / RANK_K
    b_rank = a_rank @ torch.randn(RANK_N, generator=g, device=dev)
    zero(twrappers)
    with solvers.record_dispatches() as log:
        t0 = time.perf_counter()
        x_ir = ops.linear_solve(a_ir, b_ir, tolerance=IR_TOL)
        torch.cuda.synchronize()
        ir_ms = (time.perf_counter() - t0) * 1e3
        sweeps = refine.last_refinement()
        ir_launches = {k: w.launches for k, w in twrappers.items()}
        mark = len(log)
        x_rank = ops.linear_solve(a_rank, b_rank, rank=RANK_K, tolerance=RAND_LU_RESIDUAL_BOUND)
        torch.cuda.synchronize()
    tier_launches = {k: w.launches for k, w in twrappers.items()}
    ir_names, rank_names = [nm for _, nm in log[:mark]], [nm for _, nm in log[mark:]]
    res_ir = float(relative_residual(a_ir, b_ir, x_ir))
    res_rank = float(relative_residual(a_rank, b_rank, x_rank))
    rank_launches = {k: tier_launches[k] - ir_launches[k] for k in twrappers}
    print(f"  linear_solve(tolerance={IR_TOL:g}) n={IR_N}: dispatch {ir_names}  residual {res_ir:.3e}  "
          f"refinement sweeps {sweeps['iterations']}  {ir_ms:.1f} ms (host clock)  kernel launches "
          f"{ir_launches}", flush=True)
    print(f"  linear_solve(rank={RANK_K}, tolerance={RAND_LU_RESIDUAL_BOUND:g}) n={RANK_N} (rank-{RANK_K} "
          f"operand): dispatch {rank_names}  residual {res_rank:.3e}  launches {rank_launches}", flush=True)
    if ir_names != ["bf16_ir"] or not res_ir <= IR_TOL or min(ir_launches.values()) < 1:
        fail(f"bf16_ir tier: dispatch {ir_names}, residual {res_ir:.3e}, launches {ir_launches}")
    if rank_names != ["rand_lu"] or not res_rank <= RAND_LU_RESIDUAL_BOUND or rank_launches["lu_fused"] < 1:
        fail(f"rand_lu tier: dispatch {rank_names}, residual {res_rank:.3e}, launches {rank_launches}")
    tree = {k: torch.nn.Parameter(v) for k, v in whisper_tiny_tree(gen).items()}
    topt = train.EbvPreconditioned(list(tree.values()), lr=train.warmup_cosine(3e-4, 2, OPT_STEPS),
                                   solve_tolerance="auto")
    draw_grads(tree, gen)
    start_t = {k: p.detach().clone() for k, p in tree.items()}
    solves.clear()
    ops.linear_solve = recording(plain_ls)
    zero(dwrappers)
    try:
        with solvers.record_dispatches() as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            topt.step()
            torch.cuda.synchronize()
            tier_step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops.linear_solve = plain_ls
    tier_opt_launches = {k: w.launches for k, w in dwrappers.items()}
    got = [(p.op, p.n, p.batch, p.rhs, nm) for p, nm in log]
    print(f"  whisper-tiny EbvPreconditioned(solve_tolerance='auto' = {topt.solve_tolerance:g}) step: "
          f"dispatch {got}  {tier_step_ms:.1f} ms (host clock)  launches {tier_opt_launches}", flush=True)
    if got != [("linear_solve", L, 5, d, "bf16_ir"), ("linear_solve", d, 2, vocab, "bf16_ir")] \
            or min(tier_opt_launches.values()) < 2:
        fail(f"the tiered optimizer step dispatched {got}, launches {tier_opt_launches}")
    for a3, r3, x3 in solves:
        res = float(relative_residual(a3, r3, x3))
        print(f"  tiered preconditioner solve {tuple(r3.shape)}: worst system's residual {res:.3e}", flush=True)
        if not bool(torch.isfinite(x3).all()) or not res <= topt.solve_tolerance:
            fail(f"tiered preconditioner solve {tuple(r3.shape)}: residual {res:.3e}")
    for k, p in tree.items():
        if not bool(torch.isfinite(p).all()) or torch.equal(p.detach(), start_t[k]):
            fail(f"tiered optimizer {k}: not finite or not updated")
    del tree, topt, start_t
    solves.clear()

    print("phase 4h: the solve service", flush=True)
    serve_mats = {("dense", n): matrix(n, 1800 + n) for n in SERVE_DENSE}
    serve_mats[("band", SERVE_BAND[0])] = band(*SERVE_BAND, 1850)
    nan_mat = matrix(1024, 1860)
    nan_mat[0, 0] = float("nan")
    zero_mat = matrix(1024, 1861)
    zero_mat[0, 0] = 0.0
    nan_band = band(*SERVE_BAND, 1862)
    nan_band[5, SERVE_BAND[1]] = float("nan")

    def serve_requests(flush):
        out = []
        for (kind, n), a in serve_mats.items():
            for i in range(SERVE_REQS):
                out.append((a, rhs(n, 1 if i % 2 == 0 else 4, 1900 + 97 * flush + 7 * i + n),
                            SERVE_BAND[1] if kind == "band" else 0, {}))
        return out

    def extras():
        a4 = serve_mats[("dense", 4096)]
        return [(a4, rhs(4096, 1, 1990), 0, dict(tolerance=1e-5)),
                (a_rank, b_rank, 0, dict(rank=RANK_K, tolerance=RAND_LU_RESIDUAL_BOUND))]

    hostile = [(nan_mat, rhs(1024, 1, 1991), 0, {}), (zero_mat, rhs(1024, 1, 1992), 0, {}),
               (nan_band, rhs(SERVE_BAND[0], 1, 1993), SERVE_BAND[1], {})]
    qwrappers = {"banded_lu_kernelized": banded.banded_lu_kernelized}  # reached through escalation
    swrappers = {**wrappers, "banded_lu_blocked": banded.banded_lu_blocked,
                 "banded_solve_kernelized": banded.banded_solve_kernelized, **lwrappers, **qwrappers}
    svc, undisturbed = SolveService(), SolveService()
    zero(swrappers)
    flush_rows, flush_out = [], []
    with solvers.record_escalations() as esc:
        for flush in range(SERVE_FLUSHES):
            reqs = serve_requests(flush)
            if flush == 1:
                reqs = reqs + extras() + hostile
            before = dataclasses.replace(svc.stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tickets = [svc.submit(a, b, bw=bw, **kw) for a, b, bw, kw in reqs]
            out = svc.flush()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            st = svc.stats
            row = dict(requests=len(reqs), ms=ms, rps=len(reqs) / ms * 1e3,
                       factor=st.factor_dispatches - before.factor_dispatches,
                       solve=st.solve_dispatches - before.solve_dispatches,
                       hits=st.cache_hits - before.cache_hits, misses=st.cache_misses - before.cache_misses)
            flush_rows.append(row)
            flush_out.append((reqs, tickets, out))
            print(f"  flush {flush + 1}: {row['requests']} requests in {ms:.1f} ms = {row['rps']:.1f} requests/s; "
                  f"factor dispatches {row['factor']}, solve dispatches {row['solve']}, hits {row['hits']}, "
                  f"misses {row['misses']}", flush=True)
    serve_launches = {k: w.launches for k, w in swrappers.items()}
    torch.cuda.synchronize()
    print(f"  launches on the service path: {serve_launches}", flush=True)
    print(f"  stats: {dataclasses.asdict(svc.stats)}  hit rate {svc.stats.hit_rate:.3f}", flush=True)
    groups = len(serve_mats)
    if flush_rows[0]["factor"] != groups or flush_rows[0]["solve"] != groups:
        fail(f"cold flush: {flush_rows[0]}, expected {groups} factor and {groups} solve dispatches")
    for row in flush_rows[2:]:
        if row["factor"] != 0 or row["solve"] != groups:
            fail(f"warm flush: {row}, expected no factor and {groups} solve dispatches")
    for k in ("lu_fused", "solve_vmem", "solve_tiled", "banded_lu_blocked", "banded_solve_kernelized",
              "lu_vmem", "panel", "fused_step", "banded_lu_kernelized"):
        if serve_launches[k] < 1:
            fail(f"the service path launched no {k}")
    reqs, tickets, out = flush_out[1]
    nan_ticket, zero_ticket, nan_band_ticket = tickets[-3:]
    failure = out[nan_ticket]
    chain = [c["backend"] for c in getattr(failure, "chain", [])]
    print(f"  NaN-poisoned n=1024: {type(failure).__name__} chain {chain}; quarantined "
          f"{fingerprint(nan_mat) in svc.quarantined_fingerprints()}", flush=True)
    if not isinstance(failure, solvers.SolveFailure) \
            or chain != ["cuda_fused", "torch", "cuda_vmem", "pivoted", "cuda_blocked"] \
            or fingerprint(nan_mat) not in svc.quarantined_fingerprints():
        fail(f"the NaN-poisoned matrix: {failure!r}")
    band_failure = out[nan_band_ticket]
    band_chain = [c["backend"] for c in getattr(band_failure, "chain", [])]
    band_quarantined = fingerprint(nan_band, bw=SERVE_BAND[1]) in svc.quarantined_fingerprints()
    print(f"  NaN-poisoned band n={SERVE_BAND[0]} bw={SERVE_BAND[1]}: {type(band_failure).__name__} "
          f"chain {band_chain}; quarantined {band_quarantined}", flush=True)
    if not isinstance(band_failure, solvers.SolveFailure) or not band_quarantined \
            or band_chain != ["cuda_blocked", "cuda_tiled", "torch", "cuda_scalar", "torch_scalar"]:
        fail(f"the NaN-poisoned band: {band_failure!r}")
    zero_chain = [(e[1], e[2]) for e in esc if e[0].op == "factor" and e[0].n == 1024][-3:]
    zero_factors = svc._lru[fingerprint(zero_mat)][0.0]
    print(f"  zero-pivot n=1024: escalations {zero_chain}, served by "
          f"{type(zero_factors).__name__}", flush=True)
    if zero_chain != [("cuda_fused", "torch"), ("torch", "cuda_vmem"), ("cuda_vmem", "pivoted")] \
            or not isinstance(zero_factors, PivotedFactors):
        fail(f"the zero-pivot matrix: escalations {zero_chain}, factors {type(zero_factors).__name__}")
    rank_tiers = sorted(svc._lru[fingerprint(a_rank)])
    print(f"  rank-{RANK_K} request: cached tiers {rank_tiers}, refinement sweeps "
          f"{svc.stats.last_refine_iterations}", flush=True)
    if rank_tiers != [RAND_LU_RESIDUAL_BOUND]:
        fail(f"rank-k factors cached at tiers {rank_tiers}")
    worst, worst_coalesced = 0.0, 0.0
    fps = {}  # the fingerprint of each matrix, taken once
    for reqs, tickets, out in flush_out:
        for (a, b, bw, kw), tk in zip(reqs, tickets):
            if tk in (nan_ticket, nan_band_ticket):
                continue
            x = out[tk]
            # an exact answer is held to 1e-4, a tier's to its tolerance
            bound = kw.get("tolerance") or solvers.VERIFY_RESIDUAL_DEFAULT_BOUND
            res = float(relative_residual(a, b, x, bw=bw))
            worst = max(worst, res)
            if x.shape != b.shape or not res <= bound:
                fail(f"service answer n={a.shape[0]} bw={bw} {kw}: residual {res:.3e} > {bound:g}")
            if "rank" in kw:
                continue
            if id(a) not in fps:
                fps[id(a)] = fingerprint(a, bw=bw)
            factors = svc._lru[fps[id(a)]][0.0]
            one = ops.banded_solve(factors, b, bw=bw) if bw else ops.lu_solve(factors, b)
            err = float((x.double() - one.double()).abs().max() / one.double().abs().max())
            worst_coalesced = max(worst_coalesced, err)
            if not err <= 1e-5:
                fail(f"coalesced answer n={a.shape[0]} bw={bw}: {err:.3e} from the per-request solve")
    print(f"  every answer within its bound (worst residual {worst:.3e}); coalesced against per-request "
          f"solves: worst normwise {worst_coalesced:.3e} (<= 1e-5)", flush=True)
    solvers.clear_demotions()
    for flush in range(2):  # the undisturbed service: flushes 1 and 2 without the hostile matrices
        reqs, tickets, out = flush_out[flush]
        calm = [r for r in reqs if not any(r[0] is h[0] for h in hostile)]
        uticks = [undisturbed.submit(a, b, bw=bw, **kw) for a, b, bw, kw in calm]
        uout = undisturbed.flush()
    same = all(torch.equal(out[tk], uout[ut]) for tk, ut in zip(tickets, uticks))
    print(f"  flush 2's flush-mates bitwise equal to an undisturbed service: {same}", flush=True)
    if not same:
        fail("a hostile matrix disturbed its flush-mates")
    a4 = serve_mats[("dense", 4096)]
    fp_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fingerprint(a4)
        fp_ms.append((time.perf_counter() - t0) * 1e3)
    fp_ms = statistics.median(fp_ms)
    print(f"  fingerprint of the n=4096 card matrix (64 MiB to the host + sha1), host clock, median of 3: "
          f"{fp_ms:.1f} ms; flush 3: {flush_rows[2]['ms']:.1f} ms for {flush_rows[2]['requests']} requests "
          f"(card: {card})", flush=True)
    for k in lwrappers:
        legacy_launches[k] += serve_launches[k]

    print(f"phase 4i: the serving path, {LM_ARCH} at full width", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(0), mcfg)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"  {mcfg.name}: {mcfg.num_layers} layers, d={mcfg.d_model}, {mcfg.num_heads} heads, {kvh} KV "
          f"heads, Dh={dh}, d_ff={mcfg.d_ff}, vocab {mcfg.vocab_size}, {mcfg.dtype}: "
          f"{nparams / 1e9:.3f} G parameters, {wbytes / 1e9:.2f} GB, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(1600)
    shared = rng.integers(0, mcfg.vocab_size, SHARED_PREFIX)
    prompts = [rng.integers(0, mcfg.vocab_size, n).astype(np.int32) for n in rng.integers(64, 513, LM_REQS)]
    for i in (1, 5):  # two requests share a 256-token prefix (and a bucket: 320 tokens each)
        prompts[i] = np.concatenate([shared, rng.integers(0, mcfg.vocab_size, 64)]).astype(np.int32)
    news = [int(n) for n in rng.integers(32, 65, LM_REQS)]
    eos_rid = 3
    # the EOS request stops at its third greedy token, read from a short serve
    probe = Engine(model, mcfg, max_len=LM_MAX_LEN, slots=1, bucket=LM_BUCKET)
    eos_tok = int(probe.serve([GenRequest(prompts[eos_rid], 4)])[0][len(prompts[eos_rid]) + 2])
    lm_reqs = [GenRequest(p, n, eos_token=eos_tok if i == eos_rid else None)
               for i, (p, n) in enumerate(zip(prompts, news))]
    pwrappers = {"paged_decode_attention": paged_attn.paged_decode_attention}
    served, engines, lm_launches = {}, {}, {}
    for paged in (False, True):
        label = "paged" if paged else "dense"
        eng = Engine(model, mcfg, max_len=LM_MAX_LEN, slots=LM_SLOTS, bucket=LM_BUCKET,
                     **(dict(paged=True, page_size=PAGE) if paged else {}))
        zero(pwrappers)
        t0 = time.perf_counter()
        served[label] = eng.serve(lm_reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lm_launches[label] = paged_attn.paged_decode_attention.launches
        engines[label] = eng
        st = eng.stats
        line = (f"  {label}: {len(lm_reqs)} requests, {st.generated_tokens} new tokens in {dt * 1e3:.1f} ms "
                f"(host clock) = {len(lm_reqs) / dt:.2f} requests/s, {st.generated_tokens / dt:.1f} tokens/s; "
                f"{st.prefill_dispatches} prefill + {st.decode_dispatches} decode dispatches, "
                f"{dt * 1e3 / st.decode_dispatches:.2f} ms per decode step with the prefills; "
                f"B13 launches {lm_launches[label]}; early exits {st.early_exits}")
        if paged:
            line += (f"; prefix hits {st.prefix_hits} ({st.prefix_hit_tokens} tokens); pool peak "
                     f"{st.pool_peak_pages}/{eng.pool.capacity} pages of {PAGE}")
        print(line + f" (card: {card})", flush=True)
    pst = engines["paged"].stats
    if lm_launches["dense"] != 0 or lm_launches["paged"] != mcfg.num_layers * pst.decode_dispatches:
        fail(f"B13 launches {lm_launches}: expected none dense and {mcfg.num_layers} per paged decode step")
    if pst.prefix_hits < 1:
        fail("the paged serve made no warm admission")
    # a warm admission prefills the suffix alone, so its first token comes
    # from another prefill; every other first token comes from the same one
    order = [rid for kind, rid in pst.events if kind == "prefill"]
    warm_rid = max((1, 5), key=order.index)
    agree = total = 0
    for i, (a, b) in enumerate(zip(served["dense"], served["paged"])):
        s0 = len(prompts[i])
        if len(a) < s0 + 1 or len(b) < s0 + 1 or (a[s0] != b[s0] and i != warm_rid):
            fail(f"request {i}: first tokens {a[s0:s0 + 1]} (dense) and {b[s0:s0 + 1]} (paged)")
        n = min(len(a), len(b)) - s0
        agree += int((a[s0:s0 + n] == b[s0:s0 + n]).sum())
        total += max(len(a), len(b)) - s0
        if not (np.array_equal(a[:s0], prompts[i]) and np.array_equal(b[:s0], prompts[i])):
            fail(f"request {i}: the prompt does not lead the output")
    print(f"  first tokens equal (the warm request {warm_rid}: "
          f"{served['dense'][warm_rid][len(prompts[warm_rid])] == served['paged'][warm_rid][len(prompts[warm_rid])]}); "
          f"served tokens that agree: {agree}/{total} = {agree / total:.3f}", flush=True)

    # the paged decode step against the dense one, teacher-forced on the dense
    # engine's tokens over 8 steps, from the same prefills
    tf_rows = [i for i in range(LM_REQS) if i != eos_rid][:LM_SLOTS]
    nrow, L = len(tf_rows), mcfg.num_layers
    dcache = lm.init_caches(mcfg, nrow, LM_MAX_LEN)
    pcache = lm.init_paged_caches(mcfg, nrow, nrow * served_np + 1, PAGE)
    table = (1 + torch.arange(nrow * served_np, device=dev, dtype=torch.int32)).reshape(nrow, served_np)
    for r, i in enumerate(tf_rows):
        s0 = len(prompts[i])
        lb = bucket_length(s0, LM_BUCKET)
        toks = np.zeros((1, lb), np.int32)
        toks[0, :s0] = prompts[i]
        raw, _ = lm.prefill(model, {"tokens": toks}, mcfg, last=[s0 - 1], raw_kv=True)
        npg = -(-lb // PAGE)
        for key in ("k", "v"):
            fresh = raw["attn"][key][:, 0]  # (L, lb, KV, Dh)
            dcache["attn"][key][:, r, :lb] = fresh
            pages = torch.nn.functional.pad(fresh, (0, 0, 0, 0, 0, npg * PAGE - lb))
            pcache["attn"][f"{key}_pages"][:, table[r, :npg].long()] = pages.reshape(L, npg, PAGE, kvh, dh)
        dcache["attn"]["pos"][:, r] = torch.where(torch.arange(LM_MAX_LEN, device=dev) < s0,
                                                  torch.arange(LM_MAX_LEN, device=dev), -1).to(torch.int32)
    pos = torch.tensor([len(prompts[i]) for i in tf_rows], dtype=torch.int32, device=dev)
    worst_logits = 0.0
    for t in range(TEACHER_STEPS):
        tok = torch.tensor([[int(served["dense"][i][len(prompts[i]) + t])] for i in tf_rows], device=dev)
        _, dl = lm.decode_step(model, dcache, tok, pos, mcfg)
        _, pl = lm.decode_step(model, pcache, tok, pos, mcfg, page_table=table)
        if not bool(torch.isfinite(pl).all()) or pl.shape != dl.shape:
            fail(f"paged logits at step {t}: shape {tuple(pl.shape)} or non-finite")
        worst_logits = max(worst_logits, float((pl - dl).abs().max() / dl.abs().max()))
        if t < TEACHER_STEPS - 1:
            pos += 1
    print(f"  teacher-forced over {TEACHER_STEPS} steps, {nrow} rows: paged against dense logits, worst "
          f"normwise {worst_logits:.3e} (tolerance {LOGITS_TOL:.0e})", flush=True)
    if not worst_logits <= LOGITS_TOL:
        fail(f"paged decode logits {worst_logits:.3e} from the dense ones")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH, "--paged", "--batch", "4",
           "--new-tokens", "16"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                          capture_output=True, text=True, timeout=600)
    print(f"  python -m repro_torch.launch.serve --arch {LM_ARCH} --paged --batch 4 --new-tokens 16: exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.1f} s (process start and weight draw included)",
          flush=True)
    for out_line in proc.stdout.strip().splitlines():
        print(f"    {out_line}", flush=True)
    if proc.returncode or "served 4 requests (64 new tokens)" not in proc.stdout:
        fail(f"the serving launcher: {proc.stderr.strip()[-2000:]}")

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
        """:func:`device_ops` of one call of ``fn``, after a warm-up call."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = device_ops(prof)
        if not rows:
            print("    the profiler saw no device time: not measured", flush=True)
        return rows

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    rows = {}

    def walk_rate(name, shape, pivots, plan):
        """A walk's time per pivot beside its library call's and its bound's."""
        row = rows[(name, shape)]
        lib = row["library_ms"]
        share = f", resident share {plan.resident:.3f} (theta {plan.theta})" if plan is not None else ""
        print(f"    {name} {shape}: {1e3 * row['ms'] / pivots:.3f} us a pivot over {pivots} pivots "
              f"({row['ms']:.4f} ms; library {'not measured' if lib is None else f'{lib:.4f}'} ms; bound "
              f"{row['bound_ms']:.4g} ms){share}", flush=True)

    def record(name, shape, ms, plain_ms, lib_ms, flops, nbytes, per_call):
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        b_ms, b_by = bound(flops, nbytes)
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
        print(f"  {name:15s} {shape:12s} kernel {ms:.4f}  plain {fmt(plain_ms)}  library {fmt(lib_ms)}  "
              f"bound {b_ms:.4g} ({b_by})  launches/call {per_call}  peak {peak:.0f} MiB", flush=True)
        rows[(name, shape)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                   bound_by=b_by, per_call=per_call)
        torch.cuda.reset_peak_memory_stats()

    def vmem_links(n, m, ms=None):
        """B2's plan and its time a link: 2P handoffs of one row block."""
        plan = trsm.solve_vmem_plan(n, m, sms)
        ms = rows[("solve_vmem", f"n={n} m={m}")]["ms"] if ms is None else ms
        print(f"    solve_vmem n={n} m={m}: P = {plan.blocks} blocks of R = {plan.rows} rows, resident share "
              f"{plan.resident:.3f}; {1e3 * ms / (2 * plan.blocks):.2f} us a link over {2 * plan.blocks} links "
              f"(card: {card})", flush=True)

    def solve_strip_rate(bsz, n, m, ms):
        """B10's plan and its time a strip: both paths walk 2S strips, a
        cluster's in waves of as many clusters as the card holds at once
        (a link: a strip's triangle and its handoff), a wide grid's blocks
        side by side (the time a strip of the whole grid)."""
        plan = batched_lu.batched_solve_plan(bsz, n, m, sms, solve_room)
        strips = 2 * -(-n // 32)
        waves = 1
        if plan.path == "cluster":
            clusters = bsz * -(-m // plan.cols)
            waves = -(-clusters // max(1, solve_room[plan.ctas]))
            what = f"{plan.ctas} CTAs a cluster, {clusters} clusters in {waves} wave(s)"
        else:
            what = f"{plan.cols} columns a block, {bsz * -(-m // plan.cols)} blocks"
        print(f"    batched_lu_solve_vmem B={bsz} n={n} m={m}: {plan.path} ({what}); "
              f"{1e3 * ms / (strips * waves):.2f} us a strip over {strips} strips (card: {card})",
              flush=True)

    def per_call(wrapper, fn):
        """Launches one call of ``fn`` adds to ``wrapper``'s counter."""
        before = wrapper.launches
        fn()
        return wrapper.launches - before

    torch.cuda.reset_peak_memory_stats()
    for n in SIZES:
        a = matrix(n, n)
        plain = timed(lambda: ebv_lu.lu_fused_plain(a)) if n <= 2000 else plain8_ms  # n = 8000: phase 3's call
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
                vmem_links(n, m)
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
        plain = (timed(lambda: banded.banded_lu_plain(a, bw=bw)) if (n, bw) not in ((pn, POISSON_NX), PAST_CLUSTERS)
                 else plain_once[f"n={n} bw={bw}"])  # one call, in phase 3
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
        plain = (timed(lambda: banded_solve_blocked(lu, b, bw=bw)) if (n, bw) not in ((pn, POISSON_NX), PAST_CLUSTERS)
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
        walk_rate("batched_lu_vmem", f"B={bsz} n={n}", n - 1,
                  batched_lu.batched_lu_plan(bsz, n, sms, room).walk)
    for (bsz, n), lu in blus.items():
        piv = torch.arange(1, n + 1, dtype=torch.int32, device=dev).expand(bsz, n).contiguous()
        for m in GROUP_RHS.get((bsz, n), (1, n)):
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
            solve_strip_rate(bsz, n, m, rows[("batched_lu_solve_vmem", f"B={bsz} n={n} m={m}")]["ms"])
    print(f"  batched_lu_solve_vmem on each path and cluster size beside batched lu_solve (ms, one call / "
          f"{BACK_TO_BACK} back to back; card: {card}):", flush=True)
    for bsz, n, m in SOLVE_SPLIT:
        lu = split_lus[(bsz, n)]
        time_kernels.batched_solve_sweep(lu, rhs_stack(bsz, n, m, 1320 + m))
    a = bstacks[BATCHED_DENSE[-1]]
    slot = solvers.get_backend("factor", "batched_dense", "torch")
    _, slot_ms = once(lambda: slot.call(solvers.Problem.from_arrays("factor", a), a))
    print(f"  the reference's slot past its cap, the plain fused_blocked_lu per system "
          f"(torch slot), B={a.shape[0]} n={a.shape[1]}, one call: {slot_ms:.1f} ms", flush=True)
    def beside_parent(name, shape):
        """The walk's time beside the parent tree's (WALK_PARENT_MS)."""
        ms, before = rows[(name, shape)]["ms"], WALK_PARENT_MS.get(f"{name} {shape}")
        parent = "not measured" if before is None else f"{before:.4f} ms, {before / ms:.2f}x this"
        print(f"    {name} {shape} on the {getattr(banded, name).last_path}: {ms:.4f} ms; the parent's ring "
              f"walk: {parent}", flush=True)

    for (bsz, n, bw), a in ensembles.items():
        shape = f"B={bsz} n={n} bw={bw}"
        kernel = lambda: banded.batched_banded_lu_vmem(a, bw=bw)
        record("batched_banded_lu_vmem", shape, timed(kernel), eplain_ms[shape], None,
               bsz * n * (2 * bw * bw + bw), 2 * bsz * n * (2 * bw + 1) * 4,
               per_call(banded.batched_banded_lu_vmem, kernel))
        beside_parent("batched_banded_lu_vmem", shape)
        lu, b = eplain[(bsz, n, bw)], rhs_stack(bsz, n, 1, 990 + n)
        kernel = lambda: banded.batched_banded_solve_vmem(lu, b, bw=bw)
        record("batched_banded_solve_vmem", shape + " m=1", timed(kernel), eplain_ms[shape + " m=1"],
               None, bsz * 4 * n * bw, bsz * (n * (2 * bw + 1) + 2 * n) * 4,
               per_call(banded.batched_banded_solve_vmem, kernel))
        # the parent's B12: band_solve_kernel, a warp a system, launched as the
        # parent launched it (its grid's system axis now folded into x)
        ms, report = rows[("batched_banded_solve_vmem", shape + " m=1")]["ms"], banded.batched_banded_solve_vmem.last_plan
        warp = banded.BandSolvePlan("warp", 1, 1, 0, 0)
        parent = timed(lambda: banded.batched_banded_solve_vmem(lu, b, bw=bw, plan=warp))
        strips = 2 * -(-n // 32)
        print(f"    batched_banded_solve_vmem {shape} m=1 on B7's staged kernel (plan {report}): {ms:.4f} ms, "
              f"{1e3 * ms / strips:.3f} us a strip; the parent's per-warp kernel, same call: {parent:.4f} ms, "
              f"{parent / ms:.2f}x this (card: {card})", flush=True)
    # the legacy kernels; library: lu_factor(pivot=False) for B17 and, on the
    # (m, b) panel, for B16; two calls (solve_triangular + addmm) for B15;
    # addmm for B14
    print("  legacy: library lu_factor(pivot=False) (B17, B16 on the panel), solve_triangular + addmm "
          "(B15, two calls), addmm (B14), none (B18: PyTorch has no band factor)", flush=True)
    for n in VMEM_SIZES:
        a = matrix(n, 2000 + n)
        kernel = lambda: ebv_lu.lu_vmem(a)
        plain = (timed(lambda: ebv_lu.lu_vmem_plain(a)) if n < VMEM_SIZES[-1]
                 else legacy_plain_ms[f"n={n}"])
        # 2n^3/3 flops; the matrix read once and its factor written once
        record("lu_vmem", f"n={n}", timed(kernel), plain,
               library(lambda: torch.linalg.lu_factor(a, pivot=False)), 2 * n ** 3 / 3, 2 * n * n * 4,
               per_call(ebv_lu.lu_vmem, kernel))
        walk_rate("lu_vmem", f"n={n}", n - 1, ebv_lu.legacy_walk_plan(n, n, torch.float32, sms))
    for m in (2000, 8000):
        b = LEGACY_BLOCK
        p = matrix(m, 2100 + m)[:, :b].contiguous()
        kernel = lambda: ebv_lu.panel(p)
        # b steps: each divides the m-1-k rows below the pivot and updates
        # their b-1-k trailing entries with a multiply and a subtract
        flops = sum((m - 1 - k) * (1 + 2 * (b - 1 - k)) for k in range(b))
        record("panel", f"m={m} b={b}", timed(kernel), timed(lambda: ebv_lu.panel_plain(p)),
               library(lambda: torch.linalg.lu_factor(p, pivot=False)), flops, 2 * m * b * 4,
               per_call(ebv_lu.panel, kernel))
        walk_rate("panel", f"m={m} b={b}", b, ebv_lu.legacy_walk_plan(m, b, torch.float32, sms))
    n, bw = SERVE_BAND
    kernel = lambda: banded.banded_lu_kernelized(sband, bw=bw)
    # as B5: n (2bw^2 + bw) flops, the band read once and its factor written once
    record("banded_lu_kernelized", f"n={n} bw={bw}", timed(kernel), legacy_plain_ms["scalar band"], None,
           n * (2 * bw * bw + bw), 2 * n * (2 * bw + 1) * 4, per_call(banded.banded_lu_kernelized, kernel))
    beside_parent("banded_lu_kernelized", f"n={n} bw={bw}")
    mb, wb = step_args[2].shape
    bb = step_args[0].shape[1]
    l11 = step_args[0][:bb]
    l21 = step_args[0][bb:]

    def two_calls():
        u = torch.linalg.solve_triangular(l11, step_args[1], upper=False, unitriangular=True)
        return torch.addmm(step_args[2], l21, u, alpha=-1)

    kernel = lambda: ebv_lu.fused_step(*step_args, col_tile=128)
    # the unit-lower solve b(b-1)W flops and the product 2(m-b)bW; pan, top
    # and trail read once, U12 and A22 written once
    record("fused_step", "n=2000 step 1", timed(kernel),
           timed(lambda: ebv_lu.fused_step_plain(*step_args)), library(two_calls),
           bb * (bb - 1) * wb + 2 * mb * bb * wb,
           ((mb + bb) * bb + 2 * (bb * wb + mb * wb)) * 4, per_call(ebv_lu.fused_step, kernel))
    ul, uu, uc = upd_args
    kernel = lambda: ebv_lu.update(*upd_args)
    mu, ku, wu = ul.shape[0], ul.shape[1], uu.shape[1]
    record("update", f"({mu}, {ku}, {wu})", timed(kernel), timed(lambda: ebv_lu.update_plain(*upd_args)),
           library(lambda: torch.addmm(uc, ul, uu, alpha=-1)), 2 * mu * ku * wu,
           (mu * ku + ku * wu + 2 * mu * wu) * 4, per_call(ebv_lu.update, kernel))

    # a single call's events count the host's time to reach the launch (the
    # card is idle when the first event is recorded); BACK_TO_BACK calls
    # between two events hide it behind the calls before, leaving the
    # device's time a call
    def back_to_back(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BACK_TO_BACK):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / BACK_TO_BACK

    b2 = {m: rhs(2000, m, 14) for m in (1, WIDE)}
    piv2 = torch.arange(1, 2001, dtype=torch.int32, device=dev)
    print(f"  {BACK_TO_BACK} calls back to back, ms a call (card: {card}):", flush=True)
    for label, fn in (("update (1792, 256, 1792)", lambda: ebv_lu.update(*upd_args)),
                      ("addmm (1792, 256, 1792)", lambda: torch.addmm(uc, ul, uu, alpha=-1)),
                      ("solve_vmem n=2000 m=1", lambda: trsm.solve_vmem(lus[2000], b2[1])),
                      ("lu_solve n=2000 m=1", lambda: torch.linalg.lu_solve(lus[2000], piv2, b2[1][:, None])),
                      (f"solve_vmem n=2000 m={WIDE}", lambda: trsm.solve_vmem(lus[2000], b2[WIDE])),
                      (f"lu_solve n=2000 m={WIDE}", lambda: torch.linalg.lu_solve(lus[2000], piv2, b2[WIDE]))):
        print(f"    {label:28s} {back_to_back(fn):.4f}", flush=True)

    for n in (2000, 8000):  # the legacy driver against the fused factor it was replaced by
        a = matrix(n, 2200 + n)
        tb = timed(lambda: ops.lu(a, impl="cuda_blocked"))
        tf = timed(lambda: ops.lu(a))
        print(f"  ops.lu(impl='cuda_blocked') n={n}: {tb:.4f} ms ({blocked_launches(n)} launches) against "
              f"the default cuda_fused {tf:.4f} ms", flush=True)

    print(f"  B15 on the forced cuda_blocked factor's first step beside solve_triangular + addmm, and the "
          f"factor (ms; card: {card}):", flush=True)
    time_kernels.blocked_steps(dev)
    print(f"  B5 at Table 1's bands and over bw at n = 16384, B6's slab steps beside it from bw = 12 and B18; "
          f"B11 at the three stacks, over its systems and over bw (ms; card: {card}):", flush=True)
    time_kernels.narrow_bands(dev)
    print(f"  B12 at the three stacks beside the per-warp kernel it ran before, over its systems and warps a "
          f"block at (16000, 5) and over warps a block at 32 x (4096, 64), each system bitwise B7 (ms; card: "
          f"{card}):", flush=True)
    time_kernels.batched_band_solves(dev)

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
        before = f" (before B9's cluster kernel: {OPT_STEP_BEFORE_MS} ms)" if name == "whisper-tiny" else ""
        print(f"    {name:16s} {opt_ms[name]:.3f} ms{before} (card: {card})", flush=True)

    print("  device time by kernel (torch.profiler, one call after a warm-up; under programmatic dependent "
          "launch a kernel's blocks start before the launch before them ends and their wait counts, so the "
          "sums of lu_fused, solve_tiled and solve_inverted over-count their calls: the CUDA-event times "
          "and steps below are theirs):", flush=True)
    a8 = matrix(8000, 8000)
    b8 = rhs(8000, 1, 11)
    ap = bands[(pn, POISSON_NX)]
    pfactor = bwrappers[factor_wrapper[banded_static_impl(POISSON_NX)]]
    for label, fn in (("lu_fused n=8000", lambda: ebv_lu.lu_fused(a8)),
                      ("solve_tiled n=8000 m=1", lambda: trsm.solve_tiled(lus[8000], b8)),
                      ("solve_inverted n=8000 m=1", lambda: trsm.solve_inverted(lus[8000], *inverses[8000], b8)),
                      (f"{pfactor.__name__} n={pn} bw={POISSON_NX}", lambda: pfactor(ap, bw=POISSON_NX)),
                      ("whisper-tiny optimizer step", lambda: opts["whisper-tiny"].step())):
        rows_k = kernel_breakdown(fn)
        busy = sum(r[1] for r in rows_k)
        print(f"    {label:24s} device busy {busy:.3f} ms in all, the {min(len(rows_k), 12)} "
              "largest:", flush=True)
        if label.endswith("optimizer step") and busy > 0:
            step = opt_ms["whisper-tiny"]
            print(f"    {label:24s} against the {step:.3f} ms step (host clock): idle share "
                  f"{max(0.0, 1 - busy / step):.3f}", flush=True)
        for name, k_ms, count in rows_k[:12]:
            print(f"    {label:24s} {name[:48]:48s} {k_ms:9.3f} ms  x{count}", flush=True)

    # a step of B1 is four launches in stream order (the panels, the next
    # block row and column, the next diagonal tile beside the rest of the
    # update), of B3 / B4 one / two: the step's time on the card beside the
    # host's time to enqueue a launch, below which no step can go
    def host_per_launch(call, nl):
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()  # returns once every launch is queued
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return 1e3 * statistics.median(host) / nl

    print(f"  the steps of the dense factor (card: {card}):", flush=True)
    a = matrix(128, 128)  # one step: the diagonal tile alone (and the copy of the matrix)
    tile_us = 1e3 * timed(lambda: [ebv_lu.lu_fused(a) for _ in range(20)]) / 20
    print(f"    lu_fused n=  128: one step and the non-finite pass, {tile_us:.2f} us a call over 20 calls back to back (events)",
          flush=True)
    for n in SIZES:
        a = matrix(n, n)
        nl, S = ebv_lu.fused_launches(n), -(-n // ebv_lu.fused_step_width(n))
        ms = rows[("lu_fused", f"n={n}")]["ms"]
        print(f"    lu_fused n={n:5d}: {nl} launches over {S} steps, {1e3 * ms / S:.2f} us per step on the card "
              f"(events), host enqueue {host_per_launch(lambda: ebv_lu.lu_fused(a), nl):.2f} us per launch",
              flush=True)
    print(f"  the steps of the dense solves at n=8000 (card: {card}):", flush=True)
    linv8, uinv8 = inverses[8000]
    for name, call, nl in (("solve_tiled", lambda b: trsm.solve_tiled(lus[8000], b), trsm.tiled_launches(8000)),
                           ("solve_inverted", lambda b: trsm.solve_inverted(lus[8000], linv8, uinv8, b),
                            trsm.inverted_launches(8000, linv8.shape[1]))):
        for m in (1, WIDE):
            b = rhs(8000, m, 12)
            ms = rows[(name, f"n=8000 m={m}")]["ms"]
            print(f"    {name:15s} m={m:3d}: {nl} launches, {1e3 * ms / nl:.2f} us per launch on the card "
                  f"(events), host enqueue {host_per_launch(lambda: call(b), nl):.2f} us per launch", flush=True)

    print("  cuda_vmem / cuda_tiled crossover (kernel ms):", flush=True)
    for n in (500, 1000, 2000, 4000, 8000):
        lu = lus[n] if n in lus else ebv_lu.lu_fused(matrix(n, n))
        for m in (1, WIDE):
            b = rhs(n, m, 10)
            tv, tt = timed(lambda: trsm.solve_vmem(lu, b)), timed(lambda: trsm.solve_tiled(lu, b))
            print(f"    n={n:5d} m={m:3d}  solve_vmem {tv:.4f}  solve_tiled {tt:.4f}  "
                  f"faster: {'solve_vmem' if tv <= tt else 'solve_tiled'}", flush=True)
            vmem_links(n, m, tv)

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

    print(f"  cuda_blocked / cuda_tiled on wide bands, n = 16384 (kernel ms; cuda_tiled is B6's cluster walk "
          f"past the slab of one block; card: {card}):", flush=True)
    for bw in WIDE_BANDS:
        a = band(16384, bw, 820 + bw)
        tb = timed(lambda: banded.banded_lu_blocked(a, bw=bw))
        tt = timed(lambda: banded.banded_lu_tiled(a, bw=bw))
        plan = banded.tiled_plan(16384, bw)
        how = "slab steps" if plan is None else f"cluster K={plan.ctas} g={plan.group}"
        print(f"    bw={bw:3d}  banded_lu_blocked {tb:.4f}  banded_lu_tiled {tt:.4f} ({how})  "
              f"faster: {'cuda_blocked' if tb <= tt else 'cuda_tiled'}  static rule: {banded_static_impl(bw)}",
              flush=True)
    pms = rows[("banded_lu_tiled", pshape)]["ms"]
    pplan = banded.tiled_plan(pn, POISSON_NX)
    print(f"  banded_lu_tiled at the Poisson band: {pms:.3f} ms, {1e3 * pms / pn:.3f} us a pivot, "
          f"{1e3 * pms / -(-pn // pplan.group):.2f} us a group of {pplan.group} on a cluster of {pplan.ctas} "
          f"(card: {card}); over K and g (ms, one call / {BACK_TO_BACK} back to back):", flush=True)
    time_kernels.band_cluster_sweep(apoisson, POISSON_NX)
    print(f"  B6's slab steps against its cluster walk on bands whose slab fits a block (ms; card: {card}):",
          flush=True)
    time_kernels.band_walk_crossover()
    print(f"  B7 over its warps a block and staged strips, beside the per-warp kernel it replaced "
          f"(ms; card: {card}):", flush=True)
    for n, bw, m, _ in bcases:
        if (n, bw, m) in time_kernels.SOLVE_BANDS:
            time_kernels.band_solve_sweep(band_lu[(n, bw)], rhs(n, m, 13), bw)

    print("  paged decode attention (B13); library: the page gather + scaled_dot_product_attention"
          "(enable_gqa=True) with a length mask, two calls", flush=True)

    def gather_sdpa(q, kp, vp, table, lengths):
        b, h, _ = q.shape
        np_, page, kvh, dh = table.shape[1], *kp.shape[1:]
        safe = table.clamp_min(0).long()
        k = kp[safe].reshape(b, np_ * page, kvh, dh).transpose(1, 2)
        v = vp[safe].reshape(b, np_ * page, kvh, dh).transpose(1, 2)
        mask = (torch.arange(np_ * page, device=dev) < lengths[:, None])[:, None, None, :]
        return torch.nn.functional.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                                enable_gqa=True)

    def record_b13(shape, args):
        q, kp, vp, table, lengths = args
        b, h, _ = q.shape
        np_, es, (page, kvh, dh) = table.shape[1], q.element_size(), kp.shape[1:]
        live = lengths.clamp(0, np_ * page)
        read = (torch.arange(np_, device=dev)[None] < (live[:, None] + page - 1) // page) & (table >= 0)
        # the live pages' K and V once, q in and the output out, the table and lengths
        nbytes = 2 * int(read.sum()) * page * kvh * dh * es + 2 * b * h * dh * es + (table.numel() + b) * 4
        kernel = lambda: paged_attn.paged_decode_attention(*args)
        record("paged_decode_attention", shape, timed(kernel),
               timed(lambda: paged_attn.paged_decode_attention_plain(*args)),
               library(lambda: gather_sdpa(*args)), 4 * int(live.sum()) * h * dh, nbytes,
               per_call(paged_attn.paged_decode_attention, kernel))
        # one call's events also hold the host's time to reach the launch,
        # which at the served shape exceeds the kernel's own; a CUDA graph's
        # replay holds the card's alone (and shows the launch capture-safe)
        dev_ms = time_kernels.graph_ms(kernel)
        print(f"    paged_decode_attention {shape}: {'not measured' if dev_ms is None else f'{dev_ms:.4f}'}"
              f" ms a call in a CUDA graph of {time_kernels.BACK_TO_BACK} (card: {card})", flush=True)

    g = torch.Generator(device=dev).manual_seed(1700)
    served_args = (torch.randn((nrow, mcfg.num_heads, dh), generator=g, device=dev).to(torch.bfloat16),
                   pcache["attn"]["k_pages"][0], pcache["attn"]["v_pages"][0], table, pos + 1)
    served_shape = f"B={nrow} NP={served_np} bf16"
    record_b13(served_shape, served_args)
    heavy_shape = f"B={DECODE_HEAVY[0]} NP={DECODE_HEAVY[1]} bf16"
    heavy_args = paged_case(DECODE_HEAVY[0], mcfg.num_heads, DECODE_HEAVY[1], torch.bfloat16, 1800,
                            holes=False)
    record_b13(heavy_shape, heavy_args)
    whisper_shape = f"B={WHISPER_SLOTS} NP={whisper_np} H=KV={wh} Dh={wdh} bf16"
    whisper_args = paged_case(WHISPER_SLOTS, wh, whisper_np, torch.bfloat16, 1850, holes=False, kv=wkv, hd=wdh)
    record_b13(whisper_shape, whisper_args)
    granite_shape = f"B={GRANITE_SLOTS} NP={granite_np} H={gh} KV={gkv} Dh={gdh} bf16"
    granite_args = paged_case(GRANITE_SLOTS, gh, granite_np, torch.bfloat16, 1860, holes=False, kv=gkv, hd=gdh)
    record_b13(granite_shape, granite_args)
    print(f"  B13 over its CTAs a cluster (ms; card: {card}):", flush=True)
    time_kernels.paged_sweep(served_args)
    time_kernels.paged_sweep(heavy_args)
    del heavy_args, whisper_args, granite_args

    kv_bytes = 2 * L * int(pos.sum()) * kvh * dh * 2  # the live K/V a step reads
    step_bound = (wbytes + kv_bytes) / PEAK_BYTES * 1e3
    print(f"  one {LM_ARCH} decode step, {nrow} rows at positions {pos.tolist()} (CUDA events, median of "
          f"{REPS}); bound: the weights' {wbytes / 1e9:.2f} GB and the live K/V's {kv_bytes / 1e6:.1f} MB "
          f"over 3.35 TB/s = {step_bound:.3f} ms", flush=True)
    tok = torch.zeros((nrow, 1), dtype=torch.long, device=dev)
    steps = {"dense": lambda: lm.decode_step(model, dcache, tok, pos, mcfg),
             "paged": lambda: lm.decode_step(model, pcache, tok, pos, mcfg, page_table=table)}
    for label, fn in steps.items():
        ms = timed(fn)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        host = statistics.median(host)
        rows_k = kernel_breakdown(fn)
        busy = sum(r[1] for r in rows_k)
        nk = sum(c for _, _, c in rows_k)
        idle = f"{max(0.0, 1 - busy / host):.3f}" if busy > 0 else "not measured"
        print(f"    {label}: {ms:.3f} ms (events), {host:.3f} ms (host clock, median of 3), "
              f"{ms / step_bound:.2f}x the bound; device busy {busy:.3f} ms over {nk} device "
              f"operations, idle share {idle} (card: {card})", flush=True)
        for name, k_ms, count in rows_k[:6]:
            print(f"      {name[:60]:60s} {k_ms:9.3f} ms  x{count}", flush=True)

    # ---- 4j. training: after phase 5, whose decode step needs the serving
    # model; the training step needs the card's memory that model held
    print(f"phase 4j: the training path, {LM_ARCH} at full width, {TRAIN_LAYERS} layers", flush=True)
    del model, probe, eng, engines, steps, fn, served_args, dcache, pcache
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    train_launches = train_phase(dev, card)

    # ---- 4k. whisper-tiny at full width: serving and training
    print(f"phase 4k: {WHISPER_ARCH} at full width", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    whisper_launches = whisper_phase(dev, card)

    # ---- 4l. the moe family: mixtral-8x22b (MIXTRAL_LAYERS layers) and granite-moe-1b-a400m
    print(f"phase 4l: {MIXTRAL_ARCH} ({MIXTRAL_LAYERS} layers) and {GRANITE_ARCH} at full width", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches = moe_phase(dev, card)

    # ---- 4m. the ssm and hybrid families: mamba2-1.3b and hymba-1.5b
    print(f"phase 4m: {SSM_ARCH} and {HYMBA_ARCH} at full width", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    ssm_launches = ssm_phase(dev, card)

    # ---- 6. kernels line + result ----------------------------------------
    shoot = f"n={SHOOTOUT[0]} bw={SHOOTOUT[1]}"
    ens = f"B={ENSEMBLE_MEMBERS} n={ENSEMBLE_NX ** 2} bw={ENSEMBLE_NX}"
    line_shape = {"lu_fused": "n=2000", "solve_vmem": f"n=2000 m={WIDE}",
                  "solve_tiled": f"n=8000 m={WIDE}", "solve_inverted": f"n=8000 m={WIDE}",
                  "banded_lu_blocked": "n=16000 bw=5", "banded_lu_tiled": shoot,
                  "banded_solve_kernelized": f"{shoot} m={WIDE}", "banded_solve_inverted": f"{shoot} m={WIDE}",
                  "batched_lu_vmem": f"B=2 n={d}", "batched_lu_solve_vmem": f"B=2 n={d} m={vocab}",
                  "batched_banded_lu_vmem": "B={} n={} bw={}".format(*ENSEMBLE_T1),
                  "batched_banded_solve_vmem": f"{ens} m=1",
                  "lu_vmem": f"n={VMEM_SIZES[-1]}", "panel": f"m=2000 b={LEGACY_BLOCK}",
                  "fused_step": "n=2000 step 1",
                  "update": f"({wpad}, {LEGACY_BLOCK}, {wpad})",
                  "banded_lu_kernelized": f"n={SERVE_BAND[0]} bw={SERVE_BAND[1]}",
                  "paged_decode_attention": served_shape}
    source = {"lu_fused": "src/repro_torch/csrc/ebv_lu.cu", "solve_vmem": "src/repro_torch/csrc/trsm.cu",
              "solve_tiled": "src/repro_torch/csrc/trsm.cu", "solve_inverted": "src/repro_torch/csrc/trsm.cu",
              **dict.fromkeys(bwrappers, "src/repro_torch/csrc/banded.cu"),
              "banded_lu_blocked": "src/repro_torch/csrc/band_walk.cu",  # bw <= 31: the line's n=16000 bw=5
              **dict.fromkeys(dwrappers, "src/repro_torch/csrc/batched_lu.cu"),
              **dict.fromkeys(ewrappers, "src/repro_torch/csrc/banded.cu"),
              **dict.fromkeys(("lu_vmem", "panel", "fused_step", "update"),
                              "src/repro_torch/csrc/legacy_lu.cu"),
              # bw <= 31, the warp walk: the lines' n=16000 bw=5 and B=16 n=16000 bw=5
              "banded_lu_kernelized": "src/repro_torch/csrc/band_walk.cu",
              "batched_banded_lu_vmem": "src/repro_torch/csrc/band_walk.cu",
              "paged_decode_attention": "src/repro_torch/csrc/paged_attn.cu"}
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
                "batched_banded_solve_vmem": "src/repro/kernels/banded.py:430",
                "lu_vmem": "src/repro/kernels/ebv_lu.py:96", "panel": "src/repro/kernels/ebv_lu.py:119",
                "fused_step": "src/repro/kernels/ebv_lu.py:154",
                "update": "src/repro/kernels/ebv_lu.py:407",
                "banded_lu_kernelized": "src/repro/kernels/banded.py:102",
                "paged_decode_attention": "src/repro/kernels/paged_attn.py:87"}
    launches.update(batched_launches)
    launches.update(legacy_launches)
    launches.update(update_launches)
    launches.update(dict.fromkeys(qwrappers, 0))  # B18 runs on the service path only
    launches["paged_decode_attention"] = lm_launches["paged"]  # B13 runs on the serving paths only (4i, 4k)
    # the kernels the tiers and the service launched, beside their own paths'
    for counts in (tier_launches, tier_opt_launches, serve_launches, train_launches, whisper_launches,
                   moe_launches, ssm_launches):
        for k, v in counts.items():
            if k not in lwrappers:  # the legacy kernels' service launches are in already
                launches[k] += v
    kernels = []
    for name in {**wrappers, **bwrappers, **dwrappers, **ewrappers, **lwrappers, **uwrappers, **qwrappers,
                 **pwrappers}:
        row = rows[(name, line_shape[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": source[name], "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": line_shape[name],
            # B12's CUDA kernel since it took B7's (before: band_solve_kernel)
            **({"kernel": "band_solve_staged_kernel"} if name == "batched_banded_solve_vmem" else {}),
        })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s (the build included)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
