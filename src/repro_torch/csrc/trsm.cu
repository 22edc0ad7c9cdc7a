// Forward (unit-lower) and backward (upper) substitution on a packed no-pivot
// LU, fp32, for Hopper (sm_90a).
//
// solve_vmem_kernel — replaces src/repro/kernels/trsm.py:solve_vmem, which
//   holds the whole factor in one core's VMEM and walks both sweeps in one
//   program.  Here "the factor on chip" is the card's 132 x 227 KB of shared
//   memory: ONE cooperative launch, block r owning the contiguous rows
//   r R .. r R + R - 1 of the packed LU for the whole launch
//   (kernels/trsm.py:solve_vmem_plan: R = 32 up to n = 4224, then
//   ceil(n / 132); at most one block per SM).  Whole rows give every block
//   the same R n elements over the two sweeps, since a row's L and U parts
//   sum to n: the paper's equal contribution applied to the solve.  A
//   block copies its rows' columns [theta, n) into shared memory once
//   (16-byte cp.async, all in flight together); where that does not fit
//   (past n = 1792 at R = 32) the leftmost columns, which the forward sweep
//   consumes first, are read from L2 as they are needed, and a block whose
//   diagonal tile streams keeps a copy of it where that fits (up to R of
//   about 240; past that it reads the tile from L2 too).
//   The forward sweep is a chain over the row blocks: block r takes
//   L[r, j] y_j for each earlier block j as y_j arrives; on y_{r-1} it
//   solves its unit-lower diagonal block (one lane a row; sub-blocks of 8
//   rows that every lane solves itself, so no shuffle sits inside the
//   recurrence: strip_solve) and hands y_r over.  The backward sweep runs
//   the same chain from the last block up with the U part, multiplying by
//   the reciprocal pivot.  A handoff is tagged cells (handoff.cuh): each
//   value stored with its tag in one 8-byte word, which the readers poll,
//   so a link costs one L2 round trip where a release-stored flag beside
//   the values costs three (the release, the flag, the values).  No
//   barrier spans the card.
//   What bounds it on this card: the 2 ceil(n / R) links of the chain, each
//   a handoff and an R-row triangle, not the n^2 * 4 bytes or 2 n^2 m
//   operations.  So a link stays inside one warp where it can: with
//   R <= 32 warp w of a block owns RHS columns 4w .. 4w+3 of a group of
//   at most 64 (vmem_warp), its lanes its rows' values in registers from b
//   to x, and walks both sweeps with no barrier of the block on its chain;
//   the warps of a block never wait on each other.  Past 32 rows a block
//   (vmem_sweep) the group's rows sit in shared memory, every thread owns
//   outputs whose depth splits over up to 4 lanes, and the diagonal block
//   goes in 32-row strips with the rows past each strip retired between
//   them.  The RHS goes in groups of G columns, walked in turn.  IEEE fp32
//   FMAs, no TF32; the sums run in another order than the plain version's
//   column sweeps.
//
// step_kernel — replaces src/repro/kernels/trsm.py:solve_tiled (B3) and
//   solve_inverted (B4).  Both sweep S = ceil(n/B) diagonal blocks forward
//   and S backward; step k solves block k and retires the trailing rows:
//   x[rows] -= L[rows, k-block] x_k forward, U[rows, k-block] x_k backward.
//   The TPU kernels walk all of a RHS tile's steps in one program; here
//   that would push the whole factor through one SM of 132.
//   What bounds it on this card: the 2S steps form a chain, each waiting
//   for the one before, and a step moves little (about n*B*4 bytes of the
//   factor); the n^2 * 4 bytes and 2 n^2 m operations of the whole solve
//   take under 0.13 ms at n = 8000.  So the design keeps the chain short
//   and each link cheap:
//   - Every step is one launch in stream order (B4: two), the launch
//     boundary its only grid-wide sync.  Each launch after the first is a
//     programmatic dependent launch: its blocks copy their (immutable) slice
//     of the factor while the step before still runs, then wait
//     (griddepcontrol) before they read x or y, and read those past L1.
//   - A step's trailing rows split into equal chunks of at most kRows rows
//     (the paper's equalization applied to the solve: every block retires
//     the same number of rows) over about one block per SM, times the RHS
//     column tiles.  A block copies its (rows, B) slice into shared memory
//     with 16-byte cp.async, all in flight at once, and multiplies: a wide
//     tile (up to 64 columns) gives each thread a 4 x 4 register tile of
//     outputs, a narrow one (up to 4 columns) gives each warp whole rows,
//     splits the depth over its lanes and sums them with a reduce-scatter
//     over the warp.  IEEE fp32 FMAs on the CUDA cores: wgmma would round
//     the operands to TF32.
//   - solve_tiled (B <= 128): every block first solves block k's triangle
//     itself (the "head"), in 32-row strips: per strip one row per lane,
//     each solved row passed to the rows below by __shfl_sync (one column
//     per warp) or a shared-memory broadcast (eight), then the rows below
//     the strip retired in register tiles; the tile's strips stream through
//     a ring of two shared-memory buffers.  Every block of a column tile
//     then holds the solved block and writes its share of it out.  One
//     launch per step, 2S in all.  The head repeats in every block; at m =
//     1 its 32-step chains are most of a step.
//   - solve_inverted (B from the artifact, 256 by default): the diagonal
//     step is a product with linv[k] / uinv[k] split over blocks as the
//     retirement is, so no chain runs inside a step.  Two launches per step
//     (the inverse product, then the retirement), none for the retirement
//     of the last step of a sweep: 4S-2 in all.  Depths past 256 stream in
//     passes.
//   A solved block goes to a second buffer (y forward, x backward), so no
//   block reads what another block of the same launch writes.
//
// All kernels treat rows and columns past n as the identity tail of the
// reference's padding, without materialising a padded copy of the LU.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "handoff.cuh"
#include "nonfinite.cuh"
#include "pdl.cuh"

namespace {

constexpr int kStrip = 32;    // strip height of solve_vmem and of a step's diagonal solve
constexpr int kSmemBytes = 232448;  // dynamic shared memory one H100 block may use

extern __shared__ __align__(16) float smem[];  // 16 bytes for cp.async and float4

// ---------------------------------------------------------------------------
// solve_vmem
// ---------------------------------------------------------------------------
constexpr int kVThreads = 512;   // 16 warps
constexpr int kVOut = 8;         // outputs a thread accumulates over a sweep's products
constexpr unsigned kBackoffNs = 256;  // between polls of a block that is not next in the chain
constexpr int kMaxSplit = 4;     // most lanes one output's depth splits over
constexpr int kSub = 8;          // rows of a diagonal sub-block that every lane of a warp solves itself
constexpr int kCellsAtOnce = 4;  // handed-over values a thread loads before it checks their tags

struct Vmem {
  const float* lu;
  const float* b;
  float* x;      // the result
  unsigned long long* cells;  // (2, n, m) zeroed: the sweeps' handed-over values, tagged (handoff.cuh)
  int n, m;
  int R, P, G;   // rows a block, blocks, RHS columns a group
  int theta;     // the first resident column, a multiple of R
  int copy;      // a block whose diagonal tile lies left of theta keeps a copy of it in shared memory
  int ld;        // the resident rows' stride in shared memory
  int D, RP, K;  // lanes one output's depth splits over; rows a pass of the outputs; outputs a thread
  int vec;       // 16-byte copies of the rows: n and theta multiples of 4, lu 16-byte aligned
};

// Row i of the block's rows (from r0), column col: in shared memory where
// col >= theta, else in the factor (L2).
__device__ __forceinline__ const float* row_at(const Vmem& p, const float* rows, int r0, int i, int col) {
  return col >= p.theta ? rows + (size_t)i * p.ld + col - p.theta : p.lu + (size_t)(r0 + i) * p.n + col;
}

// part[q] += A(i_q, k) v(k) over the k < Rj of one handed-over row block
// (v in shared memory, ldv apart): a lane takes k = d, d + D, ...; i_q =
// i0 + q RP.
__device__ __forceinline__ void product(float (&part)[kVOut], const float* a, int lda, const float* v, int ldv,
                                        int Rj, int Rb, int i0, int RP, int K, int d, int D) {
#pragma unroll 4
  for (int k = d; k < Rj; k += D) {
    const float vk = v[k * ldv];
#pragma unroll
    for (int q = 0; q < kVOut; ++q) {
      const int i = i0 + q * RP;
      if (q < K && i < Rb) part[q] = fmaf(a[(size_t)i * lda + k], vk, part[q]);
    }
  }
}

// Solve the strip's triangle (sr <= 32 rows from diag, row stride lda;
// rp its rows' reciprocal pivots, backward) for kC RHS columns of one
// warp, lane l holding row l's value in v.  The rows go in sub-blocks of
// kSub: the sub-block's values are gathered into every lane (one shuffle
// each, all in flight together), every lane solves the sub-block's
// (kSub, kSub) triangle itself with the entries read as broadcasts, so no
// shuffle sits inside the recurrence, and the rows past the sub-block
// retire its values.  A chain of one shuffle a row would cost a shuffle's
// latency a row.
template <bool kLower, int kC>
__device__ __forceinline__ void strip_solve(const float* diag, int lda, const float* rp, int sr, int lane,
                                            float (&v)[4]) {
  const int nsub = (sr + kSub - 1) / kSub;
  for (int t = 0; t < nsub; ++t) {
    const int q = kLower ? t : nsub - 1 - t, b0 = q * kSub, nb = min(kSub, sr - b0);
    float y[kC][kSub];
#pragma unroll
    for (int jj = 0; jj < kC; ++jj)
#pragma unroll
      for (int e = 0; e < kSub; ++e) y[jj][e] = __shfl_sync(0xffffffffu, v[jj], b0 + min(e, nb - 1));
    // every entry the sub-block needs, loaded together before the
    // recurrence: its triangle (zeros past nb), the reciprocal pivots, and
    // this lane's row in the sub-block's columns if the lane retires them
    const float* d = diag + (size_t)b0 * lda + b0;  // the sub-block's (0, 0)
    const int own = lane - b0;                       // this lane's row in the sub-block
    const bool retires = kLower ? own >= nb && lane < sr : own < 0;
    float tri[kSub][kSub], r[kSub], a[kSub];
#pragma unroll
    for (int e = 0; e < kSub; ++e) {
#pragma unroll
      for (int i = 0; i < kSub; ++i)
        if (kLower ? i > e : i < e) tri[i][e] = i < nb && e < nb ? d[i * lda + e] : 0.f;
      r[e] = !kLower && e < nb ? rp[b0 + e] : 1.f;
      a[e] = retires && e < nb ? diag[(size_t)lane * lda + b0 + e] : 0.f;
    }
    if (kLower) {
#pragma unroll
      for (int e = 0; e < kSub - 1; ++e)
#pragma unroll
        for (int i = e + 1; i < kSub; ++i)
#pragma unroll
          for (int jj = 0; jj < kC; ++jj) y[jj][i] = fmaf(-tri[i][e], y[jj][e], y[jj][i]);
    } else {
#pragma unroll
      for (int e = kSub - 1; e >= 0; --e) {
#pragma unroll
        for (int jj = 0; jj < kC; ++jj) y[jj][e] *= r[e];
#pragma unroll
        for (int i = 0; i < e; ++i)
#pragma unroll
          for (int jj = 0; jj < kC; ++jj) y[jj][i] = fmaf(-tri[i][e], y[jj][e], y[jj][i]);
      }
    }
    if (own >= 0 && own < nb) {
#pragma unroll
      for (int e = 0; e < kSub; ++e)
        if (e == own)
#pragma unroll
          for (int jj = 0; jj < kC; ++jj) v[jj] = y[jj][e];
    } else if (retires) {
#pragma unroll
      for (int e = 0; e < kSub; ++e)
#pragma unroll
        for (int jj = 0; jj < kC; ++jj) v[jj] = fmaf(-a[e], y[jj][e], v[jj]);
    }
  }
}

// One sweep of block r over the group of columns c0 .. c0+w-1 where a
// block owns more than 32 rows: forward (L y = b, unit diagonal) or
// backward (U x = y).  xs holds the block's rows of the group's right-hand
// side on entry and their solution on exit; diag0 is the block's diagonal
// tile, row stride ldd.
template <bool kLower>
__device__ void vmem_sweep(const Vmem& p, const float* rows, const float* diag0, int ldd, float* xs, float* vs,
                           const float* rpiv, int r, int c0, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = r * p.R, Rb = min(p.R, p.n - r0);
  const int d = threadIdx.x % p.D, grp = threadIdx.x / p.D;
  const int c = grp % p.G, i0 = grp / p.G;
  const bool mine = i0 < p.RP && c < w;
  unsigned long long* cells = p.cells + (kLower ? 0 : (size_t)p.n * p.m);  // this sweep's handoff
  const int nstrips = (Rb + kStrip - 1) / kStrip;

  // the products with the row blocks solved before this one, each as its
  // tagged values arrive, copied into one of two shared buffers (a block
  // that is not next in the chain first waits on one value, polled by one
  // thread now and then, so that the readers of a row block do not crowd
  // its lines): the partial sums stay split over D lanes until the last
  float part[kVOut];
#pragma unroll
  for (int q = 0; q < kVOut; ++q) part[q] = 0.f;
  const int pieces = kLower ? r : p.P - 1 - r;
  for (int t = 0; t < pieces; ++t) {
    const int j = kLower ? t : p.P - 1 - t;
    const int jc = j * p.R, Rj = min(p.R, p.n - jc);
    const unsigned long long* src = cells + (size_t)jc * p.m + c0;
    float* vt = vs + (t & 1) * p.R * p.G;  // the buffer the piece before last used: every thread is past it
    if (t + 2 < pieces) {  // a row block three or more links back
      if (threadIdx.x == 0) wait_cell(src, 1, kBackoffNs);
      __syncthreads();
    }
    for (int i0c = threadIdx.x; i0c < Rj * w; i0c += kCellsAtOnce * kVThreads) {
      unsigned long long got[kCellsAtOnce];  // a thread's cells, every load in flight together
#pragma unroll
      for (int e = 0; e < kCellsAtOnce; ++e) {
        const int idx = i0c + e * kVThreads;
        got[e] = idx < Rj * w ? load_cell(src + (size_t)(idx / w) * p.m + idx % w) : ~0ull;
      }
#pragma unroll
      for (int e = 0; e < kCellsAtOnce; ++e) {
        const int idx = i0c + e * kVThreads;
        if (idx < Rj * w) {
          const unsigned long long* at = src + (size_t)(idx / w) * p.m + idx % w;
          const float val = got[e] >> 32 ? __uint_as_float(static_cast<unsigned>(got[e])) : wait_cell(at, 1);
          vt[(idx / w) * p.G + idx % w] = val;
        }
      }
    }
    __syncthreads();
    if (!mine) continue;
    if (jc >= p.theta) product(part, rows + jc - p.theta, p.ld, vt + c, p.G, Rj, Rb, i0, p.RP, p.K, d, p.D);
    else product(part, p.lu + (size_t)r0 * p.n + jc, p.n, vt + c, p.G, Rj, Rb, i0, p.RP, p.K, d, p.D);
  }
  for (int off = p.D / 2; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < kVOut; ++q)
      if (q < p.K) part[q] += __shfl_xor_sync(0xffffffffu, part[q], off);
  if (mine && d == 0)
#pragma unroll
    for (int q = 0; q < kVOut; ++q) {
      const int i = i0 + q * p.RP;
      if (q < p.K && i < Rb) xs[c * p.R + i] -= part[q];
    }
  __syncthreads();

  // the diagonal block, in 32-row strips (from the bottom backward): warp
  // w solves columns 4w .. 4w+3, 64 + 4w .. (strip_solve), lane l the
  // strip's row l; then every thread retires rows past the strip
  for (int s = 0; s < nstrips; ++s) {
    const int s0 = (kLower ? s : nstrips - 1 - s) * kStrip, sr = min(kStrip, Rb - s0);
    const float* diag = diag0 + (size_t)s0 * ldd + s0;  // the strip's diagonal tile
    for (int cb = 4 * warp; cb < w; cb += 4 * (kVThreads / 32)) {
      const int cols = min(4, w - cb);
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) v[jj] = jj < cols && lane < sr ? xs[(cb + jj) * p.R + s0 + lane] : 0.f;
      if (cols == 1) strip_solve<kLower, 1>(diag, ldd, rpiv + s0, sr, lane, v);
      else strip_solve<kLower, 4>(diag, ldd, rpiv + s0, sr, lane, v);  // zero columns past w stay zero
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (jj < cols && lane < sr) xs[(cb + jj) * p.R + s0 + lane] = v[jj];
    }
    if (nstrips > 1) {
      __syncthreads();
      const int lo = kLower ? s0 + kStrip : 0, hi = kLower ? Rb : s0;
      for (int idx = threadIdx.x; idx < (hi - lo) * w; idx += kVThreads) {
        const int i = lo + idx % (hi - lo), cc = idx / (hi - lo);
        const float* a = diag0 + (size_t)i * ldd + s0;
        const float* xk = xs + cc * p.R + s0;
        float acc = 0.f;
        for (int k = 0; k < sr; ++k) acc = fmaf(a[k], xk[k], acc);
        xs[cc * p.R + i] -= acc;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  // hand the block's rows over, in rows of the RHS (coalesced); the result
  unsigned long long* dst = cells + (size_t)r0 * p.m + c0;
  for (int idx = threadIdx.x; idx < Rb * w; idx += kVThreads) {
    const int i = idx / w, cc = idx % w;
    store_cell(dst + (size_t)i * p.m + cc, xs[cc * p.R + i], 1);
  }
  if (!kLower)
    for (int idx = threadIdx.x; idx < Rb * w; idx += kVThreads) {
      const int i = idx / w, cc = idx % w;
      p.x[(size_t)(r0 + i) * p.m + c0 + cc] = xs[cc * p.R + i];
    }
  __syncthreads();  // xs read before the next sweep writes it
}

// Both sweeps of block r over the group's columns cb .. cb+kC-1 (those
// below c0 + w) by one warp, R <= 32: lane l holds row l's values in
// registers from b to x; each handed-over row block's values are loaded by
// the lanes of their rows and passed to the others by __shfl_sync, the
// diagonal block is one strip_solve, and the solved rows go out straight
// from the lanes.  The warps of a block own disjoint columns and never
// wait on each other: no barrier stands on the chain.
template <int kC>
__device__ void vmem_warp(const Vmem& p, const float* rows, const float* diag, int ldd, const float* rpiv, int r,
                          int cb, int cw) {
  const int lane = threadIdx.x & 31;
  const int r0 = r * p.R, Rb = min(p.R, p.n - r0);
  float v[4] = {};
#pragma unroll
  for (int jj = 0; jj < kC; ++jj) v[jj] = jj < cw && lane < Rb ? p.b[(size_t)(r0 + lane) * p.m + cb + jj] : 0.f;
#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep) {
    const bool lower = sweep == 0;
    unsigned long long* cells = p.cells + (lower ? 0 : (size_t)p.n * p.m) + cb;
    float acc[kC] = {};
    const int pieces = lower ? r : p.P - 1 - r;
    for (int t = 0; t < pieces; ++t) {
      const int j = lower ? t : p.P - 1 - t;
      const int jc = j * p.R, Rj = min(p.R, p.n - jc);
      const unsigned long long* src = cells + (size_t)jc * p.m;
      if (t + 2 < pieces) {  // a row block three or more links back
        if (lane == 0) wait_cell(src, 1, kBackoffNs);
        __syncwarp();
      }
      float pv[kC];
#pragma unroll
      for (int jj = 0; jj < kC; ++jj)
        pv[jj] = jj < cw && lane < Rj ? wait_cell(src + (size_t)lane * p.m + jj, 1) : 0.f;
      const float* a = row_at(p, rows, r0, lane < Rb ? lane : 0, jc);
#pragma unroll 4
      for (int k = 0; k < Rj; ++k) {
        const float ak = a[k];
#pragma unroll
        for (int jj = 0; jj < kC; ++jj) acc[jj] = fmaf(ak, __shfl_sync(0xffffffffu, pv[jj], k), acc[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) v[jj] -= acc[jj];
    if (lower) strip_solve<true, kC>(diag, ldd, rpiv, Rb, lane, v);
    else strip_solve<false, kC>(diag, ldd, rpiv, Rb, lane, v);
#pragma unroll
    for (int jj = 0; jj < kC; ++jj)
      if (jj < cw && lane < Rb) {
        store_cell(cells + (size_t)(r0 + lane) * p.m + jj, v[jj], 1);
        if (!lower) p.x[(size_t)(r0 + lane) * p.m + cb + jj] = v[jj];
      }
  }
}

// Block r owns rows r R .. r R + R - 1 of the factor for the whole launch:
// their columns [theta, n) are copied into shared memory once, the rest is
// read from L2 as the sweeps need it.
__global__ void __launch_bounds__(kVThreads, 1) solve_vmem_kernel(Vmem p) {
  const int r = blockIdx.x, r0 = r * p.R, Rb = min(p.R, p.n - r0);
  const int warp = threadIdx.x >> 5;
  float* rows = smem;                        // (Rb, ld)
  float* diagc = rows + (size_t)p.R * p.ld;  // (Rb, Rb) where p.copy: the diagonal tile where it is not resident
  float* rpiv = diagc + (p.copy ? p.R * p.R : 0);  // the rows' reciprocal pivots
  float* xs = rpiv + p.R;                    // wide path: (G, R), column-major: the group's rows of b, y, x
  float* vs = xs + p.R * p.G;                // wide path: 2 x (R, G), handed-over row blocks' values
  const int nr = p.n - p.theta;
  if (nr > 0) {
    const float* src = p.lu + (size_t)r0 * p.n + p.theta;
    if (p.vec) {
      const int q = nr / 4;
      for (int idx = threadIdx.x; idx < Rb * q; idx += kVThreads) {
        const int i = idx / q, k = 4 * (idx % q);
        cp_async16(rows + (size_t)i * p.ld + k, src + (size_t)i * p.n + k);
      }
    } else {
      for (int idx = threadIdx.x; idx < Rb * nr; idx += kVThreads) {
        const int i = idx / nr, k = idx % nr;
        cp_async4(rows + (size_t)i * p.ld + k, src + (size_t)i * p.n + k);
      }
    }
  }
  const bool streamed = r0 < p.theta;         // the diagonal tile is not resident ...
  const bool own_diag = streamed && p.copy;  // ... and a copy of it is kept
  if (own_diag)
    for (int idx = threadIdx.x; idx < Rb * Rb; idx += kVThreads)
      cp_async4(diagc + idx, p.lu + (size_t)(r0 + idx / Rb) * p.n + r0 + idx % Rb);
  cp_async_commit();
  for (int i = threadIdx.x; i < Rb; i += kVThreads) rpiv[i] = 1.f / p.lu[(size_t)(r0 + i) * (p.n + 1)];
  cp_async_wait<0>();
  __syncthreads();
  const float* diag = own_diag ? diagc : row_at(p, rows, r0, 0, r0);
  const int ldd = own_diag ? Rb : streamed ? p.n : p.ld;
  if (p.R <= kStrip) {  // a warp per 4 columns of a group, each on its own chain
    for (int c0 = 0; c0 < p.m; c0 += p.G) {
      const int w = min(p.G, p.m - c0), cb = c0 + 4 * warp;
      if (cb >= c0 + w) break;
      if (w == 1) vmem_warp<1>(p, rows, diag, ldd, rpiv, r, cb, 1);
      else vmem_warp<4>(p, rows, diag, ldd, rpiv, r, cb, min(4, c0 + w - cb));
    }
    return;
  }
  for (int c0 = 0; c0 < p.m; c0 += p.G) {
    const int w = min(p.G, p.m - c0);
    for (int idx = threadIdx.x; idx < Rb * w; idx += kVThreads) {
      const int i = idx % Rb, cc = idx / Rb;
      xs[cc * p.R + i] = p.b[(size_t)(r0 + i) * p.m + c0 + cc];
    }
    __syncthreads();
    vmem_sweep<true>(p, rows, diag, ldd, xs, vs, rpiv, r, c0, w);
    vmem_sweep<false>(p, rows, diag, ldd, xs, vs, rpiv, r, c0, w);
  }
}

// ---------------------------------------------------------------------------
// solve_tiled and solve_inverted: one step per launch
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;     // threads of a step block (8 warps)
constexpr int kRows = 64;         // most trailing rows one step block retires
constexpr int kDepth = 256;       // factor columns a launch without a head stages per pass
constexpr int kHeadDepth = 128;   // solve_tiled's largest B: a head holds the whole diagonal block
constexpr int kRingLd = kStrip + 4;  // row stride of a head's strip buffer
constexpr int kNarrow = 4;        // RHS columns of a narrow tile (the depth split over a warp)
constexpr int kWide = 64;         // RHS columns of a wide tile (register tiles, 16 threads across)

// Geometry of a BN-column tile.  With register tiles (BN > kNarrow) kTx
// threads go across the columns, 4 columns each, and kTy down the rows,
// thread ty taking rows ty + kTy*i; the operand is row-major with stride
// BN + 4.  A narrow tile gives warp w the rows w + 8i and splits the depth
// over its lanes; its operand is column-major.
template <int BN>
struct Tile {
  static constexpr bool kSplit = BN == kNarrow;
  static constexpr int kTx = kSplit ? 1 : BN / 4, kTy = kThreads / kTx;
  static constexpr int kI = kSplit ? kRows / 8 : kRows / kTy, kJ = kSplit ? kNarrow : 4;
};

enum Head { kNoHead, kLowerHead, kUpperHead };

// One launch's product: dst[r] = src[r] - a[r, :depth] @ xk (dst[r] = a[r] @ xk
// where src is null) for the launch's rows r; with a head, xk is first solved
// against the (depth, depth) triangle `diag`, and the blocks of a column tile
// write it to `solved`, each a share of its rows.
struct Step {
  const float* a;     // row 0, column 0 of the product's left operand
  int lda;            // its row stride
  int rows, chunk;    // rows of the product; rows per block
  int depth;          // columns of `a`, rows of xk
  const float* xk;    // the (depth, m) right operand, row stride m
  const float* diag;  // the diagonal tile a head solves against, row stride lda
  float* solved;      // where a head launch writes the solved xk (row stride m)
  const float* src;   // the rows updated (row stride m), or null
  float* dst;
  int m, tile;        // RHS width; RHS columns per block
  int vec;            // rows of `a` and `diag` start 16-byte aligned and depth % 4 == 0
  int chunks;         // row chunks: block b takes chunk b % chunks of column tile b / chunks
};

// dst[r * ld + k] = a[r][k] for r < R, k < kc, copied asynchronously.
template <int ld>
__device__ void stage_slice(float* dst, const float* a, int lda, int R, int kc, bool vec) {
  if (vec) {
    const int q = kc / 4;
    for (int idx = threadIdx.x; idx < R * q; idx += kThreads) {
      const int r = idx / q, k = 4 * (idx % q);
      cp_async16(dst + r * ld + k, a + (size_t)r * lda + k);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * kc; idx += kThreads) {
      const int r = idx / kc, k = idx % kc;
      cp_async4(dst + r * ld + k, a + (size_t)r * lda + k);
    }
  }
}

// The (kP, BN) right operand in shared memory: row-major for register
// tiles (float4 rows), column-major for a narrow tile (a warp's lanes read
// consecutive depths).
template <int BN, int kP>
struct Operand {
  static constexpr int kFloats = BN == kNarrow ? kP * kNarrow : kP * (BN + 4);
  float* p;
  __device__ float& operator()(int i, int c) const {
    return BN == kNarrow ? p[c * kP + i] : p[i * (BN + 4) + c];
  }
};

// xs(i, c) = xk[k0 + i][c0 + c] for i < kc, c < BN, zero for c >= w; read
// past L1, which may hold lines an earlier step overwrote.  A wide tile of
// 16-byte rows loads float4s, many in flight at once.
template <int BN, class X>
__device__ void load_operand(X xs, const float* xk, int m, int c0, int w, int k0, int kc) {
  const float* x0 = xk + (size_t)k0 * m + c0;
  if (BN > kNarrow && w == BN && m % 4 == 0 && reinterpret_cast<uintptr_t>(x0) % 16 == 0) {
#pragma unroll 8
    for (int idx = threadIdx.x; idx < kc * (BN / 4); idx += kThreads) {
      const int i = idx / (BN / 4), c = 4 * (idx % (BN / 4));
      *reinterpret_cast<float4*>(&xs(i, c)) = __ldcg(reinterpret_cast<const float4*>(x0 + (size_t)i * m + c));
    }
    return;
  }
#pragma unroll 8
  for (int idx = threadIdx.x; idx < kc * BN; idx += kThreads) {
    const int i = idx / BN, c = idx % BN;
    xs(i, c) = c < w ? __ldcg(x0 + (size_t)i * m + c) : 0.f;
  }
}

// The rows of strip t (columns s0 .. s0+32 of the (kw, kw) diagonal tile
// `diag`, row stride lda) that a head reads, copied to ring[r * kRingLd + l]:
// rows s0 .. kw for the lower triangle, 0 .. s0+32 for the upper.
template <int kHead>
__device__ void stage_strip(float* ring, const float* diag, int lda, int kw, int t, bool vec) {
  const int nstrips = (kw + kStrip - 1) / kStrip;
  if (t >= nstrips) return;
  const int s0 = (kHead == kLowerHead ? t : nstrips - 1 - t) * kStrip;
  const int lo = kHead == kLowerHead ? s0 : 0, hi = kHead == kLowerHead ? kw : min(kw, s0 + kStrip);
  float* buf = ring + (t % 2) * kHeadDepth * kRingLd;
  stage_slice<kRingLd>(buf + lo * kRingLd, diag + (size_t)lo * lda + s0, lda, hi - lo,
                       min(kStrip, kw - s0), vec);
}

// Solve X (kw, w) in place against the unit-lower (kHead == kLowerHead) or
// upper triangle of the (kw, kw) diagonal tile, in 32-row strips whose
// columns stream through a ring of two shared-memory buffers (strips 0 and
// 1 were staged by the caller, before its copy of the factor slice): each
// warp takes columns warp, warp + 8, ... and solves a strip's triangle with
// one row per lane, each solved row passed to the lanes below (above) it;
// then the rows below (above) the strip are retired, in 4 x 4 register
// tiles for a wide tile.
template <int kHead, int BN, class X>
__device__ void solve_head(X xs, float* ring, const float* diag, int lda, int kw, int w, bool vec) {
  constexpr int kCols = (BN + 7) / 8;  // columns per warp
  constexpr int ld = kRingLd;
  __shared__ __align__(16) float bc[kThreads / 32][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lower = kHead == kLowerHead;
  const int nstrips = (kw + kStrip - 1) / kStrip;
  for (int t = 0; t < nstrips; ++t) {
    // copy groups committed so far: strips 0 and 1, the slice, then strip u + 1 after strip u
    if (t < 2) cp_async_wait<2>();
    else cp_async_wait<1>();
    __syncthreads();
    const int s0 = (lower ? t : nstrips - 1 - t) * kStrip;
    const float* d = ring + (t % 2) * kHeadDepth * ld - s0;  // d[r * ld + s0 + l] = diag[r][s0 + l]
    const int depth = min(kStrip, kw - s0);
    const int row = s0 + lane;
    if (warp < w) {
      float tr[kStrip];
#pragma unroll
      for (int l = 0; l < kStrip; ++l)
        tr[l] = (lane < depth && (lower ? l < lane : (l > lane && l < depth))) ? d[row * ld + s0 + l] : 0.f;
      // a reciprocal keeps the division off the chain
      const float rpiv = (!lower && lane < depth) ? 1.f / d[row * ld + row] : 1.f;
      float v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = warp + 8 * j;
        v[j] = (c < w && lane < depth) ? xs(row, c) : 0.f;
      }
      // row l of the strip, once solved, to every lane: a shuffle for one
      // column, one shared-memory broadcast for a warp's kCols columns
      auto retire_row = [&](int l) {
        float p[kCols];
        if constexpr (kCols == 1) {
          p[0] = __shfl_sync(0xffffffffu, v[0], l);
        } else {
          if (lane == l)
#pragma unroll
            for (int j = 0; j < kCols; ++j) bc[warp][j] = v[j];
          __syncwarp();
#pragma unroll
          for (int j = 0; j < kCols; ++j) p[j] = bc[warp][j];
          __syncwarp();
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[j] -= tr[l] * p[j];
      };
      if (lower) {
#pragma unroll
        for (int l = 0; l < kStrip - 1; ++l) retire_row(l);
      } else {
#pragma unroll
        for (int l = kStrip - 1; l >= 0; --l) {
          if (lane == l)
#pragma unroll
            for (int j = 0; j < kCols; ++j) v[j] *= rpiv;
          retire_row(l);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = warp + 8 * j;
        if (c < w && lane < depth) xs(row, c) = v[j];
      }
    }
    __syncthreads();
    const int lo = lower ? s0 + kStrip : 0, hi = lower ? kw : s0;
    if constexpr (BN > kNarrow) {
      using T = Tile<BN>;
      const int tx = threadIdx.x % T::kTx, ty = threadIdx.x / T::kTx;
      for (int base = lo; base < hi; base += kRows) {
        float acc[T::kI][4] = {};
#pragma unroll 8
        for (int l = 0; l < depth; ++l) {
          const float4 b = *reinterpret_cast<const float4*>(&xs(s0 + l, 4 * tx));
#pragma unroll
          for (int i = 0; i < T::kI; ++i) {
            const int r = base + ty + T::kTy * i;
            const float a = r < hi ? d[r * ld + s0 + l] : 0.f;
            acc[i][0] += a * b.x;
            acc[i][1] += a * b.y;
            acc[i][2] += a * b.z;
            acc[i][3] += a * b.w;
          }
        }
#pragma unroll
        for (int i = 0; i < T::kI; ++i)
          if (base + ty + T::kTy * i < hi)
#pragma unroll
            for (int j = 0; j < 4; ++j) xs(base + ty + T::kTy * i, 4 * tx + j) -= acc[i][j];
      }
    } else {
      for (int idx = threadIdx.x; idx < (hi - lo) * w; idx += kThreads) {
        const int i = lo + idx / w, c = idx % w;
        const float* di = d + i * ld + s0;
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < kStrip; ++l)
          if (l < depth) acc += di[l] * xs(s0 + l, c);
        xs(i, c) -= acc;
      }
    }
    __syncthreads();
    stage_strip<kHead>(ring, diag, lda, kw, t + 2, vec);  // into the buffer strip t used
    cp_async_commit();
  }
}

// One stage of a reduce-scatter over the warp: out[k] = the sum over lanes
// l and l ^ N of in[k + N] where this lane has bit N, of in[k] where not.
template <int N>
__device__ __forceinline__ void fold(const float (&in)[2 * N], float (&out)[N], int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int k = 0; k < N; ++k)
    out[k] = (up ? in[k + N] : in[k]) + __shfl_xor_sync(0xffffffffu, up ? in[k] : in[k + N], N);
}

template <int BN, int kHead>
__global__ void __launch_bounds__(kThreads) step_kernel(Step s) {
  using T = Tile<BN>;
  constexpr bool kSolve = kHead != kNoHead;
  constexpr int kP = kSolve ? kHeadDepth : kDepth;  // depth of one pass
  constexpr int kLd = kP + 4;  // row stride of a staged slice: 16-byte rows, rows 4 banks apart
  float* As = smem;                            // (kRows, kLd) slice of the left operand
  const Operand<BN, kP> xs{As + kRows * kLd};  // (kP, BN) right operand
  float* ring = xs.p + xs.kFloats;             // a head's two (kP, kRingLd) strip buffers
  // (row chunk, column tile) folded into blockIdx.x, chunks fastest: any RHS width
  const int chunk = blockIdx.x % s.chunks;
  const int c0 = blockIdx.x / s.chunks * s.tile;
  const int w = min(s.tile, s.m - c0);
  const int r0 = chunk * s.chunk;
  const int R = max(0, min(s.chunk, s.rows - r0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % T::kTx, ty = threadIdx.x / T::kTx;
  // register tiles: rows ty + kTy*i, columns 4tx + j; narrow: rows warp + 8i, column j
  constexpr int kI = T::kI, kJ = T::kJ, kTy = T::kTy;
  float acc[kI][kJ] = {};
  // src at this thread's outputs: all of them for register tiles; for a
  // narrow tile lane kJ*i + j holds output (i, j) of its warp
  float old[T::kSplit ? 1 : kI][T::kSplit ? 1 : kJ] = {};
  const float* row0 = s.src ? s.src + (size_t)r0 * s.m + c0 : nullptr;
  float* out0 = s.dst + (size_t)r0 * s.m + c0;

  // prologue, before the prior step ends: copy groups [strip 0] [strip 1] of
  // a head's diagonal tile, then [slice of pass 0]
  if constexpr (kSolve) {
    for (int t = 0; t < 2; ++t) {
      stage_strip<kHead>(ring, s.diag, s.lda, s.depth, t, s.vec);
      cp_async_commit();
    }
  }
  for (int k0 = 0; k0 < s.depth; k0 += kP) {  // one pass with a head (depth <= kHeadDepth)
    const int kc = min(kP, s.depth - k0);
    if (R) stage_slice<kLd>(As, s.a + (size_t)r0 * s.lda + k0, s.lda, R, kc, s.vec);
    cp_async_commit();
    if (k0 == 0) {
      allow_next_step();
      wait_prior_step();
    }
    load_operand<BN>(xs, s.xk, s.m, c0, w, k0, kc);
    if (k0 == 0 && s.src) {  // the rows this block updates, in flight beside the head and the product
      if constexpr (!T::kSplit) {
#pragma unroll
        for (int i = 0; i < kI; ++i)
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            if (ty + kTy * i < R && 4 * tx + j < w) old[i][j] = __ldcg(row0 + (size_t)(ty + kTy * i) * s.m + 4 * tx + j);
      } else if (warp + 8 * (lane / kJ) < R && lane % kJ < w) {
        old[0][0] = __ldcg(row0 + (size_t)(warp + 8 * (lane / kJ)) * s.m + lane % kJ);
      }
    }
    if constexpr (kSolve) {
      solve_head<kHead, BN>(xs, ring, s.diag, s.lda, kc, w, s.vec);
      // the solved block out, rows chunk, chunk + chunks, ...
      const int mine = chunk < kc ? (kc - chunk + s.chunks - 1) / s.chunks : 0;
      for (int idx = threadIdx.x; idx < mine * w; idx += kThreads) {
        const int i = chunk + (idx / w) * s.chunks, c = idx % w;
        s.solved[(size_t)i * s.m + c0 + c] = xs(i, c);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (R) {
      if constexpr (!T::kSplit) {
#pragma unroll 4
        for (int k = 0; k < kc; ++k) {
          const float4 b = *reinterpret_cast<const float4*>(&xs(k, 4 * tx));
#pragma unroll
          for (int i = 0; i < kI; ++i) {
            const float a = As[(ty + kTy * i) * kLd + k];
            acc[i][0] += a * b.x;
            acc[i][1] += a * b.y;
            acc[i][2] += a * b.z;
            acc[i][3] += a * b.w;
          }
        }
      } else {
        for (int k = lane; k < kc; k += 32) {
          float b[kJ];
#pragma unroll
          for (int j = 0; j < kJ; ++j) b[j] = xs(k, j);
#pragma unroll
          for (int i = 0; i < kI; ++i)
            if (warp + 8 * i < R) {
              const float a = As[(warp + 8 * i) * kLd + k];
#pragma unroll
              for (int j = 0; j < kJ; ++j) acc[i][j] += a * b[j];
            }
        }
      }
    }
    __syncthreads();
  }
  if (!R) return;

  const bool update = s.src != nullptr;
  if constexpr (!T::kSplit) {
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (ty + kTy * i < R && 4 * tx + j < w)
          out0[(size_t)(ty + kTy * i) * s.m + 4 * tx + j] = update ? old[i][j] - acc[i][j] : acc[i][j];
  } else {
    // reduce-scatter over the warp: after the stage of offset o a lane keeps
    // the half of its partial sums whose index has o's bit equal to its own,
    // so lane l ends with the sum of output l = (l / kJ, l % kJ)
    static_assert(kI * kJ == 32, "one output per lane");
    float v32[32], v16[16], v8[8], v4[4], v2[2], v1[1];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) v32[kJ * i + j] = acc[i][j];
    fold(v32, v16, lane);
    fold(v16, v8, lane);
    fold(v8, v4, lane);
    fold(v4, v2, lane);
    fold(v2, v1, lane);
    const int i = lane / kJ, j = lane % kJ;
    if (warp + 8 * i < R && j < w) out0[(size_t)(warp + 8 * i) * s.m + j] = update ? old[0][0] - v1[0] : v1[0];
  }
}

constexpr size_t step_smem(int bn, bool head) {
  const size_t p = head ? kHeadDepth : kDepth;
  const size_t operand = bn == kNarrow ? p * kNarrow : p * (bn + 4);
  return (kRows * (p + 4) + operand + (head ? 2 * p * kRingLd : 0)) * sizeof(float);
}

template <int BN>
cudaError_t allow_variant() {
  cudaError_t err;
  if ((err = allow_smem(step_kernel<BN, kNoHead>, step_smem(BN, false)))) return err;
  if ((err = allow_smem(step_kernel<BN, kLowerHead>, step_smem(BN, true)))) return err;
  return allow_smem(step_kernel<BN, kUpperHead>, step_smem(BN, true));
}

bool aligned(const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shared memory attributes of the step kernels and of solve_vmem (the
// most a block may use), set once per device (device_sms).
cudaError_t allow_kernels_smem() {
  cudaError_t err;
  if ((err = allow_variant<kNarrow>())) return err;
  if ((err = allow_variant<kWide>())) return err;
  return allow_smem(solve_vmem_kernel, kSmemBytes);
}

// What ebv_solve_tiled / ebv_solve_inverted return where a step would need
// more than 2^31 - 1 blocks (kernels/_build.py:GRID_PAST_AXIS), before any
// launch.
constexpr int kGridPastAxis = 100000;

// Launches the steps of one solve on `stream`, counting them in *launches
// and keeping the largest grid in `widest`; where `dry`, launches nothing.
// Every launch after the first is a programmatic dependent launch: it may
// start while the step before it runs (see allow_next_step).  The first
// waits for whatever ran before it in full, since that may have written the
// factor.
struct Sweep {
  cudaStream_t stream;
  int* launches;
  int m, tile, tiles, sms;
  bool dry;
  long long widest;

  // One launch of s over equal row chunks: about one block per SM over the
  // column tiles, each chunk of rmin..kRows rows; (chunk, tile) folded into
  // one grid axis.
  template <int kHead>
  int run(Step s, int rmin) {
    const int per_tile = (sms + tiles - 1) / tiles;
    int chunk = (s.rows + per_tile - 1) / per_tile;
    chunk = min(kRows, max(rmin, chunk));
    const int blocks = s.rows > 0 ? (s.rows + chunk - 1) / chunk : 1;
    const long long grid = (long long)blocks * tiles;
    if (grid > widest) widest = grid;
    if (dry) return widest > 0x7fffffffLL ? kGridPastAxis : 0;
    s.chunk = s.rows > 0 ? (s.rows + blocks - 1) / blocks : 1;
    s.chunks = blocks;
    s.m = m;
    s.tile = tile;
    s.vec = aligned(s.a) && aligned(s.diag) && s.lda % 4 == 0 && s.depth % 4 == 0;
    const int bn = tile <= kNarrow ? kNarrow : kWide;
    const size_t smem = step_smem(bn, kHead != kNoHead);
    const bool chained = *launches > 0;
    cudaError_t err = bn == kNarrow
        ? launch_step(step_kernel<kNarrow, kHead>, dim3(blocks * tiles), dim3(kThreads), smem, stream, chained, s)
        : launch_step(step_kernel<kWide, kHead>, dim3(blocks * tiles), dim3(kThreads), smem, stream, chained, s);
    if (!err) ++*launches;
    return err;
  }
};

}  // namespace

// x = (LU)^-1 b for packed row-major lu (n, n), b and x (n, m) row-major,
// fp32: one cooperative launch of ceil(n / R) blocks of R rows, counted in
// *launched, the RHS in groups of G columns; columns [theta, n) of a block's
// rows resident in shared memory (theta a multiple of R), and where `copy`
// a block whose diagonal tile lies left of theta keeps a copy of it there.
// cells: 2 n m zeroed 8-byte words, the two sweeps' handoffs.  plan[0..5]
// reports the blocks, R, G, theta, copy and the shared-memory bytes a block.
extern "C" int ebv_solve_vmem(const void* lu, const void* b, void* x, void* cells, int n, int m, int R, int G,
                              int theta, int copy, void* stream, int* plan, int* launched) {
  *launched = 0;
  for (int i = 0; i < 6; ++i) plan[i] = 0;
  if (n < 1 || m < 1 || R < 1 || R > n || G < 1 || G > m || theta < 0 || theta % R || copy < 0 || copy > 1)
    return cudaErrorInvalidValue;
  int sms = 0, dev = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t err;
  if ((err = device_sms<allow_kernels_smem>(&sms))) return err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))) return err;
  if (!coop) return cudaErrorNotSupported;
  Vmem p{static_cast<const float*>(lu), static_cast<const float*>(b), static_cast<float*>(x),
         static_cast<unsigned long long*>(cells), n, m, R, (n + R - 1) / R, G, theta, copy};
  const int nr = n - theta;
  p.ld = nr > 0 ? (nr + 31) / 32 * 32 + 4 : 0;  // rows 16 bytes apart, 4 banks apart
  p.D = 1;
  while (2 * p.D <= kMaxSplit && p.D < R && 2 * p.D * G * R <= kVThreads) p.D *= 2;
  p.RP = kVThreads / p.D / G;
  p.K = p.RP > 0 ? (R + p.RP - 1) / p.RP : 0;
  const bool warps = R <= kStrip;  // the warp path: a warp per 4 columns
  if (warps ? G > 4 * (kVThreads / 32) : p.RP < 1 || p.K > kVOut) return cudaErrorInvalidValue;
  p.vec = n % 4 == 0 && theta % 4 == 0 && reinterpret_cast<uintptr_t>(lu) % 16 == 0;
  const size_t bytes = (size_t)R * (p.ld + (copy ? R : 0) + 1 + (warps ? 0 : 3 * G)) * sizeof(float);
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solve_vmem_kernel, kVThreads, bytes))) return err;
  if (p.P > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  plan[0] = p.P;
  plan[1] = R;
  plan[2] = G;
  plan[3] = theta;
  plan[4] = copy;
  plan[5] = static_cast<int>(bytes);
  void* args[] = {&p};
  if ((err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(solve_vmem_kernel), dim3(p.P), dim3(kVThreads), args,
                                         bytes, static_cast<cudaStream_t>(stream))))
    return err;
  *launched = 1;
  if ((err = cudaGetLastError())) return err;
  // the NaN the plain version's masked axpys spread: one recurrence over n
  // (nonfinite.cuh), one more launch
  return nonfinite::launch_solve_fill(static_cast<float*>(x), 1, n, m, n, static_cast<cudaStream_t>(stream),
                                      launched);
}

// Same solve with (B, B) LU tiles, B <= 128, S = ceil(n / B): one launch per
// diagonal step, 2S in all, counted in *launches.  RHS columns go in tiles
// of `tile` (<= 64); y is an (n, m) scratch buffer.  *grid: the most blocks
// a step takes; past 2^31 - 1 nothing is launched (kGridPastAxis).
extern "C" int ebv_solve_tiled(const void* lu_ptr, const void* b_ptr, void* x_ptr, void* y_ptr, int n,
                               int m, int B, int tile, void* stream, int* launches, long long* grid) {
  *launches = 0;
  *grid = 0;
  if (B < 1 || B > kHeadDepth || tile < 1 || tile > kWide) return cudaErrorInvalidValue;
  if (n < 1 || m < 1) return 0;
  const float* lu = static_cast<const float*>(lu_ptr);
  const float* b = static_cast<const float*>(b_ptr);
  float* x = static_cast<float*>(x_ptr);
  float* y = static_cast<float*>(y_ptr);
  Sweep sw{static_cast<cudaStream_t>(stream), launches, m, tile, (m + tile - 1) / tile, 0, true, 0};
  int err = device_sms<allow_kernels_smem>(&sw.sms);
  if (err) return err;
  const int S = (n + B - 1) / B;
  // every step's grid first, then the launches; a step takes chunks of 8
  // rows at least, so where tiles * ceil(n / 8) fits one axis, none can pass
  sw.dry = (long long)sw.tiles * ((n + 7) / 8) > 0x7fffffffLL;
  for (int pass = sw.dry ? 0 : 1; pass < 2; ++pass, sw.dry = false) {
    for (int k = 0; k < S; ++k) {  // L y = b: block k solved into y, rows below retired in x
      const size_t kb = (size_t)k * B;
      const int kw = min(B, n - (int)kb), r0 = (int)kb + kw;
      const float* cur = k ? x : b;
      Step s{lu + (size_t)r0 * n + kb, n, n - r0, 0, kw, cur + kb * m, lu + kb * n + kb, y + kb * m,
             cur + (size_t)r0 * m, x + (size_t)r0 * m};
      if ((err = sw.run<kLowerHead>(s, kRows / 2))) break;
    }
    for (int k = S - 1; k >= 0 && !err; --k) {  // U x = y: block k solved into x, rows above retired in y
      const size_t kb = (size_t)k * B;
      const int kw = min(B, n - (int)kb);
      Step s{lu + kb, n, (int)kb, 0, kw, y + kb * m, lu + kb * n + kb, x + kb * m, y, y};
      err = sw.run<kUpperHead>(s, kRows / 2);
    }
    *grid = sw.widest;
    if (err) return err;
  }
  // the NaN the plain version's masked B-row tiles spread (nonfinite.cuh),
  // one more launch
  return nonfinite::launch_solve_fill(x, 1, n, m, B, sw.stream, launches);
}

// Same solve from the (S', B, B) inverses (S' >= ceil(n / B)) of the
// identity-padded LU's diagonal blocks: per step one launch for the inverse
// product and one for the retirement, 4S-2 in all (S = ceil(n / B)), counted
// in *launches.  Only the inverses' leading (kw, kw) corner is read: past n
// they are the identity acting on zero rows.  *grid as ebv_solve_tiled's.
extern "C" int ebv_solve_inverted(const void* lu_ptr, const void* linv_ptr, const void* uinv_ptr,
                                  const void* b_ptr, void* x_ptr, void* y_ptr, int n, int m, int B,
                                  int tile, void* stream, int* launches, long long* grid) {
  *launches = 0;
  *grid = 0;
  if (B < 1 || tile < 1 || tile > kWide) return cudaErrorInvalidValue;
  if (n < 1 || m < 1) return 0;
  const float* lu = static_cast<const float*>(lu_ptr);
  const float* linv = static_cast<const float*>(linv_ptr);
  const float* uinv = static_cast<const float*>(uinv_ptr);
  const float* b = static_cast<const float*>(b_ptr);
  float* x = static_cast<float*>(x_ptr);
  float* y = static_cast<float*>(y_ptr);
  Sweep sw{static_cast<cudaStream_t>(stream), launches, m, tile, (m + tile - 1) / tile, 0, true, 0};
  int err = device_sms<allow_kernels_smem>(&sw.sms);
  if (err) return err;
  const int S = (n + B - 1) / B;
  const size_t bb = (size_t)B * B;
  const int rmin = tile > kNarrow ? 16 : 8;
  sw.dry = (long long)sw.tiles * ((n + 7) / 8) > 0x7fffffffLL;  // as ebv_solve_tiled's
  for (int pass = sw.dry ? 0 : 1; pass < 2; ++pass, sw.dry = false) {
    for (int k = 0; k < S; ++k) {  // y_k = linv[k] cur_k; x[below] = cur[below] - L y_k
      const size_t kb = (size_t)k * B;
      const int kw = min(B, n - (int)kb), r0 = (int)kb + kw;
      const float* cur = k ? x : b;
      Step inv{linv + k * bb, B, kw, 0, kw, cur + kb * m, nullptr, nullptr, nullptr, y + kb * m};
      if ((err = sw.run<kNoHead>(inv, rmin)) || r0 == n) break;
      Step ret{lu + (size_t)r0 * n + kb, n, n - r0, 0, kw, y + kb * m, nullptr, nullptr,
               cur + (size_t)r0 * m, x + (size_t)r0 * m};
      if ((err = sw.run<kNoHead>(ret, rmin))) break;
    }
    for (int k = S - 1; k >= 0 && !err; --k) {  // x_k = uinv[k] y_k; y[above] -= U x_k
      const size_t kb = (size_t)k * B;
      const int kw = min(B, n - (int)kb);
      Step inv{uinv + k * bb, B, kw, 0, kw, y + kb * m, nullptr, nullptr, nullptr, x + kb * m};
      if ((err = sw.run<kNoHead>(inv, rmin)) || !kb) break;
      Step ret{lu + kb, n, (int)kb, 0, kw, x + kb * m, nullptr, nullptr, y, y};
      err = sw.run<kNoHead>(ret, rmin);
    }
    *grid = sw.widest;
    if (err) return err;
  }
  return 0;
}
