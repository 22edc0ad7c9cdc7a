// The NaN the reference's masked steps spread from a non-finite value, as
// passes after the port's live-row kernels (core/nonfinite.py has the
// rules).  The reference writes each elimination and substitution step as a
// full-length masked update, so 0 * inf turns NaN entries the mask zeroes;
// the kernels update only the live rows, which gives the same finite values.
// A no-pivot factor or solve with no non-finite value anywhere leaves these
// passes nothing to do: each first looks for one where any would show (the
// diagonal of a factor, the first row of a solve) and returns.
//
// solve_fill_kernel — after the dense solves B2 and B3 and the band solves
//   B7 and B12.  Their plain versions solve strips of H rows with masked
//   recurrences and couple the strips by unmasked products: a non-finite
//   value in a strip turns the whole strip NaN, and every product with it
//   turns NaN every row it reaches, which is each row above it in the
//   backward sweep.  So per column the rows up to the end of the strip that
//   holds the last non-finite row come out NaN: H = n for B2 (one recurrence
//   over n), B for B3, the plain version's window strip for B7 and B12.  In
//   the kernels' own result the non-finite rows of a column are a prefix
//   0..r: each row's sum takes every later row's value (zero factor entries
//   too, and 0 * inf is NaN), so a non-finite row makes every row above it
//   non-finite.  So the pass reads row 0 and, only where that is not finite,
//   looks for r.  A warp per (system, tile of 32 columns), folded into
//   blockIdx.x.  B10's kernels apply the same rule (H = n) as they write x
//   (csrc/batched_lu.cu).
//
// lu_spread_kernel — after the batched unblocked factor B9: NaN left of a
//   row whose last multiplier is not finite, then NaN above a column whose
//   last pivot-row entry is not finite (the rule of csrc/legacy_lu.cu's walk
//   for B17).  A block per system.
//
// lu_replay_kernel — after the blocked factor B1.  Its plain version
//   (core/blocked.py:fused_lu_steps) masks the strips of its (B, C2)
//   blocking and not the products between them, and a NaN a strip spreads is
//   read again by the products after it, so no rule on the result alone
//   gives the pattern.  The pass replays the plain version's steps on the
//   kernel's result in place, propagating NaN only: an operation whose
//   operands hold a NaN makes its output NaN, and a masked step whose
//   trigger is not finite turns its dead entries NaN.  Every other entry
//   keeps the kernel's value, which has the plain version's non-finite
//   pattern wherever no NaN reached it (the sums hold the same terms).
//   One cooperative launch over the grid; it returns at once where the
//   factor's diagonal is finite.  tests/test_torch_nonfinite.py:lu_replay
//   emulates its loops against core/blocked.py:fused_lu_steps.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {  // each source that includes this keeps its own copy
namespace nonfinite {

namespace cg = cooperative_groups;

constexpr int kFillCols = 32;  // a warp: a lane a column
constexpr int kSpreadThreads = 256;
constexpr int kReplayThreads = 512;
constexpr int kReplayRows = 64;  // rows of the matrix a replay block at least (the grid's size)

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }

// x: (systems, n, m) row-major; block b (one warp) takes columns
// (b % tiles) * 32 ... of system b / tiles.
__global__ void __launch_bounds__(kFillCols) solve_fill_kernel(float* x, int n, int m, int H, int tiles) {
  const size_t sys = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * kFillCols, w = min(kFillCols, m - c0), lane = threadIdx.x;
  float* xs = x + sys * n * m + c0;
  unsigned bad = __ballot_sync(0xffffffffu, lane < w && !isfinite(__ldcg(xs + lane)));
  while (bad) {  // a column whose row 0 is not finite: its last non-finite row r, then rows 0 .. its strip's end
    const int j = __ffs(bad) - 1;
    bad &= bad - 1;
    int r = 0;
    for (int i = lane; i < n; i += kFillCols)
      if (!isfinite(__ldcg(xs + (size_t)i * m + j))) r = i;
    r = __reduce_max_sync(0xffffffffu, r);
    const int end = min(n, (r / H + 1) * H);
    for (int i = lane; i < end; i += kFillCols) xs[(size_t)i * m + j] = qnan();
  }
}

// a: (systems, n, n) packed no-pivot factors from live-row steps.
__global__ void __launch_bounds__(kSpreadThreads) lu_spread_kernel(float* a, int n) {
  float* s = a + (size_t)blockIdx.x * n * n;
  bool bad = false;
  for (int i = threadIdx.x; i < n; i += kSpreadThreads) bad |= !isfinite(s[(size_t)i * n + i]);
  if (!__syncthreads_or(bad)) return;
  // the two rules touch the strict lower and the strict upper part, and
  // read the sub- and the superdiagonal, which neither writes
  for (int r = 2 + threadIdx.x; r < n; r += kSpreadThreads)
    if (!isfinite(s[(size_t)r * n + r - 1]))
      for (int j = 0; j < r - 1; ++j) s[(size_t)r * n + j] = qnan();
  for (int j = 1 + threadIdx.x; j < n; j += kSpreadThreads)
    if (!isfinite(s[(size_t)(j - 1) * n + j]))
      for (int i = 0; i < j; ++i) s[(size_t)i * n + j] = qnan();
}

// ---------------------------------------------------------------------------
// lu_replay_kernel: core/blocked.py:fused_lu_steps with NaN propagation only,
// on the unpadded (n, n) result (the plain version's identity tail never
// reaches a real entry).  One cooperative launch of G blocks: per diagonal
// strip, block 0 replays the strip's pivots (a block barrier a phase), then
// the grid replays the strip's column trsm and the row strips below it
// (threads apart), then its products; then per strip the trailing columns'
// trsm and the products below it, and last the step's trailing product, a
// grid barrier after each phase.  A product's blocks take 128 x 128 output
// tiles.  Loads bypass L1 (__ldcg): another block may have written the entry
// since the last grid barrier.
// ---------------------------------------------------------------------------
struct Replay {
  float* a;
  int n, B, C2;
  __device__ float ld(int i, int j) const { return __ldcg(a + (size_t)i * n + j); }
  __device__ void nan(int i, int j) const { a[(size_t)i * n + j] = qnan(); }
};

__device__ __forceinline__ int grid_thread() { return blockIdx.x * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int grid_threads() { return gridDim.x * blockDim.x; }

// factor_diag_strip: pivots c = r0 .. sc-1, rows [base, end); one block.
__device__ void replay_diag_strip(const Replay& p, int base, int end, int r0, int sc) {
  for (int c = r0; c < sc; ++c) {
    const bool pivnan = isnan(p.ld(c, c));
    for (int i = c + 1 + threadIdx.x; i < end; i += blockDim.x) {
      const bool lb = pivnan || isnan(p.ld(i, c));
      if (lb) p.nan(i, c);
      for (int c2 = c + 1; c2 < sc; ++c2)
        if (lb || isnan(p.ld(c, c2))) p.nan(i, c2);
      if (!isfinite(p.ld(i, c)))
        for (int c2 = r0; c2 < c; ++c2) p.nan(i, c2);
    }
    __syncthreads();
    for (int c2 = c + 1 + threadIdx.x; c2 < sc; c2 += blockDim.x)
      if (!isfinite(p.ld(c, c2)))
        for (int i = base; i <= c; ++i) p.nan(i, c2);
    __syncthreads();
  }
}

// solve_below_strip on row i against pivots c = r0 .. sc-1.
__device__ void replay_below_row(const Replay& p, int i, int r0, int sc) {
  for (int c = r0; c < sc; ++c) {
    const bool lb = isnan(p.ld(i, c)) || isnan(p.ld(c, c));
    if (lb) p.nan(i, c);
    for (int c2 = c + 1; c2 < sc; ++c2)
      if (lb || isnan(p.ld(c, c2))) p.nan(i, c2);
    if (!isfinite(p.ld(i, c)))
      for (int c2 = r0; c2 < c; ++c2) p.nan(i, c2);
  }
}

// strip_trsm on column col, rows [r0, re), against the strip's L.
__device__ void replay_trsm_column(const Replay& p, int col, int r0, int re) {
  const int steps = min(p.C2 - 1, p.n - r0);
  for (int k = 0; k < steps; ++k) {
    const int q = r0 + k;
    const float u = p.ld(q, col);
    for (int i = q + 1; i < re; ++i)
      if (isnan(u) || isnan(p.ld(i, q))) p.nan(i, col);
    if (!isfinite(u))
      for (int i = r0; i <= q; ++i) p.nan(i, col);
  }
}

constexpr int kReplayTile = 128;  // a product's output tile: rows and columns

// An unmasked product into rows [rl, rh) x columns [cl, ch) over k in
// [kl, kh): an output is NaN where its row of the left operand or its
// column of the right one holds a NaN.  Output tiles over the grid's blocks.
__device__ void replay_product(const Replay& p, bool* rf, bool* cf, int rl, int rh, int cl, int ch, int kl, int kh) {
  if (rl >= rh || cl >= ch || kl >= kh) return;
  const int tc = (ch - cl + kReplayTile - 1) / kReplayTile, tiles = (rh - rl + kReplayTile - 1) / kReplayTile * tc;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i0 = rl + tile / tc * kReplayTile, c0 = cl + tile % tc * kReplayTile;
    const int h = min(kReplayTile, rh - i0), w = min(kReplayTile, ch - c0);
    for (int r = threadIdx.x; r < h; r += blockDim.x) {
      bool f = false;
      for (int k = kl; k < kh && !f; ++k) f = isnan(p.ld(i0 + r, k));
      rf[r] = f;
    }
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      bool f = false;
      for (int k = kl; k < kh && !f; ++k) f = isnan(p.ld(k, c0 + c));
      cf[c] = f;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
      const int r = idx / w, c = idx % w;
      if (rf[r] || cf[c]) p.nan(i0 + r, c0 + c);
    }
    __syncthreads();
  }
}

// The same steps where a strip is at most 64 columns wide and a block at
// most 256 rows (the plain blocking at n >= 256: C2 = 32, B = 128): an entry
// of a strip's columns is a bit of its row's (or column's) NaN and
// non-finite masks, loaded once with independent loads, so a pivot's rules
// are a few mask operations.  Bit j: column (or row) r0 + j.
using Mask = unsigned long long;
constexpr int kMaskCols = 64;
constexpr int kMaskRows = 256;

__device__ __forceinline__ Mask bits_above(int j) { return j >= 63 ? 0ull : ~0ull << (j + 1); }
__device__ __forceinline__ Mask bits_below(int j) { return (1ull << j) - 1; }
__device__ __forceinline__ Mask bits_upto(int w) { return w >= 64 ? ~0ull : (1ull << w) - 1; }

// Row i's NaN and non-finite masks over columns [r0, r0 + w).
__device__ __forceinline__ void load_row(const Replay& p, int i, int r0, int w, Mask& nanm, Mask& nonf) {
  nanm = nonf = 0;
  for (int j = 0; j < w; ++j) {
    const float v = p.ld(i, r0 + j);
    nanm |= (Mask)isnan(v) << j;
    nonf |= (Mask)!isfinite(v) << j;
  }
}

__device__ __forceinline__ void store_row(const Replay& p, int i, int r0, Mask nanm) {
  for (; nanm; nanm &= nanm - 1) p.nan(i, r0 + __ffsll(nanm) - 1);
}

// The strip's diagonal block, rows and columns [r0, r0 + w): up[j] the NaN
// mask of row j, lo[k] that of column k (bit i: row i).
__device__ void strip_masks(const Replay& p, int r0, int w, Mask* up, Mask* lo) {
  __syncthreads();  // the block is done with the last strip's masks
  for (int t = threadIdx.x; t < 2 * w; t += blockDim.x) {
    Mask m = 0;
    if (t < w) {
      for (int j = 0; j < w; ++j) m |= (Mask)isnan(p.ld(r0 + t, r0 + j)) << j;
      up[t] = m;
    } else {
      for (int i = 0; i < w; ++i) m |= (Mask)isnan(p.ld(r0 + i, r0 + t - w)) << i;
      lo[t - w] = m;
    }
  }
  __syncthreads();
}

// replay_below_row on masks: the pivots' rows in up.
__device__ __forceinline__ void mask_against_pivots(Mask& nanm, Mask& nonf, int w, const Mask* up) {
  const Mask all = bits_upto(w);
  for (int j = 0; j < w; ++j) {
    const bool lb = ((nanm | up[j]) >> j) & 1;  // the entry or the pivot NaN
    nanm |= lb ? ((1ull << j) | bits_above(j)) & all : up[j] & bits_above(j);
    nonf |= nanm;
    if ((nonf >> j) & 1) nanm |= bits_below(j), nonf |= bits_below(j);
  }
}

// replay_diag_strip on masks, rows [base, end) (at most kMaskRows) in shared
// memory; one block.
__device__ void mask_diag_strip(const Replay& p, Mask* rn, Mask* rf, int base, int end, int r0, int sc) {
  const int w = sc - r0, all_rows = end - base;
  const Mask all = bits_upto(w);
  for (int r = threadIdx.x; r < all_rows; r += blockDim.x) load_row(p, base + r, r0, w, rn[r], rf[r]);
  __syncthreads();
  for (int j = 0; j < w; ++j) {
    const int pr = r0 + j - base;
    const Mask pn = rn[pr], pf = rf[pr];
    for (int r = pr + 1 + threadIdx.x; r < all_rows; r += blockDim.x) {  // the rows below the pivot
      Mask nanm = rn[r], nonf = rf[r];
      const bool lb = ((nanm | pn) >> j) & 1;
      nanm |= lb ? ((1ull << j) | bits_above(j)) & all : pn & bits_above(j);
      nonf |= nanm;
      if ((nonf >> j) & 1) nanm |= bits_below(j), nonf |= bits_below(j);
      rn[r] = nanm;
      rf[r] = nonf;
    }
    __syncthreads();
    const Mask up = pf & bits_above(j) & all;  // columns whose pivot-row entry is not finite: NaN above
    for (int r = threadIdx.x; r <= pr; r += blockDim.x) rn[r] |= up, rf[r] |= up;
    __syncthreads();
  }
  for (int r = threadIdx.x; r < all_rows; r += blockDim.x) store_row(p, base + r, r0, rn[r]);
}

// replay_trsm_column on masks: column col, rows [r0, r0 + w), the strip's L in lo.
__device__ __forceinline__ void mask_trsm_column(const Replay& p, int col, int r0, int w, const Mask* lo) {
  Mask nanm = 0, nonf = 0;
  for (int i = 0; i < w; ++i) {
    const float v = p.ld(r0 + i, col);
    nanm |= (Mask)isnan(v) << i;
    nonf |= (Mask)!isfinite(v) << i;
  }
  const Mask all = bits_upto(w);
  const int steps = min(p.C2 - 1, p.n - r0);
  for (int k = 0; k < steps; ++k) {
    const bool un = (nanm >> k) & 1, uf = (nonf >> k) & 1;
    nanm |= un ? bits_above(k) & all : lo[k] & bits_above(k);
    nonf |= nanm;
    if (uf) nanm |= bits_below(k + 1), nonf |= bits_below(k + 1);
  }
  for (; nanm; nanm &= nanm - 1) p.nan(r0 + __ffsll(nanm) - 1, col);
}

__global__ void __launch_bounds__(kReplayThreads) lu_replay_kernel(float* a, int n, int B, int C2) {
  __shared__ bool rf[kReplayTile], cf[kReplayTile];
  __shared__ Mask up[kMaskCols], lo[kMaskCols], rows_nan[kMaskRows], rows_nonf[kMaskRows];
  cg::grid_group grid = cg::this_grid();
  const Replay p{a, n, B, C2};
  bool bad = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) bad |= !isfinite(p.ld(i, i));
  if (!__syncthreads_or(bad)) return;  // the same answer in every block
  const int S = (n + B - 1) / B, t = grid_thread(), T = grid_threads();
  const bool masks = C2 <= kMaskCols && B <= kMaskRows;
  for (int s = 0; s < S; ++s) {
    const int base = s * B, end = min(base + B, n);
    for (int j = 0; j < B && base + j < n; j += C2) {  // the panel, a strip at a time
      const int r0 = base + j, sc = min(r0 + C2, n), w = sc - r0;
      const bool inpanel = j + C2 < B;
      if (blockIdx.x == 0) {
        if (masks) mask_diag_strip(p, rows_nan, rows_nonf, base, end, r0, sc);
        else replay_diag_strip(p, base, end, r0, sc);
      }
      grid.sync();
      if (masks) strip_masks(p, r0, w, up, lo);
      if (inpanel)  // the strip's rows of the panel's later columns
        for (int col = r0 + C2 + t; col < end; col += T) {
          if (masks) mask_trsm_column(p, col, r0, w, lo);
          else replay_trsm_column(p, col, r0, sc);
        }
      for (int i = end + t; i < n; i += T) {  // the row strips below
        if (masks) {
          Mask nanm, nonf;
          load_row(p, i, r0, w, nanm, nonf);
          mask_against_pivots(nanm, nonf, w, up);
          store_row(p, i, r0, nanm);
        } else {
          replay_below_row(p, i, r0, sc);
        }
      }
      grid.sync();
      // the panel's product, in the diagonal block and the row blocks below
      if (inpanel) replay_product(p, rf, cf, r0 + C2, n, r0 + C2, end, r0, sc);
      grid.sync();
    }
    if (end == n) break;
    for (int j = 0; j < B && base + j < n; j += C2) {  // the trailing columns, a strip at a time
      const int r0 = base + j, sc = min(r0 + C2, n), w = sc - r0;
      if (masks) strip_masks(p, r0, w, up, lo);
      for (int col = end + t; col < n; col += T) {
        if (masks) mask_trsm_column(p, col, r0, w, lo);
        else replay_trsm_column(p, col, r0, sc);
      }
      grid.sync();
      if (j + C2 < B) {
        replay_product(p, rf, cf, r0 + C2, end, end, n, r0, sc);
        grid.sync();
      }
    }
    replay_product(p, rf, cf, end, n, end, n, base, end);  // the step's trailing product
    grid.sync();
  }
}

// Each launcher below adds its launch, where it makes one, to *launches:
// the pass is one of its kernel's launches.

// Launch the solve pass on `systems` (n, m) results in x, strips of H rows.
inline cudaError_t launch_solve_fill(float* x, long long systems, int n, int m, int H, cudaStream_t stream,
                                     int* launches) {
  if (systems < 1 || n < 1 || m < 1) return cudaSuccess;
  const int tiles = (m + kFillCols - 1) / kFillCols;
  if (systems * tiles > INT_MAX || H < 1) return cudaErrorInvalidValue;
  solve_fill_kernel<<<(unsigned)(systems * tiles), kFillCols, 0, stream>>>(x, n, m, H, tiles);
  ++*launches;
  return cudaGetLastError();
}

inline cudaError_t launch_lu_spread(float* a, int systems, int n, cudaStream_t stream, int* launches) {
  if (systems < 1 || n < 3) return cudaSuccess;
  lu_spread_kernel<<<systems, kSpreadThreads, 0, stream>>>(a, n);
  ++*launches;
  return cudaGetLastError();
}

// B, C2: the plain version's blocking (core/blocked.py:fused_block_size,
// sub_block_width).  One cooperative launch of up to a block per SM.
inline cudaError_t launch_lu_replay(float* a, int n, int B, int C2, cudaStream_t stream, int* launches) {
  if (n < 2) return cudaSuccess;
  if (B < 1 || C2 < 1 || C2 > B || B % C2) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lu_replay_kernel, kReplayThreads, 0))) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = min(sms, (n + kReplayRows - 1) / kReplayRows);
  void* args[] = {&a, &n, &B, &C2};
  if ((err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lu_replay_kernel), dim3(blocks),
                                         dim3(kReplayThreads), args, 0, stream)))
    return err;
  ++*launches;
  return cudaSuccess;
}

}  // namespace nonfinite
}  // namespace
