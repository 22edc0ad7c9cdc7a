// Blocked no-pivot EbV LU factorization for Hopper (sm_90a), fp32, in place.
//
// Replaces: src/repro/kernels/ebv_lu.py:lu_fused, the single-dispatch Pallas
// megakernel whose grid (step s, program p) relied on the TPU running grid
// programs in order: program 0 of step s factored the panel into scratch
// that every later program of the step read.  CUDA blocks run in no order,
// so here each step of W <= 128 columns (a multiple of 4 past one step, so
// that the update's 16-byte copies start aligned) is a few launches in
// stream order on the caller's (n, n) matrix, row stride n:
//   diag_kernel    one block factors the (W, W) diagonal tile;
//   panel_kernel   L21 = A21 U11^-1 and U12 = L11^-1 A12 in one launch;
//   gemm_kernel    A22 -= L21 U12 (sgemm.cuh), in two launches with one step of
//                  lookahead: first the next step's block row and block
//                  column, then the rest of A22, which runs beside the
//                  next step's diagonal tile (the launch between them).
// That is 4S-4 launches for S = ceil(n / W) >= 2 steps (one for S = 1): the
// first diagonal tile, then per step but the last the panels, the next
// block row and column, the next diagonal tile and the rest (none after the
// last panels, where nothing is left), and for n >= 2 one launch of the
// non-finite pass (nonfinite.cuh).  The last step's tile may be
// narrower than W; the kernels mask it, so the matrix is never padded (the
// reference's identity tail is inert, and rows and columns past n simply do
// not exist here).  Every launch after the first is a programmatic
// dependent launch (pdl.cuh) and waits for the one before it before it
// reads anything of `a` or of the scratch, which every step rewrites; those
// reads go past L1.  The exception is the rest of A22: it reads nothing the
// diagonal tile writes, so it waits only at the end of its last block, and
// its completion implies the tile's for the panels after it; for that the
// diagonal tile signals its dependents only after its own wait, once the
// panels the rest reads are complete.
//
// What bounds each launch kind on this card:
//   - diag_kernel is one block on one SM of 132, a chain of W-1 pivots; it
//     bounds the latency of every step whose update is short.  The tile
//     lives in registers: 32 warps own 4 rows each, a lane 4 columns of
//     each (16 values a thread).  A pivot costs one block barrier: the row
//     that will be the next pivot row is published into one of two
//     shared-memory rows (with the reciprocal of its diagonal), so the
//     barrier of pivot k+1 also ends the reads of pivot k's buffer.  Each
//     warp owns the equalized pairs (q, 127-q) and (63-q, 64+q): row r
//     takes r updates, so each pair takes 127 and every warp the same 254,
//     and each warp holds one row in every band of 32 rows, so at a pivot in
//     band kb the bands below are skipped at compile time and the work per
//     pivot shrinks as evenly as the tile's.  This is the paper's eq.-7
//     pairing (core/ebv.py:equalized_pairing pairs the elimination vectors
//     r and n-2-r) applied to the tile's rows.  What remains bounds it: the
//     instructions every warp issues per pivot (shuffle, scale and masked
//     update of each live row) on one SM.
//   - panel_kernel solves each row of L21 and each column of U12 as an
//     independent chain of W steps: one warp takes 8 rows (or 8 adjacent
//     columns), a lane 4 elements of each, and carries each chain's solved
//     value to the lanes by __shfl_sync, with no barrier inside the chain.
//     Every block first stages the triangle it solves against into shared
//     memory once (U11 scaled by its reciprocal diagonal, or L11
//     transposed), all its loads in flight together.  Row and column groups
//     split evenly over about one block per SM.  Bound: the chain (~W
//     shuffle-and-FMA steps) at small n, the shuffles and FMAs issued per
//     SM at large n.  Both panels are also written, as (W, ldt) row-major
//     copies, to the scratch the update reads.
//   - the update is the SGEMM tile of sgemm.cuh, of depth W, bound by the
//     card's fp32 operations at large n: 128x128, 128x64 or 64x64 output
//     tiles, k-chunks of 16 copied by 16-byte cp.async into a two-stage
//     ring, the A22 tile copied into shared memory at the start.  L21
//     arrives transposed from the panel scratch, so both operands copy
//     straight into the ring as k-major rows.  The rest of A22 takes the
//     tile that splits it most evenly over the SMs, so the late, small
//     steps still fill the card; the block row and column take 64x64
//     tiles, many blocks of a short chain.
//
// The TPU kernel's eq.-7 fold (program p owns trailing tiles p+1 and S-1-p,
// so each program's lifetime work is the constant S) balances programs that
// persist across steps.  Here every step is its own launches and every
// block of a launch gets an equal share of that step, so the fold has
// nothing left to balance; the pairing lives in the diagonal tile instead.
//
// Summation order against the plain version (core/blocked.py:
// fused_lu_steps): the plain version factors each tile in 32-column strips,
// retiring each strip by a rank-32 product; this kernel factors the whole
// tile by W-1 rank-1 steps, solves the panels by rank-1 sweeps (the lower
// panel with U11's rows prescaled by their reciprocal pivot, divided out at
// the end as a product with the reciprocal), and sums each trailing update
// in k order 0..W-1 before subtracting it.  The results agree to fp32
// rounding, not bit for bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "async_copy.cuh"
#include "nonfinite.cuh"
#include "pdl.cuh"
#include "sgemm.cuh"

namespace {

constexpr int kTileMax = 128;            // widest step: the diagonal tile in registers
constexpr int kSlots = kTileMax / 32;    // columns a lane holds of each row
constexpr int kDiagThreads = 1024;       // 32 warps, 4 rows each
constexpr int kGroup = 8;                // panel rows (or columns) a warp solves together
constexpr int kPanelWarps = 16;
constexpr int kTld = kTileMax + 1;       // row stride of a staged triangle

extern __shared__ __align__(16) float smem[];

// f(std::integral_constant<int, kb>) for kb = 0 .. kSlots-1: a slot index
// known at compile time keeps the per-lane arrays in registers.
template <class F>
__device__ __forceinline__ void for_each_slot(F f) {
  static_assert(kSlots == 4, "four slots of 32 lanes");
  f(std::integral_constant<int, 0>{});
  f(std::integral_constant<int, 1>{});
  f(std::integral_constant<int, 2>{});
  f(std::integral_constant<int, 3>{});
}

// ---------------------------------------------------------------------------
// 1. the diagonal tile
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kDiagThreads, 1) diag_kernel(float* a, int n, int base, int w, float* rdiag) {
  __shared__ float prow[2][kTileMax];  // the pivot row, double-buffered
  __shared__ float prinv[2];           // and the reciprocal of its diagonal
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int rows[4] = {q, 63 - q, 64 + q, 127 - q};  // the pairs (q, 127-q), (63-q, 64+q)
  float* t = a + (size_t)base * n + base;
  float v[4][kSlots];
  wait_prior_step();
  allow_next_step();  // after the wait: the launch after this one relies on it (ebv_lu_fused)
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int j = 32 * c + lane;
      v[r][c] = rows[r] < w && j < w ? __ldcg(t + (size_t)rows[r] * n + j) : 0.f;
    }
  if (q == 0) {  // row 0 is the first pivot row
#pragma unroll
    for (int c = 0; c < kSlots; ++c) prow[0][32 * c + lane] = v[0][c];
    if (lane == 0) {
      prinv[0] = 1.f / v[0][0];
      if (rdiag) rdiag[0] = prinv[0];
    }
  }
  // Row r of a warp lies in band r (rows 32r .. 32r+31), so at a pivot of
  // slot kb the bands below kb are done: the loops start at kb, and the
  // work per pivot shrinks with the trailing tile.  No branch per row: the
  // finished rows of band kb are masked by predicates.
  for_each_slot([&](auto slot) {  // pivot k = 32*kb + kl: column k is slot kb of lane kl
    constexpr int kb = decltype(slot)::value;
    const int kend = min(32, w - 1 - 32 * kb);
    for (int kl = 0; kl < kend; ++kl) {
      const int k = 32 * kb + kl;
      float m[4];  // each row's entry in column k, final since pivot k-1
#pragma unroll
      for (int r = kb; r < 4; ++r) m[r] = __shfl_sync(0xffffffffu, v[r][kb], kl);
      __syncthreads();  // row k is published
      const int cur = k & 1;
      const float rp = prinv[cur];
      float u[kSlots];
#pragma unroll
      for (int c = kb; c < kSlots; ++c) u[c] = prow[cur][32 * c + lane];
      // row i -= l_i * row k on columns past k; l_i into column k
#pragma unroll
      for (int r = kb; r < 4; ++r) {
        const bool live = r > kb || rows[r] > k;
        const float l = m[r] * rp;
#pragma unroll
        for (int c = kb; c < kSlots; ++c)
          if (live && (c > kb || lane > kl)) v[r][c] = fmaf(-l, u[c], v[r][c]);
        if (live && lane == kl) v[r][kb] = l;
      }
      // publish row k+1: band kb, or band kb+1 after the slot's last pivot
#pragma unroll
      for (int r = kb; r < (kb + 2 < 4 ? kb + 2 : 4); ++r)
        if (rows[r] == k + 1) {
#pragma unroll
          for (int c = kb; c < kSlots; ++c) prow[cur ^ 1][32 * c + lane] = v[r][c];
          const float dkk = kl == 31 ? v[r][kb + 1 < kSlots ? kb + 1 : kb] : v[r][kb];
          if (lane == ((kl + 1) & 31)) {
            prinv[cur ^ 1] = 1.f / dkk;
            if (rdiag) rdiag[k + 1] = prinv[cur ^ 1];  // for the panels
          }
        }
    }
  });
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int j = 32 * c + lane;
      if (rows[r] < w && j < w) t[(size_t)rows[r] * n + j] = v[r][c];
    }
}

// ---------------------------------------------------------------------------
// 2. the panels
// ---------------------------------------------------------------------------
constexpr size_t kPanelSmem = (size_t)(kTileMax * kTld + kTileMax) * sizeof(float);

// Blocks [0, lower_blocks) solve rows of L21, the rest columns of U12; each
// warp of a block takes kGroup rows (columns), per_block warps a block.
// Every chain runs over W positions held as 4 slots of 32 lanes: position
// j = 32c + lane is slot c of that lane.  A lower chain solves x U11 = a:
// with T[k][j] = U11[k][j] / U11[k][k] it carries y (x = y / U11 diagonal,
// applied at the end); an upper chain solves L11 y = a with T[k][j] =
// L11[j][k].  `rdiag` holds the reciprocal diagonal of U11 (diag_kernel
// writes it); `lt` / `ut` take L21 transposed and U12, (W, ldt) row-major.
__global__ void __launch_bounds__(kPanelWarps * 32) panel_kernel(float* a, int n, int base, int w,
                                                                 const float* rdiag, float* lt, float* ut,
                                                                 int ldt, int lower_blocks, int per_block,
                                                                 int vec) {
  float* T = smem;                  // (kTileMax, kTld)
  float* d = T + kTileMax * kTld;   // reciprocal diagonal (lower), ones (upper)
  allow_next_step();
  const bool lower = blockIdx.x < lower_blocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = base + w, M = n - t0;
  const int g0 = kGroup * ((lower ? blockIdx.x : blockIdx.x - lower_blocks) * per_block + warp);
  const bool solves = warp < per_block && g0 < M;
  const float* d11 = a + (size_t)base * n + base;
  wait_prior_step();

  // the triangle once per block, every load in flight together: thread q of
  // a pass reads row q % 128 of the factored tile at columns lo .. lo+3 (a
  // float4 where aligned; none where T takes no entry of them), so that both
  // its stores into T, straight (lower) or transposed (upper), go to
  // consecutive banks across the lanes
  constexpr int kPasses = kTileMax * kTileMax / 4 / (kPanelWarps * 32);
  float4 tri[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int q = threadIdx.x + i * kPanelWarps * 32, hi = q % kTileMax, lo = 4 * (q / kTileMax);
    const float* p = d11 + (size_t)hi * n + lo;
    if (hi >= w || (lower ? lo + 3 <= hi : lo >= hi)) tri[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // not read
    else if (vec && lo + 3 < w) tri[i] = __ldcg(reinterpret_cast<const float4*>(p));
    else tri[i] = make_float4(lo < w ? __ldcg(p) : 0.f, lo + 1 < w ? __ldcg(p + 1) : 0.f,
                              lo + 2 < w ? __ldcg(p + 2) : 0.f, lo + 3 < w ? __ldcg(p + 3) : 0.f);
  }
  if (threadIdx.x < kTileMax) d[threadIdx.x] = lower && threadIdx.x < w ? __ldcg(rdiag + threadIdx.x) : 1.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int q = threadIdx.x + i * kPanelWarps * 32, hi = q % kTileMax, lo = 4 * (q / kTileMax);
    const float e[4] = {tri[i].x, tri[i].y, tri[i].z, tri[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (lower) T[hi * kTld + lo + c] = lo + c > hi ? e[c] * d[hi] : 0.f;  // k = hi, j = lo + c
      else T[(lo + c) * kTld + hi] = hi > lo + c ? e[c] : 0.f;               // k = lo + c, j = hi
    }
  }
  __syncthreads();
  if (!solves) return;

  // the group: rows t0+g0.. of A21 (lower) or columns t0+g0.. of A12
  const bool full = g0 + kGroup <= M;
  const bool wide = !lower && vec && full;  // 8 columns as two aligned float4s
  float v[kGroup][kSlots];
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int j = 32 * c + lane;
    if (wide) {
      const float* p = a + (size_t)(base + j) * n + t0 + g0;
      const float4 lo = j < w ? __ldcg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 hi = j < w ? __ldcg(reinterpret_cast<const float4*>(p + 4)) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0][c] = lo.x, v[1][c] = lo.y, v[2][c] = lo.z, v[3][c] = lo.w;
      v[4][c] = hi.x, v[5][c] = hi.y, v[6][c] = hi.z, v[7][c] = hi.w;
    } else {
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const bool ok = g0 + r < M && j < w;
        const float* p = lower ? a + (size_t)(t0 + g0 + r) * n + base + j : a + (size_t)(base + j) * n + t0 + g0 + r;
        v[r][c] = ok ? __ldcg(p) : 0.f;
      }
    }
  }
  for_each_slot([&](auto slot) {  // position k = 32*kb + kl: slot kb of lane kl
    constexpr int kb = decltype(slot)::value;
    const int kend = min(32, w - 1 - 32 * kb);
    float v0[kGroup];  // the slot before its steps, for the second solve below
#pragma unroll
    for (int r = 0; r < kGroup; ++r) v0[r] = v[r][kb];
#pragma unroll 4
    for (int kl = 0; kl < kend; ++kl) {
      const int k = 32 * kb + kl;
      float x[kGroup];  // each chain's solved position k
#pragma unroll
      for (int r = 0; r < kGroup; ++r) x[r] = __shfl_sync(0xffffffffu, v[r][kb], kl);
      const float* tk = T + k * kTld + lane;  // zero at positions <= k
#pragma unroll
      for (int c = kb; c < kSlots; ++c) {
        const float tc = tk[32 * c];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) v[r][c] = fmaf(-x[r], tc, v[r][c]);
      }
    }
    // T's zeros at the positions at and before k turn a non-finite solved x
    // into NaN there: a pattern of this kernel's tiles, not of the plain
    // version's strips (csrc/nonfinite.cuh replays those).  Where the slot
    // holds a non-finite value, solve it again on the positions past k only,
    // as the diagonal tile's rows: the same operations there, so the same
    // values, and the solved positions as they were solved.
    bool bad = false;
#pragma unroll
    for (int r = 0; r < kGroup; ++r) bad |= !isfinite(v[r][kb]);
    if (__any_sync(0xffffffffu, bad)) {
#pragma unroll
      for (int r = 0; r < kGroup; ++r) v[r][kb] = v0[r];
      for (int kl = 0; kl < kend; ++kl) {
        const float tc = T[(32 * kb + kl) * kTld + 32 * kb + lane];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float x = __shfl_sync(0xffffffffu, v[r][kb], kl);
          if (lane > kl) v[r][kb] = fmaf(-x, tc, v[r][kb]);
        }
      }
    }
  });
  if (lower)
#pragma unroll
    for (int c = 0; c < kSlots; ++c)
#pragma unroll
      for (int r = 0; r < kGroup; ++r) v[r][c] *= d[32 * c + lane];

  float* s = lower ? lt : ut;
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int j = 32 * c + lane;
    if (j >= w) continue;
    // the scratch row j, positions g0..g0+7 (past M: zeros into the padding)
    const float4 lo = make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
    const float4 hi = make_float4(v[4][c], v[5][c], v[6][c], v[7][c]);
    float4* p = reinterpret_cast<float4*>(s + (size_t)j * ldt + g0);
    p[0] = lo;
    p[1] = hi;
    if (wide) {
      float4* q = reinterpret_cast<float4*>(a + (size_t)(base + j) * n + t0 + g0);
      q[0] = lo;
      q[1] = hi;
    } else {
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
        if (g0 + r < M) {
          float* o = lower ? a + (size_t)(t0 + g0 + r) * n + base + j : a + (size_t)(base + j) * n + t0 + g0 + r;
          *o = v[r][c];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the trailing update (sgemm.cuh)
// ---------------------------------------------------------------------------
// A22 -= L21 U12 on rectangles r0, r1 of the (M, M) trailing matrix at
// (t0, t0), depth w: `lt` (L21 transposed) and `ut` (U12) are (w, ldt)
// row-major, ldt a multiple of 4 past every tile's last row and column.
// `vec`: n, t0 and the rectangles' edges are multiples of 4, so A22's rows
// are copied as float4s.
Gemm<float> trailing(float* a, int n, int t0, const float* lt, const float* ut, int ldt, int w, int vec) {
  float* c0 = a + (size_t)t0 * n + t0;
  return Gemm<float>{lt, ldt, ut, ldt, c0, c0, n, ldt, ldt, w, vec, 1, 1};
}

// The shared memory attributes, set once per device.
cudaError_t allow_kernels_smem() {
  cudaError_t err;
  if ((err = allow_smem(panel_kernel, kPanelSmem))) return err;
  return allow_gemm_smem<float, true>();
}

}  // namespace

extern "C" const char* ebv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Factor the (n, n) row-major fp32 matrix `a` in place, in steps of W
// columns (1 <= W <= 128; a multiple of 4 when n > W, since the update
// copies its operands from the scratch in 16-byte pieces at the step's
// offsets): 4S-4 launches on `stream` for S = ceil(n / W) >= 2 (one for
// S = 1), then for n >= 2 the non-finite pass, counted in *launches.
// `scratch` holds 2 * W * ldt + W floats (ldt a multiple of 4, at least
// n - W + 128; unused when n <= W): the panels' copies and the diagonal
// tile's reciprocal pivots.  pB, pC2: the plain
// version's block and strip (core/blocked.py), whose masked strips the pass
// after the steps follows on a non-finite factor (nonfinite.cuh).  Returns
// the first launch error, or 0.
extern "C" int ebv_lu_fused(void* a_ptr, int n, int W, void* scratch, int ldt, int pB, int pC2, void* stream_ptr,
                            int* launches) {
  *launches = 0;
  if (n < 1 || W < 1 || W > kTileMax) return cudaErrorInvalidValue;
  if (n > W && (W % 4 || ldt % 4 || ldt < n - W + kTileMax)) return cudaErrorInvalidValue;
  float* a = static_cast<float*>(a_ptr);
  float* lt = static_cast<float*>(scratch);
  float* ut = lt + (size_t)W * ldt;
  float* rdiag = n > W ? ut + (size_t)W * ldt : nullptr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int sms = 0;
  cudaError_t err = device_sms<allow_kernels_smem>(&sms);
  if (err) return err;
  const int vec = n % 4 == 0;
  const int S = (n + W - 1) / W;
  // the first launch waits for all before it in the stream: they wrote `a`
  if ((err = launch_step(diag_kernel, dim3(1), dim3(kDiagThreads), 0, stream, false, a, n, 0, min(W, n), rdiag)))
    return err;
  ++*launches;
  for (int s = 0; s + 1 < S; ++s) {
    const int t0 = (s + 1) * W, M = n - t0, wn = min(W, M);
    const int groups = (M + kGroup - 1) / kGroup;
    const int half = max(1, sms / 2);
    const int per_block = min(kPanelWarps, max(1, (groups + half - 1) / half));
    const int blocks = (groups + per_block - 1) / per_block;
    if ((err = launch_step(panel_kernel, dim3(2 * blocks), dim3(kPanelWarps * 32), kPanelSmem, stream, true, a, n,
                           s * W, W, rdiag, lt, ut, ldt, blocks, per_block, vec)))
      return err;
    ++*launches;
    // lookahead: the next step's block row and block column first, then its
    // diagonal tile beside the update of the rest
    const Gemm<float> g = trailing(a, n, t0, lt, ut, ldt, W, vec);
    if ((err = launch_gemm<float, true, 64, 64>(g, rect<64, 64>(0, 0, wn, M), rect<64, 64>(wn, 0, M - wn, wn), 0,
                                                true, stream)))
      return err;
    ++*launches;
    if ((err = launch_step(diag_kernel, dim3(1), dim3(kDiagThreads), 0, stream, true, a, n, t0, wn, rdiag)))
      return err;
    ++*launches;
    if (M > wn) {
      // the rest of A22, in the tile that splits it most evenly over the SMs
      if ((err = launch_gemm_rect<float, true>(g, wn, wn, M - wn, M - wn, sms, 1, true, stream))) return err;
      ++*launches;
    }
  }
  return nonfinite::launch_lu_replay(a, n, pB, pC2, stream, launches);
}
