// Forward (unit-lower) and backward (upper) substitution on a packed no-pivot
// LU, fp32, for Hopper (sm_90a).
//
// solve_vmem_kernel — replaces src/repro/kernels/trsm.py:solve_vmem.
//   One block per RHS tile.  The block's (n, rt) RHS tile lives in shared
//   memory (column-major, so a row sweep is free of bank conflicts); the
//   packed LU is read from L2.  The column-oriented sweep of the TPU kernel
//   would read the row-major LU down a column, one 32-byte sector per
//   element.  Instead the sweep goes in 32-row strips: one warp per RHS
//   column solves the strip's (32, 32) triangle with each lane holding one
//   row in a register and the solved value passed by __shfl_sync, then every
//   thread retires one row below (above, backward) the strip with a 32-wide
//   dot product whose LU row segment is one 128-byte line.  Bound: the LU's
//   n^2 * 4 bytes, read once per RHS tile; at small n the 2 * n/32 strip
//   steps (each a barrier) bound it instead.
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
#include "pdl.cuh"

namespace {

constexpr int kStrip = 32;    // strip height of solve_vmem and of a step's diagonal solve

extern __shared__ __align__(16) float smem[];  // 16 bytes for cp.async and float4

// ---------------------------------------------------------------------------
// solve_vmem
// ---------------------------------------------------------------------------
__global__ void solve_vmem_kernel(const float* __restrict__ lu, const float* __restrict__ b,
                                  float* __restrict__ x, int n, int m, int rt) {
  float* ys = smem;  // rt columns of n32 rows: ys[c * n32 + i]
  const int n32 = (n + kStrip - 1) / kStrip * kStrip;
  const int c0 = blockIdx.x * rt;
  const int w = min(rt, m - c0);
  for (int idx = threadIdx.x; idx < w * n32; idx += blockDim.x) {
    const int c = idx / n32, i = idx % n32;
    ys[idx] = i < n ? b[(size_t)i * m + c0 + c] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  // forward: L y = b, unit diagonal
  for (int k0 = 0; k0 < n; k0 += kStrip) {
    const int row = k0 + lane;
    float lr[kStrip];
#pragma unroll
    for (int l = 0; l < kStrip; ++l) lr[l] = (row < n && l < lane) ? lu[(size_t)row * n + k0 + l] : 0.f;
    for (int c = warp; c < w; c += nwarps) {
      float yr = ys[c * n32 + row];
#pragma unroll
      for (int l = 0; l < kStrip - 1; ++l) yr -= lr[l] * __shfl_sync(0xffffffffu, yr, l);
      ys[c * n32 + row] = yr;
    }
    __syncthreads();
    for (int i = k0 + kStrip + threadIdx.x; i < n; i += blockDim.x) {
      float li[kStrip];
#pragma unroll
      for (int l = 0; l < kStrip; ++l) li[l] = lu[(size_t)i * n + k0 + l];
      for (int c = 0; c < w; ++c) {
        const float* yk = ys + c * n32 + k0;
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < kStrip; ++l) acc += li[l] * yk[l];
        ys[c * n32 + i] -= acc;
      }
    }
    __syncthreads();
  }

  // backward: U x = y, diagonal division included
  for (int k0 = (n - 1) / kStrip * kStrip; k0 >= 0; k0 -= kStrip) {
    const int row = k0 + lane;
    float ur[kStrip];
#pragma unroll
    for (int l = 0; l < kStrip; ++l)
      ur[l] = (row < n && l > lane && k0 + l < n) ? lu[(size_t)row * n + k0 + l] : 0.f;
    const float piv = row < n ? lu[(size_t)row * n + row] : 1.f;
    for (int c = warp; c < w; c += nwarps) {
      float xr = ys[c * n32 + row];
#pragma unroll
      for (int l = kStrip - 1; l >= 0; --l) {
        if (lane == l) xr /= piv;
        xr -= ur[l] * __shfl_sync(0xffffffffu, xr, l);
      }
      ys[c * n32 + row] = xr;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k0; i += blockDim.x) {
      float ui[kStrip];
#pragma unroll
      for (int l = 0; l < kStrip; ++l) ui[l] = k0 + l < n ? lu[(size_t)i * n + k0 + l] : 0.f;
      for (int c = 0; c < w; ++c) {
        const float* xk = ys + c * n32 + k0;
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < kStrip; ++l) acc += ui[l] * xk[l];
        ys[c * n32 + i] -= acc;
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < w * n; idx += blockDim.x) {
    const int i = idx / w, c = idx % w;
    x[(size_t)i * m + c0 + c] = ys[c * n32 + i];
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
  int rows, chunk;    // rows of the product; rows per block (blockIdx.x)
  int depth;          // columns of `a`, rows of xk
  const float* xk;    // the (depth, m) right operand, row stride m
  const float* diag;  // the diagonal tile a head solves against, row stride lda
  float* solved;      // where a head launch writes the solved xk (row stride m)
  const float* src;   // the rows updated (row stride m), or null
  float* dst;
  int m, tile;        // RHS width; RHS columns per block (blockIdx.y)
  int vec;            // rows of `a` and `diag` start 16-byte aligned and depth % 4 == 0
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
  const int c0 = blockIdx.y * s.tile;
  const int w = min(s.tile, s.m - c0);
  const int r0 = blockIdx.x * s.chunk;
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
            if (ty + kTy * i < R && 4 * tx + j < w) old[i][j] = __ldcg(row0 + (ty + kTy * i) * s.m + 4 * tx + j);
      } else if (warp + 8 * (lane / kJ) < R && lane % kJ < w) {
        old[0][0] = __ldcg(row0 + (warp + 8 * (lane / kJ)) * s.m + lane % kJ);
      }
    }
    if constexpr (kSolve) {
      solve_head<kHead, BN>(xs, ring, s.diag, s.lda, kc, w, s.vec);
      // the solved block out, rows blockIdx.x, blockIdx.x + gridDim.x, ...
      const int mine = blockIdx.x < kc ? (kc - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
      for (int idx = threadIdx.x; idx < mine * w; idx += kThreads) {
        const int i = blockIdx.x + (idx / w) * gridDim.x, c = idx % w;
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
          out0[(ty + kTy * i) * s.m + 4 * tx + j] = update ? old[i][j] - acc[i][j] : acc[i][j];
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
    if (warp + 8 * i < R && j < w) out0[(warp + 8 * i) * s.m + j] = update ? old[0][0] - v1[0] : v1[0];
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

// The shared memory attributes of the step kernels, set once per device
// (device_sms).
cudaError_t allow_steps_smem() {
  cudaError_t err;
  if ((err = allow_variant<kNarrow>())) return err;
  return allow_variant<kWide>();
}

// Launches the steps of one solve on `stream`, counting them in *launches.
// Every launch after the first is a programmatic dependent launch: it may
// start while the step before it runs (see allow_next_step).  The first
// waits for whatever ran before it in full, since that may have written the
// factor.
struct Sweep {
  cudaStream_t stream;
  int* launches;
  int m, tile, tiles, sms;

  // One launch of s over equal row chunks: about one block per SM over the
  // column tiles, each chunk of rmin..kRows rows.
  template <int kHead>
  cudaError_t run(Step s, int rmin) {
    const int per_tile = (sms + tiles - 1) / tiles;
    int chunk = (s.rows + per_tile - 1) / per_tile;
    chunk = min(kRows, max(rmin, chunk));
    const int blocks = s.rows > 0 ? (s.rows + chunk - 1) / chunk : 1;
    s.chunk = s.rows > 0 ? (s.rows + blocks - 1) / blocks : 1;
    s.m = m;
    s.tile = tile;
    s.vec = aligned(s.a) && aligned(s.diag) && s.lda % 4 == 0 && s.depth % 4 == 0;
    const int bn = tile <= kNarrow ? kNarrow : kWide;
    const size_t smem = step_smem(bn, kHead != kNoHead);
    const bool chained = *launches > 0;
    cudaError_t err = bn == kNarrow
        ? launch_step(step_kernel<kNarrow, kHead>, dim3(blocks, tiles), dim3(kThreads), smem, stream, chained, s)
        : launch_step(step_kernel<kWide, kHead>, dim3(blocks, tiles), dim3(kThreads), smem, stream, chained, s);
    if (!err) ++*launches;
    return err;
  }
};

}  // namespace

// x = (LU)^-1 b for packed row-major lu (n, n), b and x (n, m) row-major.
// One block of `threads` per tile of `rt` RHS columns.
extern "C" int ebv_solve_vmem(const void* lu, const void* b, void* x, int n, int m, int rt,
                              int threads, void* stream) {
  const int n32 = (n + kStrip - 1) / kStrip * kStrip;
  const size_t bytes = (size_t)rt * n32 * sizeof(float);
  cudaError_t err = allow_smem(solve_vmem_kernel, bytes);
  if (err) return err;
  solve_vmem_kernel<<<(m + rt - 1) / rt, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lu), static_cast<const float*>(b), static_cast<float*>(x), n, m, rt);
  return cudaGetLastError();
}

// Same solve with (B, B) LU tiles, B <= 128, S = ceil(n / B): one launch per
// diagonal step, 2S in all, counted in *launches.  RHS columns go in tiles
// of `tile` (<= 64); y is an (n, m) scratch buffer.
extern "C" int ebv_solve_tiled(const void* lu_ptr, const void* b_ptr, void* x_ptr, void* y_ptr, int n,
                               int m, int B, int tile, void* stream, int* launches) {
  *launches = 0;
  if (B < 1 || B > kHeadDepth || tile < 1 || tile > kWide) return cudaErrorInvalidValue;
  if (n < 1 || m < 1) return 0;
  const float* lu = static_cast<const float*>(lu_ptr);
  const float* b = static_cast<const float*>(b_ptr);
  float* x = static_cast<float*>(x_ptr);
  float* y = static_cast<float*>(y_ptr);
  Sweep sw{static_cast<cudaStream_t>(stream), launches, m, tile, (m + tile - 1) / tile, 0};
  cudaError_t err = device_sms<allow_steps_smem>(&sw.sms);
  if (err) return err;
  const int S = (n + B - 1) / B;
  for (int k = 0; k < S; ++k) {  // L y = b: block k solved into y, rows below retired in x
    const size_t kb = (size_t)k * B;
    const int kw = min(B, n - (int)kb), r0 = (int)kb + kw;
    const float* cur = k ? x : b;
    Step s{lu + (size_t)r0 * n + kb, n, n - r0, 0, kw, cur + kb * m, lu + kb * n + kb, y + kb * m,
           cur + (size_t)r0 * m, x + (size_t)r0 * m};
    if ((err = sw.run<kLowerHead>(s, kRows / 2))) return err;
  }
  for (int k = S - 1; k >= 0; --k) {  // U x = y: block k solved into x, rows above retired in y
    const size_t kb = (size_t)k * B;
    const int kw = min(B, n - (int)kb);
    Step s{lu + kb, n, (int)kb, 0, kw, y + kb * m, lu + kb * n + kb, x + kb * m, y, y};
    if ((err = sw.run<kUpperHead>(s, kRows / 2))) return err;
  }
  return 0;
}

// Same solve from the (S', B, B) inverses (S' >= ceil(n / B)) of the
// identity-padded LU's diagonal blocks: per step one launch for the inverse
// product and one for the retirement, 4S-2 in all (S = ceil(n / B)), counted
// in *launches.  Only the inverses' leading (kw, kw) corner is read: past n
// they are the identity acting on zero rows.
extern "C" int ebv_solve_inverted(const void* lu_ptr, const void* linv_ptr, const void* uinv_ptr,
                                  const void* b_ptr, void* x_ptr, void* y_ptr, int n, int m, int B,
                                  int tile, void* stream, int* launches) {
  *launches = 0;
  if (B < 1 || tile < 1 || tile > kWide) return cudaErrorInvalidValue;
  if (n < 1 || m < 1) return 0;
  const float* lu = static_cast<const float*>(lu_ptr);
  const float* linv = static_cast<const float*>(linv_ptr);
  const float* uinv = static_cast<const float*>(uinv_ptr);
  const float* b = static_cast<const float*>(b_ptr);
  float* x = static_cast<float*>(x_ptr);
  float* y = static_cast<float*>(y_ptr);
  Sweep sw{static_cast<cudaStream_t>(stream), launches, m, tile, (m + tile - 1) / tile, 0};
  cudaError_t err = device_sms<allow_steps_smem>(&sw.sms);
  if (err) return err;
  const int S = (n + B - 1) / B;
  const size_t bb = (size_t)B * B;
  const int rmin = tile > kNarrow ? 16 : 8;
  for (int k = 0; k < S; ++k) {  // y_k = linv[k] cur_k; x[below] = cur[below] - L y_k
    const size_t kb = (size_t)k * B;
    const int kw = min(B, n - (int)kb), r0 = (int)kb + kw;
    const float* cur = k ? x : b;
    Step inv{linv + k * bb, B, kw, 0, kw, cur + kb * m, nullptr, nullptr, nullptr, y + kb * m};
    if ((err = sw.run<kNoHead>(inv, rmin))) return err;
    if (r0 == n) break;
    Step ret{lu + (size_t)r0 * n + kb, n, n - r0, 0, kw, y + kb * m, nullptr, nullptr,
             cur + (size_t)r0 * m, x + (size_t)r0 * m};
    if ((err = sw.run<kNoHead>(ret, rmin))) return err;
  }
  for (int k = S - 1; k >= 0; --k) {  // x_k = uinv[k] y_k; y[above] -= U x_k
    const size_t kb = (size_t)k * B;
    const int kw = min(B, n - (int)kb);
    Step inv{uinv + k * bb, B, kw, 0, kw, y + kb * m, nullptr, nullptr, nullptr, x + kb * m};
    if ((err = sw.run<kNoHead>(inv, rmin))) return err;
    if (!kb) break;
    Step ret{lu + kb, n, (int)kb, 0, kw, x + kb * m, nullptr, nullptr, y, y};
    if ((err = sw.run<kNoHead>(ret, rmin))) return err;
  }
  return 0;
}
