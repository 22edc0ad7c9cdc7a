// Batched no-pivot EbV LU and its solve, fp32, for Hopper (sm_90a): many
// small independent (n, n) systems stacked as (B, n, n), the optimizer's
// preconditioner systems.  System s starts at s * n * n floats (its offset is
// computed in 64 bits: B * n^2 passes 2^31 at B = 2048 for n = 1024).
//
// batched_lu_staged_kernel, batched_lu_global_kernel,
// batched_lu_cluster_kernel — replace
//   src/repro/kernels/batched_lu.py:batched_lu_vmem, one grid program per
//   system holding it in VMEM and running the n-1 masked rank-1 steps of
//   kernels/ebv_lu.py:_lu_body.  IEEE round-to-nearest divide, multiply and
//   subtract with no contraction into fused multiply-adds give the plain
//   version's factor (repro_torch.core.batched.batched_ebv_lu) value for
//   value.  Bound: 2n^3/3 flops and 2 * n^2 * 4 bytes per system are
//   microseconds of work for the card, but the n-1 pivots are a dependent
//   chain.  Which kernel runs (batched_plan, mirrored by
//   kernels/batched_lu.py:batched_lu_plan):
//   - staged (n <= 240, the system fits one block's 227 KB): one block per
//     system walks it in shared memory, thread (x, y) owning the items
//     (i, j) of the trailing block with i = y and j = x (mod the block's
//     shape), one barrier per pivot; each thread divides the column-k entry
//     of its rows by the pivot itself (a division, as the reference does),
//     and the multipliers land in column k one pivot later, from a double
//     buffer, when no thread reads column k;
//   - cluster (n > 240 while the stack leaves SMs idle, B < #SMs): each
//     system on a thread-block cluster of 2-16 CTAs (the largest power of
//     two whose B clusters the card holds at once, cluster_room; else 2),
//     its rows owned by equalized pairs across the CTAs and kept in their
//     shared memory (csrc/ebv_walk.cuh; at (8, 1024), clusters of 8 on an
//     H100, the rows above theta = 357 keep columns [theta, n), the rest
//     streams through L2).  Pivot row k is read from its owner's shared memory
//     through DSMEM; the owner of row k+1 updates it first, and each pivot
//     waits on one split cluster barrier (arrive.release after that row,
//     wait.acquire before the next pivot), not on the whole block's walk;
//   - global (n > 240, B >= #SMs: one block per system already fills the
//     card): the staged kernel's walk in device memory, in L2 while few
//     systems run at once, each thread keeping kInFlight loads outstanding.
//
// batched_solve_wide_kernel, batched_solve_cluster_kernel — replace
//   src/repro/kernels/batched_lu.py:batched_lu_solve_vmem, one grid program
//   per system holding the whole (n, m) RHS beside the factor.  Both subtract
//   term by term in the plain version's order (y_i -= l_ik * y_k for
//   k = 0, 1, ...; backward x_k / u_kk, then x_i -= u_ik * x_k for
//   k = n-1, n-2, ...) with rounded multiply, subtract and divide and no
//   fused multiply-adds, so they are bitwise equal to
//   repro_torch.core.batched.batched_lu_solve.  Bound: 2n^2 m operations per
//   system; a separate multiply and subtract per term halve the card's fp32
//   rate.  Which kernel runs, with which tile and cluster, is
//   kernels/batched_lu.py:batched_solve_plan's choice; the C entry launches it:
//   - wide (the grid of RHS tiles x systems fills the card): one block of 256
//     threads per (tile of W = 4 ... 64 RHS columns, system), both folded
//     into blockIdx.x (system * tiles + tile: any number of systems, up to
//     2^31 - 1 blocks, fits the grid), the tile in shared memory (row-major,
//     stride W+4).  The sweep walks 32-column strips
//     of the factor: L below (forward) or U above (backward) the strip is
//     staged by 16-byte cp.async in chunks of up to 256 rows, double buffered
//     so the next chunk's copy overlaps this chunk's update; every warp
//     solves the strip's triangle in registers (a few lanes a column), and each
//     thread retires a micro-tile of up to 8 rows x 4 columns, reading the
//     factor and the solved strip as float4 from shared memory: three
//     shared-memory loads per 32 multiply-subtract pairs, so the update is
//     bound by the fp32 pipe, not by shared memory's;
//   - cluster (a few RHS columns on so few systems that the wide grid leaves
//     SMs idle, or systems too large for a wide block): each (system, tile of
//     <= 16 RHS columns) on a thread-block cluster of 2-16 CTAs
//     (csrc/cluster.cuh).  Strips are owned by the paper's equalized
//     pairs (strip s with strip S-1-s: forward s strips of terms, backward
//     S-1-s, the same work per pair), each CTA holding its strips' values in
//     shared memory.  A strip's owner solves its triangle (after retiring
//     the previous strip's terms from it first, the lookahead) and writes
//     the solved values into every CTA's shared memory through DSMEM behind
//     one split cluster barrier a strip; every CTA then retires its own rows
//     with them, reading its rows of the factor once through L2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "cluster.cuh"
#include "ebv_walk.cuh"
#include "nonfinite.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemBytes = 232448;  // dynamic shared memory one H100 block may use
constexpr int kInFlight = 4;        // row updates a factor thread loads before it stores
constexpr int kStrip = 32;          // strip height of the solve's sweeps
constexpr int kSolveThreads = 256;  // a wide solve block
constexpr int kLdl = kStrip + 4;    // a staged factor row: 32 floats, 16-byte aligned, no bank conflicts
constexpr int kChunkRows = 256;     // factor rows a wide block stages at once, at most
constexpr int kNarrowThreads = 512; // a CTA of the cluster solve
constexpr int kNarrowCols = 16;     // RHS columns of one cluster's tile, at most (a warp each)

extern __shared__ __align__(16) float smem[];  // 16 bytes for cp.async and float4

// Retire the n-1 pivots of the (n, n) matrix a (row stride n), one barrier
// per pivot; lbuf holds 2n floats (the multiplier double buffer).
__device__ void ebv_walk(float* a, int n, float* lbuf) {
  for (int k = 0; k < n - 1; ++k) {
    if (k > 0 && threadIdx.x == 0) {  // multipliers of pivot k-1 into column k-1
      const float* lb = lbuf + ((k - 1) & 1) * n;
      for (int i = k + threadIdx.y; i < n; i += blockDim.y) a[(size_t)i * n + k - 1] = lb[i];
    }
    const float* prow = a + (size_t)k * n;
    const float piv = prow[k];
    float* lb = lbuf + (k & 1) * n;
    for (int i = k + 1 + threadIdx.y; i < n; i += blockDim.y) {
      float* row = a + (size_t)i * n;
      const float l = __fdiv_rn(row[k], piv);
      if (threadIdx.x == 0) lb[i] = l;
      for (int j0 = k + 1 + threadIdx.x; j0 < n; j0 += kInFlight * blockDim.x) {
        float v[kInFlight], u[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int j = j0 + q * blockDim.x;
          if (j < n) {
            v[q] = row[j];
            u[q] = prow[j];
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int j = j0 + q * blockDim.x;
          if (j < n) row[j] = __fsub_rn(v[q], __fmul_rn(l, u[q]));
        }
      }
    }
    __syncthreads();
  }
  if (n >= 2 && threadIdx.x == 0) {  // the last pivot's multipliers
    const float* lb = lbuf + ((n - 2) & 1) * n;
    for (int i = n - 1 + threadIdx.y; i < n; i += blockDim.y) a[(size_t)i * n + n - 2] = lb[i];
  }
  __syncthreads();
}

// One block per system; the system staged in shared memory (n*n floats,
// then the 2n-float multiplier buffer).
__global__ void batched_lu_staged_kernel(float* a, int n) {
  a += (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const int count = n * n;
  for (int idx = tid; idx < count; idx += nt) smem[idx] = a[idx];
  __syncthreads();
  ebv_walk(smem, n, smem + count);
  for (int idx = tid; idx < count; idx += nt) a[idx] = smem[idx];
}

// One block per system, walked in place in device memory; shared memory
// holds only the multiplier buffer.
__global__ void batched_lu_global_kernel(float* a, int n) {
  ebv_walk(a + (size_t)blockIdx.x * n * n, n, smem);
}

// One cluster of C CTAs per system (csrc/ebv_walk.cuh's walk over C
// participants); n >= 2.
__global__ void __launch_bounds__(kWalkThreads, 1)
batched_lu_cluster_kernel(float* a, int n, int theta, size_t lbuf_at, size_t rows_at) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks();
  float* sys = a + (size_t)(blockIdx.x / C) * n * n;
  const Walk<float> w(sys, n, Owned(cluster.block_rank(), C, n), theta,
                      reinterpret_cast<char*>(smem), lbuf_at, rows_at);
  w.load_rows();
  __syncthreads();
  // pivot row k: a resident row's columns [theta, n) through DSMEM, the rest
  // from `sys`; found a step ahead, off the handoff's path
  auto resident_row = [&](int k) -> const float* {
    if (k <= theta || k >= n) return nullptr;
    int owner, slot;
    row_owner(k, C, n, &owner, &slot);
    return cluster.map_shared_rank(w.rs, owner) + (size_t)slot * w.ldr;
  };
  const float* remote = nullptr;
  int live = w.own.count(), w0 = 0, kept = -1;  // the streamed elements have steps [w0, k) pending
  float kv[kKeep];                               // the kept row's streamed columns (Walk::keep)
  for (int k = 0; k < n - 1; ++k) {
    if (k > 0) cluster_wait();  // row k is final, in its owner's shared memory or in `sys`
    while (live > 0 && w.own.row(live - 1) <= k) --live;
    const float* pk = sys + (size_t)k * n;
    w.stage(k, w0, live, kept, [&](int j) { return remote && j >= theta ? remote[j - theta] : load_l2(pk + j); });
    __syncthreads();
    const int next = live > 0 && w.own.row(live - 1) == k + 1 ? live - 1 : -1;
    if (next >= 0) {  // row k+1 first; its streamed columns go to `sys`
      w.ahead(k, next, next == kept ? k : w0, false, next == kept, kv);
      if (k + 1 <= theta) __threadfence();
      cluster_arrive_release();  // the row k+1, to the CTAs that read it next
    } else {
      cluster_arrive();
    }
    w.update(k, live, next);
    if ((k + 1) % kLag == 0) {
      w.sweep(k, w0, live, next);
      w0 = k + 1;
    }
    kept = w.keep(k, w0, live, next, kv);
    remote = resident_row(k + 1);
    __syncthreads();
  }
  if (n > 1) cluster_wait();  // no CTA reads another's shared memory past this
  w.write_back(false);
}


// ---------------------------------------------------------------------------
// the solve, wide path: one block per (tile of W RHS columns, system)
// ---------------------------------------------------------------------------

// The shape of a wide block's work at tile width W (4, 8, 16, 32 or 64):
// CG column quads, NRG row groups of threads, micro-tiles of up to RM rows
// (of one quad each), staged chunks of CH factor rows, the tile's row stride.
template <int W>
struct WideShape {
  static constexpr int CG = W / 4;
  static constexpr int NRG = kSolveThreads / CG;
  static constexpr int RM = NRG * 8 <= kChunkRows ? 8 : kChunkRows / NRG;
  static constexpr int CH = RM * NRG;
  static constexpr int LDY = W + 4;
};

inline size_t wide_bytes(int n, int W) {
  const size_t n32 = (size_t)(n + kStrip - 1) / kStrip * kStrip;
  const int nrg = kSolveThreads / (W / 4);
  const int rm = nrg * 8 <= kChunkRows ? 8 : kChunkRows / nrg;
  return (n32 * (W + 4) + 2 * (size_t)rm * nrg * kLdl) * sizeof(float);
}

// One staged piece of a sweep: the strip's triangle (rows [k0, k0+32) ∩ [0, n))
// or rows [r0, r1) below (forward) or above (backward) it; the factor's
// columns [k0, k0+32) either way.
struct Chunk {
  bool fwd, tri;
  int k0, r0, r1;
};

// the piece after c, in sweep order; false past the backward sweep's last
__device__ __forceinline__ bool next_chunk(Chunk& c, int n, int ch) {
  const int hi = c.fwd ? n : c.k0;
  if (c.tri) {
    const int lo = c.fwd ? c.k0 + kStrip : 0;
    if (lo < hi) {
      c.tri = false;
      c.r0 = lo;
      c.r1 = min(lo + ch, hi);
      return true;
    }
  } else if (c.r1 < hi) {
    c.r0 = c.r1;
    c.r1 = min(c.r0 + ch, hi);
    return true;
  }
  if (c.fwd) {
    c.k0 += kStrip;
    if (c.k0 >= n) {
      c.fwd = false;
      c.k0 = (n - 1) / kStrip * kStrip;
    }
  } else {
    c.k0 -= kStrip;
    if (c.k0 < 0) return false;
  }
  c.tri = true;
  c.r0 = c.k0;
  c.r1 = min(c.k0 + kStrip, n);
  return true;
}

// Copy the piece's factor block into buf (row r at r * kLdl), columns past
// n zero-filled; 16 bytes a copy where rows are 16-byte aligned (vec).
__device__ __forceinline__ void stage_chunk(float* buf, const float* lu, int n, const Chunk& c,
                                           bool vec) {
  const int rows = c.r1 - c.r0;
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * 8; idx += blockDim.x) {
      const int r = idx >> 3, q = idx & 7, col = c.k0 + 4 * q;
      const bool ok = col < n;
      cp_async16(buf + r * kLdl + 4 * q, ok ? lu + (size_t)(c.r0 + r) * n + col : lu, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kStrip; idx += blockDim.x) {
      const int r = idx >> 5, l = idx & 31, col = c.k0 + l;
      const bool ok = col < n;
      cp_async4(buf + r * kLdl + l, ok ? lu + (size_t)(c.r0 + r) * n + col : lu, ok ? 4 : 0);
    }
  }
}

// The strip's triangle for the tile's columns: TPC threads a column (every
// warp at work), thread r of column c holding its rows r, r + TPC, ... of
// the strip in registers; forward unit lower (y_i -= l_il y_l, l
// increasing), backward upper (x_l / u_ll, then x_i -= u_il x_l, l
// decreasing), the solved value of row l shuffled from its owner within
// the column's TPC lanes, the factor read from the staged block.  Every
// lane divides (the owner keeps its quotient), so no branch diverges.
template <int W>
__device__ void wide_triangle(float* ys, const float* buf, int n, int k0, bool fwd) {
  using S = WideShape<W>;
  constexpr int TPC = kSolveThreads / W < kStrip ? kSolveThreads / W : kStrip;
  constexpr int RPT = kStrip / TPC;  // rows a thread
  const int c = threadIdx.x / TPC, r = threadIdx.x % TPC;
  if (c >= W) return;  // whole warps (W = 4)
  const int top = min(kStrip, n - k0);  // rows of the strip inside the matrix
  const unsigned full = 0xffffffffu;
  float v[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) v[k] = ys[(k0 + r + TPC * k) * S::LDY + c];
  if (fwd) {
#pragma unroll
    for (int l = 0; l < kStrip - 1; ++l) {
      const float xl = __shfl_sync(full, v[l / TPC], l % TPC, TPC);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int i = r + TPC * k;
        if (i > l && i < top) v[k] = __fsub_rn(v[k], __fmul_rn(buf[i * kLdl + l], xl));
      }
    }
  } else {
#pragma unroll
    for (int l = kStrip - 1; l >= 0; --l) {
      if (l >= top) continue;
      const float d = __fdiv_rn(v[l / TPC], buf[l * kLdl + l]);
      if (r == l % TPC) v[l / TPC] = d;
      const float xl = __shfl_sync(full, d, l % TPC, TPC);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int i = r + TPC * k;
        if (i < l) v[k] = __fsub_rn(v[k], __fmul_rn(buf[i * kLdl + l], xl));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (r + TPC * k < top) ys[(k0 + r + TPC * k) * S::LDY + c] = v[k];
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Retire the strip's 32 terms from R rows x 4 columns a thread: rows
// r0 + d0 + rg + k * NRG (k < R, those past r1 skipped) of the tile, columns
// 4 cq .. 4 cq + 3, the factor block staged in buf (row r - r0).
template <int W, int R, bool kFwd>
__device__ __forceinline__ void wide_tile(float* ys, const float* buf, int k0, int r0, int d0, int nr) {
  using S = WideShape<W>;
  const int cq = threadIdx.x % S::CG, rg = threadIdx.x / S::CG;
  int loc[R];
  float acc[R][4];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    loc[k] = d0 + rg + k * S::NRG;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (loc[k] < nr) a = *reinterpret_cast<const float4*>(ys + (r0 + loc[k]) * S::LDY + 4 * cq);
    acc[k][0] = a.x;
    acc[k][1] = a.y;
    acc[k][2] = a.z;
    acc[k][3] = a.w;
  }
  // the strip's 32 terms in 8 groups of 4, the next group's loads in flight
  // while this group's arithmetic runs (two register sets; unrolled
  // further, the loads of every group stay live at once and the tile spills)
  float4 la[R], ya[4], lb[R], yb[4];
  auto load = [&](float4* lf, float4* yf, int g) {
    const int gg = kFwd ? g : kStrip / 4 - 1 - g;
#pragma unroll
    for (int k = 0; k < R; ++k)
      lf[k] = loc[k] < nr ? *reinterpret_cast<const float4*>(buf + loc[k] * kLdl + 4 * gg)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yf[j] = *reinterpret_cast<const float4*>(ys + (k0 + 4 * gg + j) * S::LDY + 4 * cq);
  };
  auto apply = [&](const float4* lf, const float4* yf) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = kFwd ? jj : 3 - jj;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float l = comp(lf[k], j);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] = __fsub_rn(acc[k][q], __fmul_rn(l, comp(yf[j], q)));
      }
    }
  };
  load(la, ya, 0);
#pragma unroll 1
  for (int g = 0; g < kStrip / 4; g += 2) {
    load(lb, yb, g + 1);
    apply(la, ya);
    if (g + 2 < kStrip / 4) load(la, ya, g + 2);
    apply(lb, yb);
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (loc[k] < nr)
      *reinterpret_cast<float4*>(ys + (r0 + loc[k]) * S::LDY + 4 * cq) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
}

// The piece's rows [r0, r1) in passes of R rows a thread, the largest R
// whose pass the rows left fill, so no thread idles for a few rows.
template <int W, bool kFwd>
__device__ void wide_update(float* ys, const float* buf, int k0, int r0, int r1) {
  using S = WideShape<W>;
  const int nr = r1 - r0;
  for (int d0 = 0; d0 < nr;) {
    const int left = nr - d0;
    if (S::RM >= 8 && left >= 8 * S::NRG) {
      wide_tile<W, (S::RM >= 8 ? 8 : 1), kFwd>(ys, buf, k0, r0, d0, nr);
      d0 += 8 * S::NRG;
    } else if (S::RM >= 4 && left >= 4 * S::NRG) {
      wide_tile<W, (S::RM >= 4 ? 4 : 1), kFwd>(ys, buf, k0, r0, d0, nr);
      d0 += 4 * S::NRG;
    } else if (S::RM >= 2 && left >= 2 * S::NRG) {
      wide_tile<W, (S::RM >= 2 ? 2 : 1), kFwd>(ys, buf, k0, r0, d0, nr);
      d0 += 2 * S::NRG;
    } else {
      wide_tile<W, 1, kFwd>(ys, buf, k0, r0, d0, nr);
      d0 += S::NRG;
    }
  }
}

// x = (LU)^-1 b per system; one block per (system, RHS tile of W columns),
// blockIdx.x = system * tiles + tile, so any number of systems fits the grid.
template <int W>
__global__ void __launch_bounds__(kSolveThreads)
batched_solve_wide_kernel(const float* __restrict__ lu, const float* __restrict__ b,
                          float* __restrict__ x, int n, int m, int tiles, int vec) {
  using S = WideShape<W>;
  const int sys = blockIdx.x / tiles;
  lu += (size_t)sys * n * n;
  b += (size_t)sys * n * m;
  x += (size_t)sys * n * m;
  const int n32 = (n + kStrip - 1) / kStrip * kStrip;
  float* ys = smem;
  float* lbuf = smem + (size_t)n32 * S::LDY;
  const int c0 = (blockIdx.x - sys * tiles) * W, w = min(W, m - c0);
  for (int idx = threadIdx.x; idx < n32 * W; idx += blockDim.x) {
    const int i = idx / W, c = idx % W;
    ys[i * S::LDY + c] = (i < n && c < w) ? b[(size_t)i * m + c0 + c] : 0.f;
  }
  Chunk cur{true, true, 0, 0, min(kStrip, n)};
  stage_chunk(lbuf, lu, n, cur, vec);
  cp_async_commit();
  for (int t = 0;; ++t) {
    Chunk nxt = cur;
    const bool more = next_chunk(nxt, n, S::CH);
    if (more) stage_chunk(lbuf + ((t + 1) & 1) * S::CH * kLdl, lu, n, nxt, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this piece's block has landed; the tile's earlier updates are seen
    const float* buf = lbuf + (t & 1) * S::CH * kLdl;
    if (cur.tri) wide_triangle<W>(ys, buf, n, cur.k0, cur.fwd);
    else if (cur.fwd) wide_update<W, true>(ys, buf, cur.k0, cur.r0, cur.r1);
    else wide_update<W, false>(ys, buf, cur.k0, cur.r0, cur.r1);
    __syncthreads();  // the buffer is free for the piece after next
    if (!more) break;
    cur = nxt;
  }
  // a column whose row 0 is not finite comes out NaN throughout, as the plain
  // version's masked sweeps make it (nonfinite.cuh: its non-finite rows are
  // a prefix, and the strip is the whole column)
  for (int idx = threadIdx.x; idx < n * W; idx += blockDim.x) {
    const int i = idx / W, c = idx % W;
    if (c < w) x[(size_t)i * m + c0 + c] = isfinite(ys[c]) ? ys[i * S::LDY + c] : nonfinite::qnan();
  }
}

// ---------------------------------------------------------------------------
// the solve, cluster path: one cluster of C CTAs per (tile of mt <= 16 RHS
// columns, system)
// ---------------------------------------------------------------------------

// Strip ownership by equalized pairs: unit u < P = ceil(S/2) is strips u and
// S-1-u (one strip when they coincide), owned by CTA u mod C in its slots
// 2k and 2k+1 (u = c + k C).
struct StripPairs {
  int S, C;
  __device__ int unit(int s) const { return min(s, S - 1 - s); }
  __device__ int owner(int s) const { return unit(s) % C; }
  __device__ int slot(int s) const { return 2 * (unit(s) / C) + (s == unit(s) ? 0 : 1); }
  // the strip in CTA c's slot, or -1
  __device__ int strip(int c, int slot) const {
    const int u = c + (slot >> 1) * C;
    if (u >= (S + 1) / 2) return -1;
    if (!(slot & 1)) return u;
    return S - 1 - u == u ? -1 : S - 1 - u;
  }
};

__host__ __device__ inline int narrow_slots(int n, int C) {
  const int S = (n + kStrip - 1) / kStrip, P = (S + 1) / 2;
  return 2 * ((P + C - 1) / C);
}

// own values (slots x 32 rows x mt) and three receive buffers (32 x mt)
inline size_t narrow_bytes(int n, int mt, int C) {
  return ((size_t)narrow_slots(n, C) * kStrip + 3 * kStrip) * mt * sizeof(float);
}

// the 32 factor entries of row i at columns [k0, k0+32), those at or past n
// (or outside [lo, hi) of the strip) zero
__device__ __forceinline__ void load_strip_row(float* dst, const float* row, int k0, int n, bool vec) {
  if (vec && k0 + kStrip <= n) {
#pragma unroll
    for (int q = 0; q < kStrip / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + k0) + q);
      dst[4 * q] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kStrip; ++l) dst[l] = k0 + l < n ? __ldg(row + k0 + l) : 0.f;
  }
}

// link t of the 2S: forward strip t, then backward strip 2S-1-t
__device__ __forceinline__ int link_strip(int t, int S) { return t < S ? t : 2 * S - 1 - t; }

__global__ void __launch_bounds__(kNarrowThreads, 1)
batched_solve_cluster_kernel(const float* __restrict__ lu, const float* __restrict__ b,
                             float* __restrict__ x, int n, int m, int mt, int tiles, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int ci = blockIdx.x / C, sys = ci / tiles, c0 = (ci % tiles) * mt, w = min(mt, m - c0);
  lu += (size_t)sys * n * n;
  b += (size_t)sys * n * m;
  x += (size_t)sys * n * m;
  const int S = (n + kStrip - 1) / kStrip;
  const StripPairs sp{S, C};
  const int nslots = narrow_slots(n, C), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tid = threadIdx.x, nt = blockDim.x, span = kStrip * mt;
  float* own = smem;                               // own[(slot * 32 + r) * mt + c]
  float* recv = smem + (size_t)nslots * span;      // recv[(t % 3) * span + r * mt + c]
  for (int idx = tid; idx < nslots * span; idx += nt) {
    const int slot = idx / span, r = idx % span / mt, c = idx % mt;
    const int s = sp.strip(rank, slot), i = s * kStrip + r;
    own[idx] = (s >= 0 && i < n && c < w) ? b[(size_t)i * m + c0 + c] : 0.f;
  }
  __syncthreads();
  cluster_arrive();  // every CTA runs before any writes another's shared memory
  cluster_wait();
  const unsigned full = 0xffffffffu;
  const bool tri_warp = warp < w;  // warp w carries column w through its strips' triangles

  // The triangle of link t's strip, by its owner's warps: first the terms of
  // link t-1's strip (from `prev`, the solved values; none at t = 0 and at
  // the first backward link t = S), then the strip's own; the result into
  // the own slot and every CTA's receive buffer t % 3.
  auto solve_link = [&](int t, const float* prev, const float* cross, const float* tri, float piv) {
    const int s = link_strip(t, S), k0 = s * kStrip, row = k0 + lane, top = min(kStrip, n - k0);
    const bool fwd = t < S;
    float* mine = own + (size_t)(sp.slot(s) * kStrip + lane) * mt + warp;
    float v = *mine;
    if (prev) {
      const int kp = link_strip(t - 1, S) * kStrip;
      if (fwd) {
#pragma unroll
        for (int l = 0; l < kStrip; ++l) v = __fsub_rn(v, __fmul_rn(cross[l], prev[l * mt + warp]));
      } else {
#pragma unroll
        for (int l = kStrip - 1; l >= 0; --l)
          if (kp + l < n) v = __fsub_rn(v, __fmul_rn(cross[l], prev[l * mt + warp]));
      }
    }
    if (fwd) {
#pragma unroll
      for (int l = 0; l < kStrip - 1; ++l) {
        const float y = __shfl_sync(full, v, l);
        if (l < lane) v = __fsub_rn(v, __fmul_rn(tri[l], y));
      }
    } else {
#pragma unroll
      for (int l = kStrip - 1; l >= 0; --l) {
        if (lane == l) v = __fdiv_rn(v, piv);
        const float xk = __shfl_sync(full, v, l);
        if (l > lane && l < top) v = __fsub_rn(v, __fmul_rn(tri[l], xk));
      }
    }
    if (row < n) *mine = v;
    else v = 0.f;
    float* dst = recv + (t % 3) * span + lane * mt + warp;
    for (int r = 0; r < C; ++r) *cluster.map_shared_rank(dst, r) = v;
  };
  // the factor blocks a triangle warp needs for link t: the previous strip's
  // columns (cross) and the strip's own (tri, piv), loaded ahead of the wait
  float cross[kStrip], tri[kStrip], piv = 1.f;
  auto load_link = [&](int t) {
    const int s = link_strip(t, S), k0 = s * kStrip, row = k0 + lane;
    const bool fwd = t < S;
    const float* r = lu + (size_t)min(row, n - 1) * n;
    if (t > 0 && t != S) {
      load_strip_row(cross, r, link_strip(t - 1, S) * kStrip, n, vec);
      if (row >= n)
#pragma unroll
        for (int l = 0; l < kStrip; ++l) cross[l] = 0.f;
    }
    load_strip_row(tri, r, k0, n, vec);
#pragma unroll
    for (int l = 0; l < kStrip; ++l) {
      const bool keep = row < n && (fwd ? l < lane : l > lane);
      if (!keep) tri[l] = 0.f;
    }
    piv = row < n ? __ldg(r + row) : 1.f;
  };

  if (sp.owner(0) == rank && tri_warp) {
    load_link(0);
    solve_link(0, nullptr, cross, tri, piv);
  }
  cluster_arrive_release();
  for (int t = 0; t < 2 * S; ++t) {
    const bool next = t + 1 < 2 * S;
    const int s1 = next ? link_strip(t + 1, S) : -1;
    const bool ahead = next && sp.owner(s1) == rank && tri_warp;
    if (ahead) load_link(t + 1);
    const int s = link_strip(t, S), k0 = s * kStrip;
    const bool fwd = t < S;
    cluster_wait();  // link t's values are in recv[t % 3]
    const float* v = recv + (t % 3) * span;
    if (ahead) solve_link(t + 1, t + 1 == S ? nullptr : v, cross, tri, piv);
    if (next) cluster_arrive_release();
    // every own row the strip still reaches, but the next link's strip
    for (int item = tid; item < nslots * kStrip; item += nt) {
      const int slot = item / kStrip, r = item % kStrip, s2 = sp.strip(rank, slot);
      const int i = s2 * kStrip + r;
      if (s2 < 0 || s2 == s1 || i >= n || (fwd ? s2 <= s : s2 >= s)) continue;
      float lrow[kStrip];
      load_strip_row(lrow, lu + (size_t)i * n, k0, n, vec);
      float* a = own + (size_t)item * mt;
      for (int c = 0; c < w; ++c) {
        float acc = a[c];
        if (fwd) {
#pragma unroll
          for (int l = 0; l < kStrip; ++l) acc = __fsub_rn(acc, __fmul_rn(lrow[l], v[l * mt + c]));
        } else {
#pragma unroll
          for (int l = kStrip - 1; l >= 0; --l)
            if (k0 + l < n) acc = __fsub_rn(acc, __fmul_rn(lrow[l], v[l * mt + c]));
        }
        a[c] = acc;
      }
    }
    __syncthreads();  // the own rows' values, for the next link's triangle
  }
  // the last link's values are strip 0's, row 0 first: a column whose row 0
  // is not finite comes out NaN throughout, as the plain version's masked
  // sweeps make it (nonfinite.cuh)
  const float* first = recv + ((2 * S - 1) % 3) * span;
  for (int idx = tid; idx < nslots * span; idx += nt) {
    const int slot = idx / span, r = idx % span / mt, c = idx % mt;
    const int s = sp.strip(rank, slot), i = s * kStrip + r;
    if (s >= 0 && i < n && c < w) x[(size_t)i * m + c0 + c] = isfinite(first[c]) ? own[idx] : nonfinite::qnan();
  }
}

// Block of the factor walk: x over columns (at most 32), y over rows, at
// most 1024 threads, at least 4 rows.
dim3 factor_block(int n) {
  int y = n < 32 ? n : 32;
  if (y < 4) y = 4;
  return dim3(32, y);
}

RoomCache factor_room_cache, solve_room_cache;

// clusters of 2, 4, 8 and 16 CTAs of the factor's cluster kernel the
// current device holds at once
cudaError_t cluster_room(int room[4]) {
  return cluster_room_of(batched_lu_cluster_kernel, kWalkThreads, kWalkSmem, factor_room_cache, room);
}

cudaError_t solve_cluster_room(int room[4]) {
  return cluster_room_of(batched_solve_cluster_kernel, kNarrowThreads, kSmemBytes, solve_room_cache, room);
}

// The factor's kernel for `batch` (n, n) systems on `sms` SMs that hold
// room[i] clusters of kClusterSizes[i] CTAs at once: 0 staged, 1 one block
// per system in device memory, C >= 2 a cluster of C CTAs per system, the
// largest whose clusters all run at once, else 2
// (kernels/batched_lu.py:batched_lu_plan mirrors it).
int batched_plan(int batch, int n, int sms, const int room[4]) {
  if (((size_t)n * n + 2 * (size_t)n) * sizeof(float) <= (size_t)kSmemBytes) return 0;
  if (batch >= sms) return 1;
  for (int i = 3; i > 0; --i)
    if (batch <= room[i]) return kClusterSizes[i];
  return kClusterSizes[0];
}

cudaError_t launch_cluster(float* a, int batch, int n, int csize, cudaStream_t stream, int* plan) {
  const WalkPlan p = walk_plan(n, n, csize, sizeof(float));
  if (!p.bytes) return cudaErrorInvalidValue;
  plan[2] = p.theta;
  plan[3] = static_cast<int>(p.bytes);
  return launch_cluster_kernel(batched_lu_cluster_kernel, csize, batch * csize, kWalkThreads, p.bytes,
                               stream, &plan[4], a, n, p.theta, p.lbuf_at, p.rows_at);
}

template <int W>
cudaError_t launch_wide(const float* lu, const float* b, float* x, int batch, int n, int m,
                        size_t bytes, bool vec, cudaStream_t stream) {
  auto kernel = batched_solve_wide_kernel<W>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)))
    return err;
  const int tiles = (m + W - 1) / W;
  if ((long long)batch * tiles > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<batch * tiles, kSolveThreads, bytes, stream>>>(lu, b, x, n, m, tiles, vec);
  return cudaGetLastError();
}

}  // namespace

// Factor `batch` row-major (n, n) fp32 systems in place, in one launch of
// the kernel batched_plan picks.  plan[0..4]: the kind (0 staged, 1 global,
// 2 cluster), the CTAs per system, and for a cluster theta, its shared
// memory bytes and how many such clusters the card holds at once.  Returns
// the first CUDA error (a refused cluster launch among them); *launches
// counts the kernels launched.
extern "C" int ebv_batched_lu(void* a_ptr, int batch, int n, int* plan, void* stream_ptr, int* launches) {
  float* a = static_cast<float*>(a_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  for (int i = 0; i < 5; ++i) plan[i] = 0;
  if (batch == 0 || n == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return err;
  int room[4];
  if ((err = cluster_room(room))) return err;
  const int kind = batched_plan(batch, n, sms, room);
  plan[0] = kind < 2 ? kind : 2;
  plan[1] = kind < 2 ? 1 : kind;
  if (kind == 0) {
    const size_t staged = ((size_t)n * n + 2 * (size_t)n) * sizeof(float);
    if ((err = cudaFuncSetAttribute(batched_lu_staged_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)staged)))
      return err;
    batched_lu_staged_kernel<<<batch, factor_block(n), staged, stream>>>(a, n);
    err = cudaGetLastError();
  } else if (kind == 1) {
    batched_lu_global_kernel<<<batch, factor_block(n), 2 * (size_t)n * sizeof(float), stream>>>(a, n);
    err = cudaGetLastError();
  } else {
    err = launch_cluster(a, batch, n, kind, stream, plan);
  }
  if (err) return err;
  ++*launches;
  // the NaN the plain version's masked steps spread (nonfinite.cuh), one
  // more launch (n >= 3): it returns at once on a finite factor
  return nonfinite::launch_lu_spread(a, batch, n, stream, launches);
}

// room[0..3]: how many clusters of 2, 4, 8 and 16 CTAs of the factor's
// cluster kernel the current device holds at once.
extern "C" int ebv_batched_cluster_room(int* room) { return cluster_room(room); }

// The same for the solve's cluster kernel.
extern "C" int ebv_batched_solve_cluster_room(int* room) { return solve_cluster_room(room); }

// x (batch, n, m) = (LU)^-1 b per system on the packed (batch, n, n)
// factors, in one launch of the plan kernels/batched_lu.py:batched_solve_plan
// picks: path 1 wide (tiles of `cols` = 4, 8, 16, 32 or 64 RHS columns) or
// 2 cluster (tiles of `cols` <= 16 columns, `ctas` CTAs a cluster).
// plan[0..4]: the path, the tile's columns, the CTAs per (system, tile), the
// shared memory bytes a CTA and, for a cluster, how many such clusters the
// card holds at once.  A plan whose CTA does not fit shared memory returns
// cudaErrorInvalidValue; a cluster the card cannot hold,
// cudaErrorLaunchOutOfResources.
extern "C" int ebv_batched_lu_solve(const void* lu_ptr, const void* b_ptr, void* x_ptr, int batch, int n,
                                    int m, int path, int cols, int ctas, int* plan, void* stream_ptr,
                                    int* launches) {
  const float* lu = static_cast<const float*>(lu_ptr);
  const float* b = static_cast<const float*>(b_ptr);
  float* x = static_cast<float*>(x_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  for (int i = 0; i < 5; ++i) plan[i] = 0;
  if (batch == 0 || n == 0 || m == 0) return 0;
  const bool wide = path == 1 && (cols == 4 || cols == 8 || cols == 16 || cols == 32 || cols == 64);
  const bool narrow = path == 2 && cols >= 1 && cols <= kNarrowCols && ctas >= 1;
  if (!wide && !narrow) return cudaErrorInvalidValue;
  const size_t bytes = wide ? wide_bytes(n, cols) : narrow_bytes(n, cols, ctas);
  plan[0] = path;
  plan[1] = cols;
  plan[2] = wide ? 1 : ctas;
  plan[3] = static_cast<int>(bytes);
  if (bytes > (size_t)kSmemBytes) return cudaErrorInvalidValue;
  // 16-byte rows: n a multiple of 4 and the factors 16-byte aligned
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(lu) % 16 == 0;
  cudaError_t err;
  if (wide) {
    switch (cols) {
      case 4: err = launch_wide<4>(lu, b, x, batch, n, m, bytes, vec, stream); break;
      case 8: err = launch_wide<8>(lu, b, x, batch, n, m, bytes, vec, stream); break;
      case 16: err = launch_wide<16>(lu, b, x, batch, n, m, bytes, vec, stream); break;
      case 32: err = launch_wide<32>(lu, b, x, batch, n, m, bytes, vec, stream); break;
      default: err = launch_wide<64>(lu, b, x, batch, n, m, bytes, vec, stream); break;
    }
  } else {
    const int tiles = (m + cols - 1) / cols;
    if ((long long)batch * tiles * ctas > INT_MAX) return cudaErrorInvalidValue;
    err = launch_cluster_kernel(batched_solve_cluster_kernel, ctas, batch * tiles * ctas, kNarrowThreads,
                                bytes, stream, &plan[4], lu, b, x, n, m, cols, tiles, (int)vec);
  }
  if (err) return err;
  ++*launches;
  return 0;
}
