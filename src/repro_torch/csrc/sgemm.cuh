// The fp32 SGEMM tile O = C - A B on the CUDA cores, shared by the dense
// factor's trailing update (ebv_lu.cu: lu_fused, B1) and the legacy
// rank-k update (legacy_lu.cu: update, B14).
//
// IEEE fp32 FMAs (there is no fp32 wgmma, and TF32 stays off): 128x128,
// 128x64 or 64x64 output tiles of 256 threads, an 8x8, 8x4 or 4x4 register
// micro-tile per thread, the depth in chunks of 16 through a two-stage ring
// in shared memory, and the C tile copied into shared memory at the start so
// that its device-memory read overlaps the product.  In shared memory both
// operands are k-major rows, read as float4, free of bank conflicts.  How
// an operand gets there depends on how it arrives:
//   - fp32 A k-major (the factor's panel scratch holds L21 transposed) and
//     fp32 B with 16-byte rows: 16-byte cp.async straight into the ring;
//     a k-major A comes with B in the same scratch, padded past every
//     tile's last row and column, so only its depth is masked;
//   - fp32 A row-major (m, k), as the legacy update's L21 arrives: its
//     rows of 16 depths by 16-byte cp.async into a row-major ring, each
//     thread reading 4 depths of a row as one float4 and using them in
//     order, so A costs as many shared-memory reads as k-major A does;
//   - fp32 rows that are not 16-byte aligned: 4-byte cp.async;
//   - bf16 (row-major A, and B): through registers, widened to fp32 as it
//     is read (the chunk after next is loaded before the product of this
//     one and stored into the ring after it).
// Otherwise rows, columns and depth past the operands' edges are masked
// (zeros into the ring), never padded; nothing is stored past O's edges.
// The product accumulates in fp32 in k order; O = C - rnd<T>(acc), rounded
// to T once more as it is stored (the plain versions' order: the product
// rounded to the output type, then the subtraction).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "async_copy.cuh"
#include "elem.cuh"
#include "pdl.cuh"

namespace {

constexpr int kGemmThreads = 256;  // 16 x 16 threads over a tile
constexpr int kGemmDepth = 16;     // k-chunk of the ring
constexpr int kGemmStages = 2;     // the ring: a chunk's copy hides behind the product of the one before

// One SGEMM: O(i, j) = C(i, j) - sum_k A(i, k) B(k, j) for i < rows, j < cols.
template <typename T>
struct Gemm {
  const T* a;  // A(i, k) = a[k * lda + i] (k-major, with b padded scratch) or a[i * lda + k] (row-major)
  int lda;
  const T* b;  // B(k, j) = b[k * ldb + j]
  int ldb;
  const T* c;  // C(i, j) = c[i * ldc + j]; O likewise at o, which may be c
  T* o;
  int ldc;
  int rows, cols, depth;  // A's rows, B's columns and the depth: past them, zeros
  int vec;    // fp32 C and O rows copy as float4: ldc, the rectangles' edges and c, o 16-byte aligned
  int vec_b;  // fp32 B rows copy as 16 bytes: ldb, cols and b 16-byte aligned
  int vec_a;  // fp32 row-major A rows copy as 16 bytes: lda and a 16-byte aligned
};

// A rectangle of O that one launch covers, in (BM, BN) tiles: rows ro ..
// ro+rows-1, columns co .. co+cols-1.
struct Rect {
  int ro, co, rows, cols;
  int tiles_x, tiles;  // tiles across, tiles in all
};

template <int BM, int BN>
Rect rect(int ro, int co, int rows, int cols) {
  const int tx = (cols + BN - 1) / BN;
  return Rect{ro, co, rows, cols, tx, rows > 0 && cols > 0 ? tx * ((rows + BM - 1) / BM) : 0};
}

// The ring's A row stride: BM for k-major rows; a row-major A keeps its
// rows of 16 depths, 4 floats apart so that a warp's 4 rows fall 2 to a
// bank group.
template <bool kKMajorA, int BM>
__host__ __device__ constexpr int gemm_lda() {
  return kKMajorA ? BM : kGemmDepth + 4;
}

// floats of one A stage of the ring
template <bool kKMajorA, int BM>
__host__ __device__ constexpr int gemm_a_stage() {
  return kKMajorA ? kGemmDepth * BM : BM * gemm_lda<kKMajorA, BM>();
}

template <bool kKMajorA, int BM, int BN>
constexpr size_t gemm_smem() {
  return (size_t)(kGemmStages * (gemm_a_stage<kKMajorA, BM>() + kGemmDepth * BN) + BM * BN) * sizeof(float);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Block b covers the b-th (BM, BN) tile of r0, then of r1.  Thread (tx, ty)
// of 16 x 16 (a warp is 8 x 4 of them) owns rows 64i + 4ty + (0..3) and
// columns 64j + 4tx + (0..3) of its tile.  `wait_last`: the launch reads
// nothing the launch before it writes (see ebv_lu_fused), so it waits for
// that launch only at the end of its last block, which makes its
// completion imply that launch's; otherwise it waits before it reads.
// Outside a chain of programmatic dependent launches both waits return at
// once.
template <typename T, bool kKMajorA, int BM, int BN>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_kernel(Gemm<T> g, Rect r0, Rect r1, int wait_last) {
  extern __shared__ __align__(16) float gemm_smem_f[];
  constexpr int TM = BM / 16, TN = BN / 16;  // 8 or 4
  constexpr int P = kGemmStages;
  constexpr int LA = gemm_lda<kKMajorA, BM>(), SA = gemm_a_stage<kKMajorA, BM>();
  constexpr bool kFloat = std::is_same<T, float>::value;  // fp32 copies asynchronously; bf16 widens in registers
  constexpr int kRegA = kFloat ? 1 : BM * kGemmDepth / kGemmThreads;  // A elements a thread stages
  constexpr int kRegB = kFloat ? 1 : BN * kGemmDepth / kGemmThreads;  // B elements
  float* As = gemm_smem_f;                   // [P][kGemmDepth][LA] k-major, [P][BM][LA] row-major
  float* Bs = As + P * SA;                   // [P][kGemmDepth][BN]
  float* Cs = Bs + P * kGemmDepth * BN;      // [BM][BN]
  allow_next_step();
  const bool first = blockIdx.x < r0.tiles;
  const Rect& R = first ? r0 : r1;
  const int blk = first ? blockIdx.x : blockIdx.x - r0.tiles;
  const int bi = R.ro + blk / R.tiles_x * BM, bj = R.co + blk % R.tiles_x * BN;
  const int rlim = R.ro + R.rows, clim = R.co + R.cols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  if (!wait_last) wait_prior_step();

  // rows k0..k0+15 of both operands, fp32: by cp.async, zeros past the edges
  auto stage_async = [&](int chunk) {
    if constexpr (kFloat) {
      const int k0 = chunk * kGemmDepth;
      const float* a = reinterpret_cast<const float*>(g.a);
      const float* b = reinterpret_cast<const float*>(g.b);
      float* as = As + (chunk % P) * SA;
      float* bs = Bs + (chunk % P) * kGemmDepth * BN;
      if constexpr (kKMajorA) {
        for (int idx = threadIdx.x; idx < kGemmDepth * BM / 4; idx += kGemmThreads) {
          const int k = idx / (BM / 4), m = 4 * (idx % (BM / 4));
          const bool ok = k0 + k < g.depth;  // the scratch holds every tile's rows
          cp_async16(as + k * LA + m, ok ? a + (size_t)(k0 + k) * g.lda + bi + m : a, ok ? 16 : 0);
        }
      } else {  // a row's 16 depths in 4 pieces of 4, each a 16-byte copy where rows are aligned
        for (int idx = threadIdx.x; idx < BM * kGemmDepth / 4; idx += kGemmThreads) {
          const int m = idx / (kGemmDepth / 4), kq = 4 * (idx % (kGemmDepth / 4));
          const int left = g.depth - (k0 + kq);  // depths of the piece the operand has
          const bool ok = bi + m < g.rows && left > 0;
          float* dst = as + m * LA + kq;
          const float* src = a + (size_t)(bi + m) * g.lda + k0 + kq;
          if (g.vec_a) {
            cp_async16(dst, ok ? src : a, ok ? 4 * min(4, left) : 0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) cp_async4(dst + e, ok && e < left ? src + e : a, ok && e < left ? 4 : 0);
          }
        }
      }
      if (kKMajorA || g.vec_b) {  // the factor's scratch rows are 16-byte aligned
        for (int idx = threadIdx.x; idx < kGemmDepth * BN / 4; idx += kGemmThreads) {
          const int k = idx / (BN / 4), m = 4 * (idx % (BN / 4));
          const bool ok = k0 + k < g.depth && (kKMajorA || bj + m < g.cols);  // k-major: padded scratch
          cp_async16(bs + k * BN + m, ok ? b + (size_t)(k0 + k) * g.ldb + bj + m : b, ok ? 16 : 0);
        }
      } else {
        for (int idx = threadIdx.x; idx < kGemmDepth * BN; idx += kGemmThreads) {
          const int k = idx / BN, j = idx % BN;
          const bool ok = k0 + k < g.depth && bj + j < g.cols;
          cp_async4(bs + idx, ok ? b + (size_t)(k0 + k) * g.ldb + bj + j : b, ok ? 4 : 0);
        }
      }
    }
  };
  // bf16 through registers, widened as it is read: load ...
  float ra[kRegA], rb[kRegB];
  auto load_regs = [&](int chunk) {
    if constexpr (!kFloat) {
      static_assert(!kKMajorA, "a bf16 A arrives row-major");
      const int k0 = chunk * kGemmDepth;
#pragma unroll
      for (int e = 0; e < kRegA; ++e) {  // a warp reads 2 rows x 16 depths
        const int idx = threadIdx.x + e * kGemmThreads, k = idx % kGemmDepth, m = idx / kGemmDepth;
        const bool ok = k0 + k < g.depth && bi + m < g.rows;
        ra[e] = ok ? load(g.a + (size_t)(bi + m) * g.lda + k0 + k) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kRegB; ++e) {
        const int idx = threadIdx.x + e * kGemmThreads, k = idx / BN, j = idx % BN;
        const bool ok = k0 + k < g.depth && bj + j < g.cols;
        rb[e] = ok ? load(g.b + (size_t)(k0 + k) * g.ldb + bj + j) : 0.f;
      }
    }
  };
  // ... and store into the ring
  auto store_regs = [&](int chunk) {
    if constexpr (!kFloat) {
      float* as = As + (chunk % P) * SA;
      float* bs = Bs + (chunk % P) * kGemmDepth * BN;
#pragma unroll
      for (int e = 0; e < kRegA; ++e) {
        const int idx = threadIdx.x + e * kGemmThreads;
        as[(idx / kGemmDepth) * LA + idx % kGemmDepth] = ra[e];
      }
#pragma unroll
      for (int e = 0; e < kRegB; ++e) bs[threadIdx.x + e * kGemmThreads] = rb[e];
    }
  };
  const int chunks = (g.depth + kGemmDepth - 1) / kGemmDepth;
  // copy groups: [chunk 0] .. [chunk P-1] [C tile], then chunk c+P after chunk c
#pragma unroll
  for (int c = 0; c < P; ++c) {
    if (c < chunks) {
      stage_async(c);
      load_regs(c);
      store_regs(c);
    }
    cp_async_commit();
  }
  if (kFloat && g.vec)
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += kGemmThreads) {
      const int r = idx / (BN / 4), c = 4 * (idx % (BN / 4));
      if (bi + r < rlim && bj + c < clim)
        cp_async16(Cs + r * BN + c, reinterpret_cast<const float*>(g.c) + (size_t)(bi + r) * g.ldc + bj + c);
    }
  cp_async_commit();

  float acc[TM][TN] = {};
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk < P) cp_async_wait<P>();
    else cp_async_wait<P - 1>();
    __syncthreads();
    const bool more = chunk + P < chunks;
    if (more) load_regs(chunk + P);  // in flight during the product
    const float* as = As + (chunk % P) * SA;
    const float* bs = Bs + (chunk % P) * kGemmDepth * BN;
    if constexpr (kKMajorA) {
#pragma unroll
      for (int k = 0; k < kGemmDepth; ++k) {
        float af[TM], bf[TN];
#pragma unroll
        for (int i = 0; i < TM / 4; ++i)
          *reinterpret_cast<float4*>(&af[4 * i]) = *reinterpret_cast<const float4*>(as + k * LA + 64 * i + 4 * ty);
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          *reinterpret_cast<float4*>(&bf[4 * j]) = *reinterpret_cast<const float4*>(bs + k * BN + 64 * j + 4 * tx);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
      }
    } else {  // each row's 4 next depths as one float4, then the 4 depths in order
#pragma unroll
      for (int k4 = 0; k4 < kGemmDepth; k4 += 4) {
        float4 a4[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a4[i] = *reinterpret_cast<const float4*>(as + (64 * (i / 4) + 4 * ty + i % 4) * LA + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bf[TN];
#pragma unroll
          for (int j = 0; j < TN / 4; ++j)
            *reinterpret_cast<float4*>(&bf[4 * j]) =
                *reinterpret_cast<const float4*>(bs + (k4 + kk) * BN + 64 * j + 4 * tx);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(lane_of(a4[i], kk), bf[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
    if (more) {  // into the buffer just read
      stage_async(chunk + P);
      store_regs(chunk + P);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = 64 * (i / 4) + 4 * ty + i % 4;
    if (bi + r >= rlim) continue;
    const size_t row = (size_t)(bi + r) * g.ldc + bj;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int c = 64 * j + 4 * tx;
      if (kFloat && g.vec) {
        if (bj + c >= clim) continue;
        float4 o = *reinterpret_cast<const float4*>(Cs + r * BN + c);
        o.x -= acc[i][4 * j];
        o.y -= acc[i][4 * j + 1];
        o.z -= acc[i][4 * j + 2];
        o.w -= acc[i][4 * j + 3];
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(g.o) + row + c) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (bj + c + e < clim)
            store(g.o + row + c + e, __fsub_rn(load_l2(g.c + row + c + e), rnd<T>(acc[i][4 * j + e])));
      }
    }
  }
  if (wait_last && blockIdx.x == gridDim.x - 1) wait_prior_step();
}

struct Shape {
  int bm, bn;
  // the tile's FMA rate against the 128 x 128 tile's on a large trailing
  // matrix: about what the factor's update alone reached on an H100 at
  // 700 W (M = 7872: 36.9, 32.1 and 25.6 TF/s)
  float eff;
};
constexpr Shape kShapes[] = {{128, 128, 1.f}, {128, 64, 0.85f}, {64, 64, 0.7f}};

// The tile whose count splits a (rows, cols) rectangle most evenly over the
// SMs: least tiles per SM times a tile's work over its rate.
inline int pick_shape(int rows, int cols, int sms) {
  int best = 0;
  double best_cost = 0;
  for (int i = 0; i < 3; ++i) {
    const Shape& s = kShapes[i];
    const long tiles = (long)((rows + s.bm - 1) / s.bm) * ((cols + s.bn - 1) / s.bn);
    const double cost = (double)((tiles + sms - 1) / sms) * s.bm * s.bn / s.eff;
    if (i == 0 || cost < best_cost) best = i, best_cost = cost;
  }
  return best;
}

// One launch of g over rectangles r0 and r1 in (BM, BN) tiles on `stream`,
// a programmatic dependent launch of the one before when `chained`.
template <typename T, bool kKMajorA, int BM, int BN>
cudaError_t launch_gemm(const Gemm<T>& g, Rect r0, Rect r1, int wait_last, bool chained, cudaStream_t stream) {
  return launch_step(gemm_kernel<T, kKMajorA, BM, BN>, dim3(r0.tiles + r1.tiles), dim3(kGemmThreads),
                     gemm_smem<kKMajorA, BM, BN>(), stream, chained, g, r0, r1, wait_last);
}

// The shared memory attributes of the three tiles of one variant, set once
// per device (device_sms).
template <typename T, bool kKMajorA>
cudaError_t allow_gemm_smem() {
  cudaError_t err;
  if ((err = allow_smem(gemm_kernel<T, kKMajorA, 128, 128>, gemm_smem<kKMajorA, 128, 128>()))) return err;
  if ((err = allow_smem(gemm_kernel<T, kKMajorA, 128, 64>, gemm_smem<kKMajorA, 128, 64>()))) return err;
  return allow_smem(gemm_kernel<T, kKMajorA, 64, 64>, gemm_smem<kKMajorA, 64, 64>());
}

// g over the (rows, cols) rectangle at (o_r, o_c) of O, in the tile that
// splits it most evenly over `sms` SMs.
template <typename T, bool kKMajorA>
cudaError_t launch_gemm_rect(const Gemm<T>& g, int o_r, int o_c, int rows, int cols, int sms, int wait_last,
                             bool chained, cudaStream_t stream) {
  switch (pick_shape(rows, cols, sms)) {
    case 0:
      return launch_gemm<T, kKMajorA, 128, 128>(g, rect<128, 128>(o_r, o_c, rows, cols), Rect{}, wait_last, chained,
                                                stream);
    case 1:
      return launch_gemm<T, kKMajorA, 128, 64>(g, rect<128, 64>(o_r, o_c, rows, cols), Rect{}, wait_last, chained,
                                               stream);
    default:
      return launch_gemm<T, kKMajorA, 64, 64>(g, rect<64, 64>(o_r, o_c, rows, cols), Rect{}, wait_last, chained,
                                              stream);
  }
}

}  // namespace
