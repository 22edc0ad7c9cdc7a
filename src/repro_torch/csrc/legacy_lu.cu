// The legacy dense EbV kernels for Hopper (sm_90a): the paper-faithful
// unblocked factor, the tall-panel factor, the fused bi-vector step and the
// rank-k trailing update.  Each is templated on its element type, fp32 or
// bf16; in bf16 every operation is computed in fp32 and rounded to bf16 at
// once, as PyTorch's elementwise bf16 ops round, and products accumulate in
// fp32.
//
// ebv_walk_kernel — replaces src/repro/kernels/ebv_lu.py:lu_vmem (n-1 steps
//   on the whole (n, n) matrix) and :panel (b steps on a tall (m, b) panel,
//   pivots in the top b rows).  Both run the step body _lu_body of that file:
//   for pivot k, the column below the pivot divided by it, the rank-1 Schur
//   update of the block right of and below it, the multipliers written back
//   into column k.  The TPU kernel holds the whole matrix in VMEM (64 MB at
//   n = 4096); one H100 block has 227 KB of shared memory and the 50 MB L2
//   does not hold that matrix either, so the kernel walks device memory.
//   It is ONE cooperative launch (cudaLaunchCooperativeKernel, grid sized by
//   the occupancy calculator so that every block is resident) with a grid
//   barrier per step.  Rows are owned for the whole factorization by the
//   paper's equalized pairing (core/ebv.py:equalized_pairing): vector r
//   (0 <= r <= m-2) is row r+1, which is live for r+1 steps, and unit
//   (r, m-2-r) pairs it with row m-1-r, live for m-1-r steps, so every unit
//   carries the same m row-steps.  Block c owns units c, c+G, c+2G, ...;
//   its rows, taken in decreasing order, are live as a prefix of that list.
//   Only the owner writes a row; every block reads the pivot row, which no
//   block writes during its step, through L2 (__ldcg: another SM wrote it a
//   step ago) into shared memory.  The barrier is a generation counter in
//   device memory (two unsigned ints the wrapper zeroes before the launch).
//   IEEE divide, multiply and subtract with no contraction into fused
//   multiply-adds make the factor equal, value for value, to the plain
//   version (kernels/ebv_lu.py:lu_vmem_plain / panel_plain) on finite input.
//   Bound: 2n^3/3 flops in 2n^3/3 separately rounded operations; the walk
//   moves the trailing block through L2 or HBM once a step (~8n^3/3 bytes),
//   so it is bound by that traffic and by n-1 grid barriers.
//
// fused_step_kernel — replaces src/repro/kernels/ebv_lu.py:fused_step: per
//   column tile, U12 = L11^-1 A12 (unit lower, b sequential masked axpys)
//   and then A22 - L21 U12.  The TPU kernel keeps the whole (m, b) panel in
//   VMEM (8 MB at m = 8000, b = 256); here a block owns 32 columns and 128
//   trailing rows, solves its 32 columns of U12 in shared memory with L11
//   streamed through a 32-column strip, then forms its (128, 32) block of
//   L21 U12 with L21 streamed through the same strip.  Columns are
//   independent, so the internal 32-column tiling gives the caller's
//   col_tile result.  The solve repeats in every row chunk of a column
//   (one launch per step, as the TPU kernel is one pallas_call); the blocks
//   of row chunk 0 store U12.  The solve rounds as the plain version does;
//   the product accumulates in fp32 in k order and rounds once.
//
// update_kernel — replaces src/repro/kernels/ebv_lu.py:update: A22 - L21 U12
//   on a grid of 64 x 64 output tiles, L21 and U12 streamed through shared
//   memory 16 deep, a 4 x 4 register block per thread, fp32 accumulation,
//   one rounding to the output type.  Bound: 2mbw flops (fp32 outside the
//   tensor cores) against (mb + bw + 2mw) elements of traffic.  No wgmma or
//   TMA: making these fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWalkThreads = 512;    // 16 warps; a warp updates one row at a time
constexpr int kWalkBlocksPerSm = 2;  // caps the barrier's arrivals at 2 x #SMs
constexpr int kInFlight = 4;         // row entries a lane loads before it stores
constexpr int kStepCols = 32;        // U12 / trailing columns per fused-step block
constexpr int kStepRows = 128;       // trailing rows per fused-step block
constexpr int kStepThreads = 256;
constexpr int kStrip = 32;           // L11 / L21 columns staged at once
constexpr int kTile = 64;            // update output tile
constexpr int kDepth = 16;           // update k step
constexpr int kSmemMax = 232448;     // dynamic shared memory one H100 block may use

extern __shared__ float smem[];

// element loads and stores: fp32 values in registers, T in memory
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_l2(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v rounded to T (the identity for fp32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Grid barrier of a cooperative launch: bar[0] counts arrivals, bar[1] is
// the generation the waiting blocks watch.  A wait longer than
// kBarrierCycles (seconds) traps, so a broken barrier ends the launch with
// an error instead of holding the card.
constexpr long long kBarrierCycles = 20000000000LL;

__device__ void grid_sync(unsigned* bar, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        __nanosleep(64);
        if (clock64() - t0 > kBarrierCycles) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Row of position t in block c's owned list, decreasing: first the high rows
// m-1-u of its J units u = c, c+G, ..., then the low rows u+1 of the first
// Jl of them (Jl = J less the middle singleton u+1 == m-1-u, counted once).
__device__ __forceinline__ int owned_row(int t, int c, int G, int m, int J, int Jl) {
  if (t < J) return m - 1 - (c + t * G);
  return c + (Jl - 1 - (t - J)) * G + 1;
}

template <typename T>
__global__ void __launch_bounds__(kWalkThreads) ebv_walk_kernel(T* a, int m, int ncols, int steps,
                                                                unsigned* bar) {
  float* prow = smem;  // the pivot row, ncols floats
  __shared__ int s_live;
  const int c = blockIdx.x, G = gridDim.x;
  const int units = m / 2;  // equalized_pairing over the m-1 updatable rows
  const int J = c < units ? (units - c + G - 1) / G : 0;
  const bool singleton = (m % 2 == 0) && J > 0 && c + (J - 1) * G == units - 1;
  const int Jl = J - (singleton ? 1 : 0), owned = J + Jl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int live = owned;
  for (int k = 0; k < steps; ++k) {
    if (k) grid_sync(bar, G);
    for (int j = k + threadIdx.x; j < ncols; j += blockDim.x)
      prow[j] = load_l2(a + (size_t)k * ncols + j);
    if (threadIdx.x == 0) {
      while (live > 0 && owned_row(live - 1, c, G, m, J, Jl) <= k) --live;
      s_live = live;
    }
    __syncthreads();
    const float piv = prow[k];
    const int nl = s_live;
    for (int t = warp; t < nl; t += nwarps) {
      T* row = a + (size_t)owned_row(t, c, G, m, J, Jl) * ncols;
      float l = 0.f;
      if (lane == 0) l = rnd<T>(__fdiv_rn(load(row + k), piv));
      l = __shfl_sync(0xffffffffu, l, 0);
      for (int j0 = k + 1 + lane; j0 < ncols; j0 += 32 * kInFlight) {
        float v[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int j = j0 + 32 * q;
          v[q] = j < ncols ? load(row + j) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int j = j0 + 32 * q;
          if (j < ncols) store(row + j, __fsub_rn(v[q], rnd<T>(__fmul_rn(l, prow[j]))));
        }
      }
      if (lane == 0) store(row + k, l);
    }
  }
}

// grid (column strips of 32, row chunks of 128); pan (m, b), top (b, w),
// trail (m-b, w) row-major; u12 (b, w), out (m-b, w).
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
fused_step_kernel(const T* __restrict__ pan, const T* __restrict__ top, const T* __restrict__ trail,
                  T* __restrict__ u12, T* __restrict__ out, int m, int b, int w) {
  const int ldy = b + 1;
  float* ys = smem;                          // U12 block, column-major: ys[c * ldy + i]
  float* ls = smem + kStepCols * ldy;        // a staged strip: ls[r * (kStrip + 1) + l]
  constexpr int lds = kStrip + 1;
  const int col0 = blockIdx.x * kStepCols;
  const int cols = min(kStepCols, w - col0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = kStepThreads / 32;
  for (int idx = tid; idx < b * kStepCols; idx += kStepThreads) {
    const int i = idx / kStepCols, cc = idx % kStepCols;
    ys[cc * ldy + i] = cc < cols ? load(top + (size_t)i * w + col0 + cc) : 0.f;
  }
  // U12 = L11^-1 A12: y_i -= l_ik y_k for k = 0, 1, ..., each column by one warp
  for (int s0 = 0; s0 < b; s0 += kStrip) {
    const int kw = min(kStrip, b - s0);
    __syncthreads();
    for (int idx = tid; idx < b * kw; idx += kStepThreads) {
      const int i = idx / kw, l = idx % kw;
      ls[i * lds + l] = load(pan + (size_t)i * b + s0 + l);
    }
    __syncthreads();
    for (int cc = warp; cc < cols; cc += nwarps) {
      float* y = ys + cc * ldy;
      for (int l = 0; l < kw; ++l) {
        const int k = s0 + l;
        const float yk = y[k];
        for (int i = k + 1 + lane; i < b; i += 32)
          y[i] = rnd<T>(__fsub_rn(y[i], rnd<T>(__fmul_rn(ls[i * lds + l], yk))));
        __syncwarp();
      }
    }
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    for (int idx = tid; idx < b * cols; idx += kStepThreads) {
      const int i = idx / cols, cc = idx % cols;
      store(u12 + (size_t)i * w + col0 + cc, ys[cc * ldy + i]);
    }
  }
  // A22 - L21 U12 for rows r0 .. r0+127: thread (tx, ty) owns column tx and
  // rows ty, ty+8, ...
  const int mt = m - b, r0 = blockIdx.y * kStepRows;
  const int rows = min(kStepRows, mt - r0);
  if (rows <= 0) return;
  const int tx = tid & 31, ty = tid >> 5;
  constexpr int kPer = kStepRows / (kStepThreads / 32);
  float acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) acc[q] = 0.f;
  for (int s0 = 0; s0 < b; s0 += kStrip) {
    const int kw = min(kStrip, b - s0);
    __syncthreads();
    for (int idx = tid; idx < rows * kw; idx += kStepThreads) {
      const int r = idx / kw, l = idx % kw;
      ls[r * lds + l] = load(pan + (size_t)(b + r0 + r) * b + s0 + l);
    }
    __syncthreads();
    for (int l = 0; l < kw; ++l) {
      const float yk = ys[tx * ldy + s0 + l];
#pragma unroll
      for (int q = 0; q < kPer; ++q) acc[q] = fmaf(ls[(ty + 8 * q) * lds + l], yk, acc[q]);
    }
  }
  if (tx < cols) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int r = ty + 8 * q;
      if (r < rows) {
        const size_t at = (size_t)(r0 + r) * w + col0 + tx;
        store(out + at, __fsub_rn(load(trail + at), rnd<T>(acc[q])));
      }
    }
  }
}

// o = c - l u for l (m, kd), u (kd, w), c and o (m, w), row-major; 256
// threads, each accumulating a 4 x 4 block of one 64 x 64 output tile.
template <typename T>
__global__ void __launch_bounds__(256)
update_kernel(const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ c,
              T* __restrict__ o, int m, int kd, int w) {
  __shared__ float As[kDepth][kTile + 4];
  __shared__ __align__(16) float Bs[kDepth][kTile];
  const int bi = blockIdx.y * kTile, bj = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < kd; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += blockDim.x) {
      const int r = e / kDepth, kk = e % kDepth;
      As[kk][r] = (bi + r < m && k0 + kk < kd) ? load(l + (size_t)(bi + r) * kd + k0 + kk) : 0.f;
    }
    for (int e = threadIdx.x; e < kDepth * kTile; e += blockDim.x) {
      const int kk = e / kTile, cc = e % kTile;
      Bs[kk][cc] = (bj + cc < w && k0 + kk < kd) ? load(u + (size_t)(k0 + kk) * w + bj + cc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float ar[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = As[kk][ty * 4 + i];
      const float4 br = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(ar[i], br.x, acc[i][0]);
        acc[i][1] = fmaf(ar[i], br.y, acc[i][1]);
        acc[i][2] = fmaf(ar[i], br.z, acc[i][2]);
        acc[i][3] = fmaf(ar[i], br.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = bi + ty * 4 + i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = bj + tx * 4 + j;
      if (gj < w) {
        const size_t at = (size_t)gi * w + gj;
        store(o + at, __fsub_rn(load(c + at), rnd<T>(acc[i][j])));
      }
    }
  }
}

template <typename T>
cudaError_t launch_walk(void* a, int m, int ncols, int steps, void* bar, cudaStream_t stream,
                        int* launched) {
  auto kernel = ebv_walk_kernel<T>;
  const size_t bytes = (size_t)ncols * sizeof(float);
  if (bytes > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err) return err;
  int device = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device))) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWalkThreads, bytes)))
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int units = m / 2;
  int grid = (per_sm < kWalkBlocksPerSm ? per_sm : kWalkBlocksPerSm) * sms;
  if (grid > units) grid = units;
  unsigned* barrier = static_cast<unsigned*>(bar);
  T* mat = static_cast<T*>(a);
  void* args[] = {&mat, &m, &ncols, &steps, &barrier};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(kWalkThreads),
                                    args, bytes, stream);
  if (err) return err;
  *launched = 1;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused_step(const void* pan, const void* top, const void* trail, void* u12,
                              void* out, int m, int b, int w, cudaStream_t stream) {
  auto kernel = fused_step_kernel<T>;
  const int strip_rows = b > kStepRows ? b : kStepRows;  // the strip holds L11 or 128 rows of L21
  const size_t bytes =
      ((size_t)kStepCols * (b + 1) + (size_t)strip_rows * (kStrip + 1)) * sizeof(float);
  if (bytes > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err) return err;
  const int chunks = m - b > 0 ? (m - b + kStepRows - 1) / kStepRows : 1;
  const dim3 grid((w + kStepCols - 1) / kStepCols, chunks);
  kernel<<<grid, kStepThreads, bytes, stream>>>(
      static_cast<const T*>(pan), static_cast<const T*>(top), static_cast<const T*>(trail),
      static_cast<T*>(u12), static_cast<T*>(out), m, b, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_update(const void* l, const void* u, const void* c, void* o, int m, int kd,
                          int w, cudaStream_t stream) {
  const dim3 grid((w + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  update_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(l), static_cast<const T*>(u),
                                             static_cast<const T*>(c), static_cast<T*>(o), m, kd, w);
  return cudaGetLastError();
}

}  // namespace

// In place, the first `steps` EbV steps on the row-major (m, ncols) matrix
// `a` (fp32, or bf16 when `bf16` is 1): lu_vmem with m = ncols and
// steps = n - 1, panel with steps = b.  `bar` points to two zeroed unsigned
// ints (the grid barrier).  One cooperative launch when there is a row to
// update; `*launched` says how many were made.
extern "C" int ebv_legacy_walk(void* a, int m, int ncols, int steps, int bf16, void* bar,
                               void* stream, int* launched) {
  *launched = 0;
  if (steps <= 0 || m < 2) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_walk<__nv_bfloat16>(a, m, ncols, steps, bar, s, launched)
              : launch_walk<float>(a, m, ncols, steps, bar, s, launched);
}

// u12 = L11^-1 top and out = trail - L21 u12 for the packed panel pan (m, b),
// top (b, w) and trail (m - b, w); one launch.
extern "C" int ebv_legacy_fused_step(const void* pan, const void* top, const void* trail, void* u12,
                                     void* out, int m, int b, int w, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused_step<__nv_bfloat16>(pan, top, trail, u12, out, m, b, w, s)
              : launch_fused_step<float>(pan, top, trail, u12, out, m, b, w, s);
}

// o = c - l u for l (m, kd), u (kd, w), c and o (m, w); one launch.
extern "C" int ebv_legacy_update(const void* l, const void* u, const void* c, void* o, int m, int kd,
                                 int w, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_update<__nv_bfloat16>(l, u, c, o, m, kd, w, s)
              : launch_update<float>(l, u, c, o, m, kd, w, s);
}
