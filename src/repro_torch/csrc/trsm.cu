// Forward (unit-lower) and backward (upper) substitution on a packed no-pivot
// LU, fp32, for Hopper (sm_90a).  Three kernels, one block per RHS tile:
//
// solve_vmem_kernel — replaces src/repro/kernels/trsm.py:solve_vmem.
//   The block's (n, rt) RHS tile lives in shared memory (column-major, so
//   a row sweep is free of bank conflicts); the packed LU is read from L2.
//   The column-oriented sweep of the TPU kernel would read the row-major LU
//   down a column, one 32-byte sector per element.  Instead the sweep goes
//   in 32-row strips: one warp per RHS column solves the strip's (32, 32)
//   triangle with each lane holding one row in a register and the solved
//   value passed by __shfl_sync, then every thread retires one row below
//   (above, backward) the strip with a 32-wide dot product whose LU row
//   segment is one 128-byte line.  Bound: the LU's n^2 * 4 bytes, read once
//   per RHS tile; at small n the 2 * n/32 strip steps (each a barrier) bound
//   it instead.
//
// solve_tiled_kernel — replaces src/repro/kernels/trsm.py:solve_tiled.
//   The LU stays in device memory; the (B, B) diagonal tile is staged in
//   shared memory for the in-tile sweep, and each off-diagonal tile is
//   streamed through shared memory 32 rows at a time and retired against
//   the solved (B, <=32) block of x with one small product.  x lives in
//   device memory.  Bound: the LU's bytes; one RHS tile runs on one SM, so
//   a single RHS reads the whole LU through one SM (a later split of the
//   sweep across blocks lifts that).
//
// solve_inverted_kernel — replaces src/repro/kernels/trsm.py:solve_inverted.
//   The same sweep with every diagonal step one product against the
//   factor-time inverse linv[i] / uinv[i] (streamed 32 rows at a time) in
//   place of the in-tile recurrence.  One block per equalized RHS tile; the
//   block walks its tile in 32-column groups.  Bound and single-SM limit as
//   for solve_tiled.
//
// All three treat rows and columns past n as the identity tail of the
// reference's padding, without materialising a padded copy of the LU.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kStrip = 32;    // strip height of solve_vmem
constexpr int kCols = 32;     // RHS columns a solve_tiled/inverted block holds at once
constexpr int kChunk = 32;    // rows of a (B, B) operand staged per product step

extern __shared__ float smem[];

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
// shared pieces of solve_tiled and solve_inverted
// ---------------------------------------------------------------------------
__device__ __forceinline__ int pow2_at_least(int w) {
  int p = 1;
  while (p < w) p <<= 1;
  return p;
}

// dst[r * lds + k] = A[row0 + r][col0 + k] for r < rows, k < K, where A is
// row-major with stride ld and is the identity past `lim` in either index.
__device__ void stage_rows(float* dst, int lds, const float* src, int ld, int lim,
                           int row0, int col0, int rows, int K) {
  const int total = rows * K;
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x;
      const int r = row0 + idx / K, c = col0 + idx % K;
      v[u] = idx >= total ? 0.f
           : (r < lim && c < lim) ? src[(size_t)r * ld + c] : (r == c ? 1.f : 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) dst[(idx / K) * lds + idx % K] = v[u];
    }
  }
}

// Y[r][c] = x[row0 + r][col0 + c] for the (B, w) block; rows past n read 0.
__device__ void load_x(float* Y, const float* x, int n, int m, int row0, int B, int col0, int w) {
  for (int idx = threadIdx.x; idx < B * kCols; idx += blockDim.x) {
    const int r = idx / kCols, c = idx % kCols;
    Y[idx] = (c < w && row0 + r < n) ? x[(size_t)(row0 + r) * m + col0 + c] : 0.f;
  }
}

__device__ void store_x(const float* Y, float* x, int n, int m, int row0, int B, int col0, int w) {
  for (int idx = threadIdx.x; idx < B * kCols; idx += blockDim.x) {
    const int r = idx / kCols, c = idx % kCols;
    if (c < w && row0 + r < n) x[(size_t)(row0 + r) * m + col0 + c] = Y[idx];
  }
}

// For each output (r, c), r < rows, c < w: acc = sum_k A[r][k] * Y[k][c],
// then emit(r, c, acc).  `cw` (a power of two >= w) lanes share one row of
// A, so a row read is a broadcast and rows differ by the odd stride lds.
template <class Emit>
__device__ void product(const float* A, int lds, int rows, int K, const float* Y, int w, int cw,
                        Emit emit) {
  for (int idx = threadIdx.x; idx < rows * cw; idx += blockDim.x) {
    const int r = idx / cw, c = idx % cw;
    if (c >= w) continue;
    const float* ar = A + r * lds;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += ar[k] * Y[k * kCols + c];
    emit(r, c, acc);
  }
}

// x[rows rb .. rb+B) -= A_tile(rb, cb) * Y, the tile streamed from `src`
// kChunk rows at a time through `A`; rows past n are skipped.
__device__ void retire(float* A, const float* lu, int n, int rb, int cb, int B,
                       const float* Y, float* x, int m, int col0, int w, int cw) {
  const int lds = B + 1;
  for (int ch = 0; ch < B && rb + ch < n; ch += kChunk) {
    const int rows = min(kChunk, min(B - ch, n - rb - ch));
    stage_rows(A, lds, lu, n, n, rb + ch, cb, rows, B);
    __syncthreads();
    product(A, lds, rows, B, Y, w, cw, [&](int r, int c, float acc) {
      x[(size_t)(rb + ch + r) * m + col0 + c] -= acc;
    });
    __syncthreads();
  }
}

__device__ void copy_columns(const float* b, float* x, int n, int m, int c_begin, int c_end) {
  const int w = c_end - c_begin;
  for (int idx = threadIdx.x; idx < n * w; idx += blockDim.x) {
    const size_t at = (size_t)(idx / w) * m + c_begin + idx % w;
    x[at] = b[at];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// solve_tiled
// ---------------------------------------------------------------------------
__global__ void solve_tiled_kernel(const float* __restrict__ lu, const float* __restrict__ b,
                                   float* __restrict__ x, int n, int m, int B, int S) {
  const int ldt = B + 1;
  float* T = smem;              // (B, B+1) diagonal tile
  float* Y = T + B * ldt;       // (B, kCols) block of x
  float* A = Y + B * kCols;     // (kChunk, B+1) staged rows of an off-diagonal tile
  const int col0 = blockIdx.x * kCols;
  const int w = min(kCols, m - col0);
  const int cw = pow2_at_least(w);
  copy_columns(b, x, n, m, col0, col0 + w);

  for (int i = 0; i < S; ++i) {
    stage_rows(T, ldt, lu, n, n, i * B, i * B, B, B);
    load_x(Y, x, n, m, i * B, B, col0, w);
    __syncthreads();
    for (int k = 0; k < B - 1; ++k) {
      for (int idx = threadIdx.x; idx < (B - k - 1) * cw; idx += blockDim.x) {
        const int r = k + 1 + idx / cw, c = idx % cw;
        if (c < w) Y[r * kCols + c] -= T[r * ldt + k] * Y[k * kCols + c];
      }
      __syncthreads();
    }
    store_x(Y, x, n, m, i * B, B, col0, w);
    for (int r = i + 1; r < S; ++r) retire(A, lu, n, r * B, i * B, B, Y, x, m, col0, w, cw);
    __syncthreads();
  }

  for (int i = S - 1; i >= 0; --i) {
    stage_rows(T, ldt, lu, n, n, i * B, i * B, B, B);
    load_x(Y, x, n, m, i * B, B, col0, w);
    __syncthreads();
    for (int k = B - 1; k >= 0; --k) {
      if (threadIdx.x < w) Y[k * kCols + threadIdx.x] /= T[k * ldt + k];
      __syncthreads();
      for (int idx = threadIdx.x; idx < k * cw; idx += blockDim.x) {
        const int r = idx / cw, c = idx % cw;
        if (c < w) Y[r * kCols + c] -= T[r * ldt + k] * Y[k * kCols + c];
      }
      __syncthreads();
    }
    store_x(Y, x, n, m, i * B, B, col0, w);
    for (int r = 0; r < i; ++r) retire(A, lu, n, r * B, i * B, B, Y, x, m, col0, w, cw);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// solve_inverted
// ---------------------------------------------------------------------------
// Y = inv * X for one (B, B) inverse, streamed kChunk rows at a time.
__device__ void apply_inverse(float* A, const float* inv, int B, const float* X, float* Y,
                              int w, int cw) {
  for (int ch = 0; ch < B; ch += kChunk) {
    const int rows = min(kChunk, B - ch);
    stage_rows(A, B + 1, inv, B, B, ch, 0, rows, B);
    __syncthreads();
    product(A, B + 1, rows, B, X, w, cw, [&](int r, int c, float acc) {
      Y[(ch + r) * kCols + c] = acc;
    });
    __syncthreads();
  }
}

__global__ void solve_inverted_kernel(const float* __restrict__ lu, const float* __restrict__ linv,
                                      const float* __restrict__ uinv, const float* __restrict__ b,
                                      float* __restrict__ x, int n, int m, int B, int S, int rt) {
  float* X = smem;              // (B, kCols) block of x
  float* Y = X + B * kCols;     // (B, kCols) solved block
  float* A = Y + B * kCols;     // (kChunk, B+1) staged rows
  const int c_begin = blockIdx.x * rt;
  const int c_end = min(m, c_begin + rt);
  const size_t bb = (size_t)B * B;
  copy_columns(b, x, n, m, c_begin, c_end);

  for (int col0 = c_begin; col0 < c_end; col0 += kCols) {
    const int w = min(kCols, c_end - col0);
    const int cw = pow2_at_least(w);
    for (int i = 0; i < S; ++i) {
      load_x(X, x, n, m, i * B, B, col0, w);
      __syncthreads();
      apply_inverse(A, linv + i * bb, B, X, Y, w, cw);
      store_x(Y, x, n, m, i * B, B, col0, w);
      for (int r = i + 1; r < S; ++r) retire(A, lu, n, r * B, i * B, B, Y, x, m, col0, w, cw);
      __syncthreads();
    }
    for (int i = S - 1; i >= 0; --i) {
      load_x(X, x, n, m, i * B, B, col0, w);
      __syncthreads();
      apply_inverse(A, uinv + i * bb, B, X, Y, w, cw);
      store_x(Y, x, n, m, i * B, B, col0, w);
      for (int r = 0; r < i; ++r) retire(A, lu, n, r * B, i * B, B, Y, x, m, col0, w, cw);
      __syncthreads();
    }
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

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

// Same solve with (B, B) LU tiles, S = ceil(n / B); one block per kCols columns.
extern "C" int ebv_solve_tiled(const void* lu, const void* b, void* x, int n, int m, int B,
                               int threads, void* stream) {
  const int S = (n + B - 1) / B;
  const size_t bytes = ((size_t)B * (B + 1) + (size_t)B * kCols + (size_t)kChunk * (B + 1)) * sizeof(float);
  cudaError_t err = allow_smem(solve_tiled_kernel, bytes);
  if (err) return err;
  solve_tiled_kernel<<<(m + kCols - 1) / kCols, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lu), static_cast<const float*>(b), static_cast<float*>(x), n, m, B, S);
  return cudaGetLastError();
}

// Same solve from the (S, B, B) inverses of the identity-padded LU's diagonal
// blocks; one block per `rt` RHS columns.
extern "C" int ebv_solve_inverted(const void* lu, const void* linv, const void* uinv, const void* b,
                                  void* x, int n, int m, int B, int S, int rt, int threads,
                                  void* stream) {
  const size_t bytes = (2 * (size_t)B * kCols + (size_t)kChunk * (B + 1)) * sizeof(float);
  cudaError_t err = allow_smem(solve_inverted_kernel, bytes);
  if (err) return err;
  solve_inverted_kernel<<<(m + rt - 1) / rt, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lu), static_cast<const float*>(linv), static_cast<const float*>(uinv),
      static_cast<const float*>(b), static_cast<float*>(x), n, m, B, S, rt);
  return cudaGetLastError();
}
