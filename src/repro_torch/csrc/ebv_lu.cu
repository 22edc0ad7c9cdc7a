// Blocked no-pivot EbV LU factorization for Hopper (sm_90a), fp32, in place.
//
// Replaces: src/repro/kernels/ebv_lu.py:lu_fused, the single-dispatch Pallas
// megakernel whose grid (step s, program p) relied on the TPU running grid
// programs in order: program 0 of step s factored the panel into scratch
// that every later program of the step read.  CUDA blocks run in no order,
// so here each step is four launches in stream order on the identity-padded
// (N, N) matrix, N = S*B:
//   1. diag_factor_kernel     one block factors the (B, B) diagonal tile in
//                             shared memory (rank-1 bi-vector steps);
//   2. lower_panel_kernel     L21 = A21 * U11^-1, one block per 32 rows;
//   3. upper_panel_kernel     U12 = L11^-1 * A12, one block per 64 columns;
//   4. trailing_update_kernel A22 -= L21 * U12, one block per 64x64 tile.
// That is 4S-3 launches (the last step has no trailing matrix).
//
// The TPU kernel's eq.-7 fold (program p owns trailing tiles p+1 and S-1-p,
// so each program's lifetime work is the constant S) only balances an
// executor that persists across steps.  With one launch per step every
// block of a launch has the same work, so the fold has nothing to do here;
// a persistent kernel with a grid barrier per step would use it.
//
// What bounds it: the trailing updates do almost all of the 2n^3/3 flops, so
// at large n the bound is fp32 operations (67 TFLOP/s outside the tensor
// cores); the diagonal tile factor and the two panel solves are short
// serial chains on few SMs and set a floor per step.  The design
// keeps every step's tile in shared memory (the diagonal tile with a row
// stride of B+1 so column reads are free of bank conflicts) and runs the
// update as a register-blocked 64x64 SGEMM tile per block.  No wgmma/TMA:
// making it fast is later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kDiagThreads = 1024;
constexpr int kPanelThreads = 256;
constexpr int kLowerRows = 32;   // rows of L21 per block
constexpr int kUpperCols = 64;   // columns of U12 per block
constexpr int kTile = 64;        // trailing-update output tile
constexpr int kDepth = 16;       // trailing-update k step

extern __shared__ float smem[];

__global__ void diag_factor_kernel(float* a, int N, int base, int B) {
  float* t = smem;
  const int ld = B + 1;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int i = idx / B, j = idx % B;
    t[i * ld + j] = a[(size_t)(base + i) * N + base + j];
  }
  __syncthreads();
  for (int k = 0; k < B - 1; ++k) {
    const float piv = t[k * ld + k];
    for (int i = k + 1 + threadIdx.x; i < B; i += blockDim.x) t[i * ld + k] /= piv;
    __syncthreads();
    const int w = B - k - 1;
    for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
      const int i = k + 1 + idx / w, j = k + 1 + idx % w;
      t[i * ld + j] -= t[i * ld + k] * t[k * ld + j];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int i = idx / B, j = idx % B;
    a[(size_t)(base + i) * N + base + j] = t[i * ld + j];
  }
}

// Rows below the diagonal tile: solve x * U11 = a for each row (right
// solve against the upper triangle, diagonal division included).
__global__ void lower_panel_kernel(float* a, int N, int base, int B) {
  float* s = smem;
  const int ld = B + 1;
  const int row0 = base + B + blockIdx.x * kLowerRows;
  const int rows = min(kLowerRows, N - row0);
  for (int idx = threadIdx.x; idx < rows * B; idx += blockDim.x) {
    const int r = idx / B, j = idx % B;
    s[r * ld + j] = a[(size_t)(row0 + r) * N + base + j];
  }
  __syncthreads();
  const float* urow = a + (size_t)base * N + base;  // U11, row stride N
  for (int k = 0; k < B; ++k) {
    const float ukk = urow[(size_t)k * N + k];
    for (int r = threadIdx.x; r < rows; r += blockDim.x) s[r * ld + k] /= ukk;
    __syncthreads();
    const int w = B - k - 1;
    for (int idx = threadIdx.x; idx < rows * w; idx += blockDim.x) {
      const int r = idx / w, j = k + 1 + idx % w;
      s[r * ld + j] -= s[r * ld + k] * urow[(size_t)k * N + j];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < rows * B; idx += blockDim.x) {
    const int r = idx / B, j = idx % B;
    a[(size_t)(row0 + r) * N + base + j] = s[r * ld + j];
  }
}

// Columns right of the diagonal tile: forward-substitute each column
// against the unit-lower triangle of the factored diagonal tile.
__global__ void upper_panel_kernel(float* a, int N, int base, int B) {
  float* s = smem;  // B x kUpperCols
  const int col0 = base + B + blockIdx.x * kUpperCols;
  const int cols = min(kUpperCols, N - col0);
  for (int idx = threadIdx.x; idx < B * kUpperCols; idx += blockDim.x) {
    const int i = idx / kUpperCols, c = idx % kUpperCols;
    s[idx] = c < cols ? a[(size_t)(base + i) * N + col0 + c] : 0.f;
  }
  __syncthreads();
  const float* lcol = a + (size_t)base * N + base;  // L11, row stride N
  for (int k = 0; k < B - 1; ++k) {
    const int w = B - k - 1;
    for (int idx = threadIdx.x; idx < w * kUpperCols; idx += blockDim.x) {
      const int i = k + 1 + idx / kUpperCols, c = idx % kUpperCols;
      s[i * kUpperCols + c] -= lcol[(size_t)i * N + k] * s[k * kUpperCols + c];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < B * kUpperCols; idx += blockDim.x) {
    const int i = idx / kUpperCols, c = idx % kUpperCols;
    if (c < cols) a[(size_t)(base + i) * N + col0 + c] = s[idx];
  }
}

// A22 -= L21 * U12 over the trailing (M, M) matrix, M = N - base - B.
// 256 threads, each accumulating a 4x4 block of one 64x64 output tile.
__global__ void trailing_update_kernel(float* a, int N, int base, int B) {
  __shared__ float As[kDepth][kTile + 4];
  __shared__ __align__(16) float Bs[kDepth][kTile];
  const int t0 = base + B;
  const int M = N - t0;
  const int bi = blockIdx.y * kTile, bj = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < B; k0 += kDepth) {
    for (int l = threadIdx.x; l < kTile * kDepth; l += blockDim.x) {
      const int r = l / kDepth, kk = l % kDepth;
      const bool ok = bi + r < M && k0 + kk < B;
      As[kk][r] = ok ? a[(size_t)(t0 + bi + r) * N + base + k0 + kk] : 0.f;
    }
    for (int l = threadIdx.x; l < kDepth * kTile; l += blockDim.x) {
      const int kk = l / kTile, c = l % kTile;
      const bool ok = bj + c < M && k0 + kk < B;
      Bs[kk][c] = ok ? a[(size_t)(base + k0 + kk) * N + t0 + bj + c] : 0.f;
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
        acc[i][0] += ar[i] * br.x;
        acc[i][1] += ar[i] * br.y;
        acc[i][2] += ar[i] * br.z;
        acc[i][3] += ar[i] * br.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = bi + ty * 4 + i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = bj + tx * 4 + j;
      if (gj < M) a[(size_t)(t0 + gi) * N + t0 + gj] -= acc[i][j];
    }
  }
}

}  // namespace

extern "C" const char* ebv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Factor the identity-padded (N, N) row-major fp32 matrix `a` in place, in
// S = N / B steps.  Launches 4S-3 kernels on `stream` and stores in
// `*launches` how many it launched; returns the first launch error, or 0.
extern "C" int ebv_lu_fused(void* a_ptr, int N, int B, void* stream_ptr, int* launches) {
  float* a = static_cast<float*>(a_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  const int S = N / B;
  const int diag_smem = B * (B + 1) * static_cast<int>(sizeof(float));
  const int lower_smem = kLowerRows * (B + 1) * static_cast<int>(sizeof(float));
  const int upper_smem = B * kUpperCols * static_cast<int>(sizeof(float));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(diag_factor_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, diag_smem)))
    return err;
  if ((err = cudaFuncSetAttribute(upper_panel_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, upper_smem)))
    return err;
  for (int s = 0; s < S; ++s) {
    const int base = s * B;
    diag_factor_kernel<<<1, kDiagThreads, diag_smem, stream>>>(a, N, base, B);
    if ((err = cudaGetLastError())) return err;
    ++*launches;
    if (s == S - 1) break;
    const int M = N - base - B;
    lower_panel_kernel<<<(M + kLowerRows - 1) / kLowerRows, kPanelThreads, lower_smem, stream>>>(
        a, N, base, B);
    if ((err = cudaGetLastError())) return err;
    ++*launches;
    upper_panel_kernel<<<(M + kUpperCols - 1) / kUpperCols, kPanelThreads, upper_smem, stream>>>(
        a, N, base, B);
    if ((err = cudaGetLastError())) return err;
    ++*launches;
    const dim3 grid((M + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    trailing_update_kernel<<<grid, 256, 0, stream>>>(a, N, base, B);
    if ((err = cudaGetLastError())) return err;
    ++*launches;
  }
  return 0;
}
