// Banded no-pivot EbV LU and its solves on the row-aligned band, fp32, for
// Hopper (sm_90a).  The band is stored row-aligned: row i holds
// A[i, i-bw .. i+bw] in 2bw+1 floats, so A[i, j] is band[i * W + j - i + bw].
//
// The factor is a chain along the diagonal: pivot p scales the bw entries
// below it (the L bi-vector) and applies a rank-1 update to the bw x bw
// block it reaches.  Every entry sees the same scalar operations in the same
// pivot order whatever the block size, so the reference's blocked factor
// does not depend on its block C.  The kernels below walk the chain pivot by
// pivot and use IEEE round-to-nearest multiply, subtract and divide with no
// contraction into fused multiply-adds, so they compute the plain version's
// factor (repro_torch.core.banded.banded_lu_blocked) value for value.
//
// band_lu_resident_kernel — replaces src/repro/kernels/banded.py:
//   banded_lu_blocked, the Pallas megakernel that held the whole skewed band
//   in VMEM for ceil(n/C) window steps.  One launch, one block: the band is
//   streamed through a ring of R rows in shared memory (R*(2bw+1) floats, up
//   to 227 KB), so each band row is read once and written once and the bw
//   carry rows of a chunk stay on chip for the next.  Where not even bw+1
//   rows fit (bw > ~168), band_lu_global_kernel runs the same walk on the
//   band in device memory; its working set, bw+1 rows, stays in the 50 MB L2.
//
// band_lu_slab_kernel — replaces src/repro/kernels/banded.py:banded_lu_tiled,
//   whose grid steps ran in order on the TPU, step s+1 reading the carry rows
//   step s wrote.  CUDA blocks run in no order, so here each step is one
//   launch in stream order: S = ceil(n/C) launches, each staging its
//   (C+bw, 2bw+1) slab of the band through shared memory where it fits and
//   writing it back (band_lu_global_kernel per step otherwise).
//
//   Bound of both factors: n*(2bw^2+bw) flops and 2*n*(2bw+1)*4 bytes make
//   microseconds of work, but the n pivots are a dependent chain on one SM.
//   The chain, not the card, bounds them: the design keeps each pivot's
//   operands in shared memory (bw <= ~168), where a pivot costs one block
//   barrier and bw^2/threads updates (the device-memory walk takes two
//   barriers and L2 round trips per pivot).
//
// band_solve_kernel — replaces src/repro/kernels/banded.py:
//   banded_solve_kernelized.  One warp per RHS column walks the rows in
//   32-row strips, forward then backward: each lane holds one row, first
//   retires the rows of earlier strips (at most bw terms, read from a ring
//   of the warp's last solved values in shared memory), then the strip's
//   triangle is solved in registers with the solved value passed by
//   __shfl_sync.  No block barrier at all.  Bound: the band's n*(2bw+1)*4
//   bytes; a vector RHS runs on one SM, latency-bound by the n/32 strips.
//
// band_gemm_kernel + band_tail_scan_kernel — replace src/repro/kernels/
//   banded.py:banded_solve_inverted.  From the artifact's (S, C, C) inverses
//   and (S, C, bw) transfer blocks each sweep is a batched product over all S
//   blocks (many blocks in flight), the (bw, m) tail recurrence over S (one
//   block per 32 columns), and a second batched product: six launches in
//   stream order (two when S = 1).  Bound: the inverses' 2*S*C*C*4 bytes.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSmemBytes = 232448;  // dynamic shared memory one H100 block may use
constexpr int kTile = 32;           // batched-product tile and scan column group
constexpr int kInFlight = 8;        // band updates a factor thread loads before it stores

extern __shared__ float smem[];

// The band rows a factor kernel works on: a ring of R rows in shared memory
// (row i in slot i % R) or the band itself in device memory.
struct RingRows {
  float* s;
  int R, W;
  __device__ float* row(int i) const { return s + (size_t)(i % R) * W; }
  // row i + k, given slot = i % R and 0 <= k < R: no division
  __device__ float* row_after(int slot, int k) const {
    slot += k;
    return s + (size_t)(slot >= R ? slot - R : slot) * W;
  }
};

struct GlobalRows {
  float* g;
  int W;
  __device__ float* row(int i) const { return g + (size_t)i * W; }
};

// Retire pivots [p0, p1) of the band in device memory, rows at or past n
// absent.  Two barriers per pivot: the pivot's L column and U row go to
// lv/uv (bw floats each, shared memory), then thread (x, y) updates the
// items (r, c) of the bw x bw block with r = y (mod blockDim.y) and
// c = x (mod blockDim.x), keeping kInFlight loads outstanding before it
// stores: one L2 round trip per item, in sequence, would set the pace.
__device__ void retire_pivots_global(const GlobalRows& rows, float* lv, float* uv, int p0, int p1,
                                     int n, int bw) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  for (int p = p0; p < p1; ++p) {
    const int nr = min(bw, n - 1 - p);  // rows below the pivot
    if (nr <= 0) break;                 // the last pivot reaches no row
    const float* prow = rows.row(p);
    const float piv = prow[bw];
    for (int t = tid; t < 2 * bw; t += nt) {
      if (t < bw) {
        if (t < nr) {  // row p+1+t, column p: band column bw-1-t
          float* r = rows.row(p + 1 + t);
          const float l = __fdiv_rn(r[bw - 1 - t], piv);
          lv[t] = l;
          r[bw - 1 - t] = l;
        }
      } else {
        uv[t - bw] = prow[t + 1];  // A[p, p+1+(t-bw)]
      }
    }
    __syncthreads();
    for (int r = threadIdx.y; r < nr; r += blockDim.y) {
      float* row = rows.row(p + 1 + r) + bw - r;  // row[c] = A[p+1+r, p+1+c]
      const float l = lv[r];
      for (int c0 = threadIdx.x; c0 < bw; c0 += kInFlight * blockDim.x) {
        float v[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int c = c0 + q * blockDim.x;
          if (c < bw) v[q] = row[c];
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int c = c0 + q * blockDim.x;
          if (c < bw) row[c] = __fsub_rn(v[q], __fmul_rn(l, uv[c]));
        }
      }
    }
    __syncthreads();
  }
}

// Store the multipliers of pivot p, held in lb, into column p (band column
// bw-1-r of row p+1+r); the threads with threadIdx.x == 0 own the rows.
__device__ void store_multipliers(const RingRows& rows, const float* lb, int p, int pslot, int n,
                                  int bw) {
  if (threadIdx.x) return;
  const int nr = min(bw, n - 1 - p);
  for (int r = threadIdx.y; r < nr; r += blockDim.y) rows.row_after(pslot, 1 + r)[bw - 1 - r] = lb[r];
}

// Retire pivots [p0, p1) of the band staged in the shared-memory ring: one
// barrier per pivot.  Thread (x, y) owns the items (r, c) of the bw x bw
// block with r = y (mod blockDim.y) and c = x (mod blockDim.x) and divides
// the L entry of each of its rows itself (every thread of a row gets the
// same quotient).  The multipliers of pivot p are written into column p
// one pivot later, from the double buffer lbuf (2*bw floats): nobody reads
// column p during pivot p+1, so no second barrier has to separate the
// reads of the raw L column from its overwrite.
__device__ void retire_pivots_staged(const RingRows& rows, float* lbuf, int p0, int p1, int n,
                                     int bw) {
  int last = -1, lslot = 0;  // the pivot whose multipliers wait in lbuf, and its slot
  for (int p = p0, pslot = p0 % rows.R; p < p1; ++p, pslot = pslot + 1 == rows.R ? 0 : pslot + 1) {
    const int nr = min(bw, n - 1 - p);
    if (nr <= 0) break;
    if (last >= 0) store_multipliers(rows, lbuf + (last & 1) * bw, last, lslot, n, bw);
    const float* prow = rows.row_after(pslot, 0);
    const float piv = prow[bw];
    float* lb = lbuf + (p & 1) * bw;
    for (int r = threadIdx.y; r < nr; r += blockDim.y) {
      float* row = rows.row_after(pslot, 1 + r);
      const float l = __fdiv_rn(row[bw - 1 - r], piv);
      if (threadIdx.x == 0) lb[r] = l;
      for (int c = threadIdx.x; c < bw; c += blockDim.x) {  // A[p+1+r, p+1+c]
        float* a = row + bw + c - r;
        *a = __fsub_rn(*a, __fmul_rn(l, prow[bw + 1 + c]));
      }
    }
    last = p;
    lslot = pslot;
    __syncthreads();
  }
  if (last >= 0) store_multipliers(rows, lbuf + (last & 1) * bw, last, lslot, n, bw);
  __syncthreads();
}

__global__ void band_lu_resident_kernel(float* band, int n, int bw, int R, int C) {
  const int W = 2 * bw + 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const RingRows rows{smem, R, W};
  float* lbuf = smem + (size_t)R * W;
  const int first = min(R, n);
  for (int idx = tid; idx < first * W; idx += nt) smem[idx] = band[idx];
  __syncthreads();
  for (int k0 = 0; k0 < n; k0 += C) {
    const int k1 = min(k0 + C, n);
    retire_pivots_staged(rows, lbuf, k0, k1, n, bw);
    // rows k0..k1-1 are final (after the last chunk, every row is); their
    // slots take rows k0+R.., while the bw carry rows k1.. stay on chip.
    // One thread owns one slot element.
    for (int idx = tid; idx < (k1 - k0) * W; idx += nt) {
      const int i = k0 + idx / W, t = idx % W;
      float* slot = rows.row(i) + t;
      band[(size_t)i * W + t] = *slot;
      if (k1 < n && i + R < n) *slot = band[(size_t)(i + R) * W + t];
    }
    __syncthreads();
  }
}

__global__ void band_lu_slab_kernel(float* band, int n, int bw, int k0, int C) {
  const int W = 2 * bw + 1, R = C + bw;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const RingRows rows{smem, R, W};
  float* lbuf = smem + (size_t)R * W;
  const int rend = min(k0 + R, n);
  const size_t off = (size_t)k0 * W;
  const int count = (rend - k0) * W;
  // rows k0 .. k0+R-1 land in distinct slots; slot of row k0 + q is (k0 + q) % R
  for (int idx = tid; idx < count; idx += nt) rows.row(k0 + idx / W)[idx % W] = band[off + idx];
  __syncthreads();
  retire_pivots_staged(rows, lbuf, k0, min(k0 + C, n), n, bw);
  for (int idx = tid; idx < count; idx += nt) band[off + idx] = rows.row(k0 + idx / W)[idx % W];
}

__global__ void band_lu_global_kernel(float* band, int n, int bw, int p0, int p1) {
  retire_pivots_global(GlobalRows{band, 2 * bw + 1}, smem, smem + bw, p0, p1, n, bw);
}

// x = (LU)^-1 b; one warp per RHS column, blockDim.x / 32 columns per block.
// With cap > 0 each warp keeps the last cap (>= min(bw, n) + 32) solved
// values of its column in a ring in shared memory, so the next strip reads
// them without a round trip through L2; with cap = 0 it reads them back
// from x.
__global__ void band_solve_kernel(const float* __restrict__ lu, const float* __restrict__ b,
                                  float* x, int n, int bw, int m, int cap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * (blockDim.x >> 5) + warp;
  if (col >= m) return;  // uniform across the warp
  const int W = 2 * bw + 1;
  const unsigned full = 0xffffffffu;
  float* ring = cap ? smem + (size_t)warp * cap : nullptr;

  // forward: y_i = b_i - sum_{j = i-bw}^{i-1} L(i, j) y_j, unit diagonal
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int i = k0 + lane;
    const bool live = i < n;
    const float* li = lu + (size_t)i * W + bw - i;  // li[j] = A[i, j]
    float acc = 0.f;
    float lr[32];
    if (live) {
      acc = b[(size_t)i * m + col];
      int j = max(i - bw, 0);
      if (ring) {
        for (int slot = j % cap; j < k0; ++j, slot = slot + 1 == cap ? 0 : slot + 1)
          acc -= li[j] * ring[slot];
      } else {
        for (; j < k0; ++j) acc -= li[j] * x[(size_t)j * m + col];
      }
    }
#pragma unroll
    for (int l = 0; l < 32; ++l)
      lr[l] = (live && l < lane && k0 + l >= i - bw) ? li[k0 + l] : 0.f;
#pragma unroll
    for (int l = 0; l < 31; ++l) acc -= lr[l] * __shfl_sync(full, acc, l);
    if (live) {
      if (ring) ring[i % cap] = acc;
      x[(size_t)i * m + col] = acc;
    }
    __syncwarp();
  }

  // backward: x_i = (y_i - sum_{j = i+1}^{i+bw} U(i, j) x_j) / U(i, i)
  for (int k0 = (n - 1) / 32 * 32; k0 >= 0; k0 -= 32) {
    const int i = k0 + lane;
    const bool live = i < n;
    const float* ui = lu + (size_t)i * W + bw - i;
    float acc = 0.f, diag = 1.f;
    float ur[32];
    if (live) {
      acc = x[(size_t)i * m + col];
      diag = ui[i];
      const int jend = min(i + bw, n - 1);
      int j = k0 + 32;
      if (ring) {
        for (int slot = j % cap; j <= jend; ++j, slot = slot + 1 == cap ? 0 : slot + 1)
          acc -= ui[j] * ring[slot];
      } else {
        for (; j <= jend; ++j) acc -= ui[j] * x[(size_t)j * m + col];
      }
    }
#pragma unroll
    for (int l = 0; l < 32; ++l)
      ur[l] = (live && l > lane && k0 + l <= i + bw && k0 + l < n) ? ui[k0 + l] : 0.f;
#pragma unroll
    for (int l = 31; l >= 0; --l) {
      if (lane == l) acc = __fdiv_rn(acc, diag);
      acc -= ur[l] * __shfl_sync(full, acc, l);
    }
    if (live) {
      if (ring) ring[i % cap] = acc;
      x[(size_t)i * m + col] = acc;
    }
    __syncwarp();
  }
}

// out[s] = base[s] - A[s] @ X[s + shift]   (base == nullptr: out[s] = A[s] @ X[s + shift]);
// A is (S, M, K), X (S, K, m), out and base (S, M, m); X[s + shift] outside
// 0..S-1 is zero.  One 32x32 output tile per block, 256 threads, 4 outputs each.
__global__ void band_gemm_kernel(const float* __restrict__ A, const float* __restrict__ X,
                                 const float* __restrict__ base, float* __restrict__ out, int S,
                                 int M, int K, int m, int shift) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Xs[kTile][kTile + 1];
  const int s = blockIdx.z, r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int xs = s + shift;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // ty 0..7
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (xs >= 0 && xs < S) {  // uniform across the block
    const float* a = A + (size_t)s * M * K;
    const float* xm = X + (size_t)xs * K * m;
    for (int k0 = 0; k0 < K; k0 += kTile) {
      for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
        const int r = idx / kTile, k = idx % kTile;
        As[r][k] = (r0 + r < M && k0 + k < K) ? a[(size_t)(r0 + r) * K + k0 + k] : 0.f;
        Xs[r][k] = (k0 + r < K && c0 + k < m) ? xm[(size_t)(k0 + r) * m + c0 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const float xv = Xs[k][tx];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += As[ty + 8 * q][k] * xv;
      }
      __syncthreads();
    }
  }
  const int c = c0 + tx;
  if (c >= m) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + ty + 8 * q;
    if (r >= M) continue;
    const size_t o = ((size_t)s * M + r) * m + c;
    out[o] = base ? base[o] - acc[q] : acc[q];
  }
}

// Y[i] = Z[i][roff .. roff+bw) - T_i @ Y[i -+ 1] over the S blocks, forward
// (reverse = 0: i = 0 .. S-1) or backward (reverse = 1: i = S-1 .. 0), with
// T_i = A[i][roff .. roff+bw) and the first state Y = Z rows.  A is
// (S, C, bw), Z (S, C, m), Y (S, bw, m).  One block per 32 columns; the
// previous state lives in shared memory (two (bw, 32) buffers).
__global__ void band_tail_scan_kernel(const float* __restrict__ A, const float* __restrict__ Z,
                                      float* __restrict__ Y, int S, int C, int bw, int m,
                                      int roff, int reverse) {
  float* prev = smem;
  float* cur = smem + bw * kTile;
  const int c0 = blockIdx.x * kTile;
  for (int q = 0; q < S; ++q) {
    const int i = reverse ? S - 1 - q : q;
    for (int idx = threadIdx.x; idx < bw * kTile; idx += blockDim.x) {
      const int r = idx / kTile, c = idx % kTile;
      float v = 0.f;
      if (c0 + c < m) {
        v = Z[((size_t)i * C + roff + r) * m + c0 + c];
        if (q) {
          const float* t = A + ((size_t)i * C + roff + r) * bw;
          for (int k = 0; k < bw; ++k) v -= t[k] * prev[k * kTile + c];
        }
        Y[((size_t)i * bw + r) * m + c0 + c] = v;
      }
      cur[idx] = v;
    }
    __syncthreads();
    float* swap = prev;
    prev = cur;
    cur = swap;
  }
}

// Block of the factor walks: x over the bw columns of the bw x bw block (at
// most 32), y over its rows, at least 128 threads so the staging copies
// keep enough loads in flight.
dim3 factor_block(int bw) {
  const int x = bw < 32 ? bw : 32;
  int y = bw < 1024 / x ? bw : 1024 / x;
  if (x * y < 128) y = (128 + x - 1) / x;
  return dim3(x, y);
}

size_t ring_bytes(int rows, int bw) {
  return ((size_t)rows * (2 * bw + 1) + 2 * (size_t)bw) * sizeof(float);
}

cudaError_t launch_global(float* band, int n, int bw, int p0, int p1, cudaStream_t stream) {
  band_lu_global_kernel<<<1, factor_block(bw), 2 * bw * sizeof(float), stream>>>(band, n, bw, p0,
                                                                                  p1);
  return cudaGetLastError();
}

}  // namespace

// Factor the row-aligned (n, 2bw+1) fp32 band in place, in one launch (the
// ring of band_lu_resident_kernel, or band_lu_global_kernel for wide bands).
// Stores in *launches how many kernels it launched; returns the first error.
extern "C" int ebv_band_lu_resident(void* band_ptr, int n, int bw, void* stream_ptr,
                                    int* launches) {
  float* band = static_cast<float*>(band_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  cudaError_t err;
  int R = n, C = n;  // the whole band fits: one chunk
  if (ring_bytes(n, bw) > (size_t)kSmemBytes) {
    const long long room = kSmemBytes - 2LL * bw * (long long)sizeof(float);
    R = room > 0 ? (int)(room / ((2LL * bw + 1) * (long long)sizeof(float))) : 0;
    C = R - bw;  // pivots per chunk: rows p .. p+bw of each must be in the ring
  }
  if (C < 1) {
    if ((err = launch_global(band, n, bw, 0, n, stream))) return err;
    ++*launches;
    return 0;
  }
  const size_t bytes = ring_bytes(R, bw);
  if ((err = cudaFuncSetAttribute(band_lu_resident_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)))
    return err;
  band_lu_resident_kernel<<<1, factor_block(bw), bytes, stream>>>(band, n, bw, R, C);
  if ((err = cudaGetLastError())) return err;
  ++*launches;
  return 0;
}

// Factor the band in place in S = ceil(n/C) launches, one per block step of
// C pivots, in stream order.
extern "C" int ebv_band_lu_steps(void* band_ptr, int n, int bw, int C, void* stream_ptr,
                                 int* launches) {
  float* band = static_cast<float*>(band_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  cudaError_t err;
  const size_t bytes = ring_bytes(C + bw, bw);
  const bool staged = bytes <= (size_t)kSmemBytes;
  if (staged && (err = cudaFuncSetAttribute(band_lu_slab_kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)bytes)))
    return err;
  for (int k0 = 0; k0 < n; k0 += C) {
    if (staged) {
      band_lu_slab_kernel<<<1, factor_block(bw), bytes, stream>>>(band, n, bw, k0, C);
      err = cudaGetLastError();
    } else {
      err = launch_global(band, n, bw, k0, k0 + C < n ? k0 + C : n, stream);
    }
    if (err) return err;
    ++*launches;
  }
  return 0;
}

// x (n, m) = (LU)^-1 b (n, m) on the packed band; `cols` RHS columns (one
// warp each, at most 32) per block.
extern "C" int ebv_band_solve(const void* lu, const void* b, void* x, int n, int bw, int m,
                              int cols, void* stream_ptr, int* launches) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  // a ring of the last min(bw, n) + 32 solved values per warp, fewer warps
  // per block where the rings would not fit, none where one does not
  int cap = (bw < n ? bw : n) + 32;
  const int fit = kSmemBytes / (cap * (int)sizeof(float));
  if (fit < 1) cap = 0;
  else if (cols > fit) cols = fit;
  const size_t bytes = (size_t)cols * cap * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(band_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)))
    return err;
  band_solve_kernel<<<(m + cols - 1) / cols, 32 * cols, bytes, stream>>>(
      static_cast<const float*>(lu), static_cast<const float*>(b), static_cast<float*>(x), n, bw,
      m, cap);
  err = cudaGetLastError();
  if (err) return err;
  ++*launches;
  return 0;
}

// out (S, C, m) = the inverted-diagonal band solve of xb (S, C, m) from
// linv/uinv (S, C, C) and tlo/tup (S, C, bw).  z and y are (S, C, m) and
// t (S, bw, m) scratch the caller allocates.
extern "C" int ebv_band_solve_inverted(const void* linv, const void* uinv, const void* tlo,
                                       const void* tup, const void* xb, void* out, void* z,
                                       void* y, void* t, int S, int C, int bw, int m,
                                       void* stream_ptr, int* launches) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  const float* Li = static_cast<const float*>(linv);
  const float* Ui = static_cast<const float*>(uinv);
  const float* Tl = static_cast<const float*>(tlo);
  const float* Tu = static_cast<const float*>(tup);
  float* Z = static_cast<float*>(z);
  float* Y = static_cast<float*>(y);
  float* T = static_cast<float*>(t);
  float* O = static_cast<float*>(out);
  const dim3 grid_c((m + kTile - 1) / kTile, (C + kTile - 1) / kTile, S);
  const int scan_blocks = (m + kTile - 1) / kTile;
  const size_t scan_bytes = 2 * (size_t)bw * kTile * sizeof(float);
  cudaError_t err;
#define EBV_LAUNCHED()                        \
  if ((err = cudaGetLastError())) return err; \
  ++*launches
  if (S == 1) {  // one block: no coupling
    band_gemm_kernel<<<grid_c, 256, 0, stream>>>(Li, static_cast<const float*>(xb), nullptr, Z,
                                                 S, C, C, m, 0);
    EBV_LAUNCHED();
    band_gemm_kernel<<<grid_c, 256, 0, stream>>>(Ui, Z, nullptr, O, S, C, C, m, 0);
    EBV_LAUNCHED();
    return 0;
  }
  if ((err = cudaFuncSetAttribute(band_tail_scan_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scan_bytes)))
    return err;
  // forward: z = linv @ xb; tails; y = z - tlo @ ytail[i-1]
  band_gemm_kernel<<<grid_c, 256, 0, stream>>>(Li, static_cast<const float*>(xb), nullptr, Z, S,
                                               C, C, m, 0);
  EBV_LAUNCHED();
  band_tail_scan_kernel<<<scan_blocks, 256, scan_bytes, stream>>>(Tl, Z, T, S, C, bw, m, C - bw,
                                                                   0);
  EBV_LAUNCHED();
  band_gemm_kernel<<<grid_c, 256, 0, stream>>>(Tl, T, Z, Y, S, C, bw, m, -1);
  EBV_LAUNCHED();
  // backward: w = uinv @ y (into z); heads; x = w - tup @ xhead[i+1]
  band_gemm_kernel<<<grid_c, 256, 0, stream>>>(Ui, Y, nullptr, Z, S, C, C, m, 0);
  EBV_LAUNCHED();
  band_tail_scan_kernel<<<scan_blocks, 256, scan_bytes, stream>>>(Tu, Z, T, S, C, bw, m, 0, 1);
  EBV_LAUNCHED();
  band_gemm_kernel<<<grid_c, 256, 0, stream>>>(Tu, T, Z, O, S, C, bw, m, 1);
  EBV_LAUNCHED();
#undef EBV_LAUNCHED
  return 0;
}
