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
// batched_solve_kernel — replaces src/repro/kernels/batched_lu.py:
//   batched_lu_solve_vmem, one grid program per system holding the whole
//   (n, m) RHS beside the factor.  Here the grid runs over (32-column RHS
//   tile, system): the tile lives in shared memory (column-major), the
//   factor is read through L2, so the RHS width has no cap and a wide RHS
//   fills the 132 SMs.  The sweep is PR 11's strip sweep
//   (csrc/trsm.cu:solve_vmem_kernel): per 32-row strip one warp solves the
//   strip's triangle for its columns with __shfl_sync, then each thread
//   retires one row below (above, backward) the strip.  Unlike solve_vmem it
//   subtracts term by term in the plain version's order (y_i -= l_ik * y_k
//   for k = 0, 1, ...; backward x_k / u_kk, then x_i -= u_ik * x_k for
//   k = n-1, n-2, ...) with rounded multiply and subtract, so it is bitwise
//   equal to repro_torch.core.batched.batched_lu_solve.  Bound: 2n^2 m flops
//   per system; a separate multiply and subtract per term (no FMA) halve the
//   card's fp32 rate for this kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "ebv_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemBytes = 232448;  // dynamic shared memory one H100 block may use
constexpr int kInFlight = 4;        // row updates a factor thread loads before it stores
constexpr int kStrip = 32;          // strip height and RHS columns of a solve block
constexpr int kColsInFlight = 4;    // RHS columns a solve thread carries at once
constexpr int kSolveThreads = 256;

extern __shared__ float smem[];

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

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// a CTA that wrote nothing another CTA reads arrives without releasing
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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

// x = (LU)^-1 b per system; grid (RHS tiles of rt <= 32 columns, systems).
__global__ void __launch_bounds__(kSolveThreads)
batched_solve_kernel(const float* __restrict__ lu, const float* __restrict__ b,
                     float* __restrict__ x, int n, int m, int rt) {
  const size_t sys = blockIdx.y;
  lu += sys * n * n;
  b += sys * n * m;
  x += sys * n * m;
  // rt columns of n32 rows, column-major with the odd stride n32 + 1, so
  // both a row sweep and the coalesced row-by-row copy in and out are free
  // of bank conflicts: ys[c * ld + i]
  const int n32 = (n + kStrip - 1) / kStrip * kStrip, ld = n32 + 1;
  float* ys = smem;
  const int c0 = blockIdx.x * rt;
  const int w = min(rt, m - c0);
  for (int idx = threadIdx.x; idx < w * n32; idx += blockDim.x) {
    const int i = idx / w, c = idx % w;
    ys[c * ld + i] = i < n ? b[(size_t)i * m + c0 + c] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const unsigned full = 0xffffffffu;

  // forward: L y = b, unit diagonal; y_i -= l_ik * y_k in increasing k
  for (int k0 = 0; k0 < n; k0 += kStrip) {
    const int row = k0 + lane;
    const bool live = row < n;
    float lr[kStrip];
#pragma unroll
    for (int l = 0; l < kStrip; ++l) lr[l] = (live && l < lane) ? lu[(size_t)row * n + k0 + l] : 0.f;
    // the strip's triangle: a warp carries up to kColsInFlight columns at once
    for (int cb = warp; cb < w; cb += kColsInFlight * nwarps) {
      float yr[kColsInFlight];
#pragma unroll
      for (int q = 0; q < kColsInFlight; ++q) {
        const int c = cb + q * nwarps;
        yr[q] = c < w ? ys[c * ld + row] : 0.f;
      }
#pragma unroll
      for (int l = 0; l < kStrip - 1; ++l) {
#pragma unroll
        for (int q = 0; q < kColsInFlight; ++q) {
          const float v = __shfl_sync(full, yr[q], l);
          if (l < lane) yr[q] = __fsub_rn(yr[q], __fmul_rn(lr[l], v));
        }
      }
#pragma unroll
      for (int q = 0; q < kColsInFlight; ++q) {
        const int c = cb + q * nwarps;
        if (c < w && live) ys[c * ld + row] = yr[q];
      }
    }
    __syncthreads();
    // the rows below the strip
    for (int i = k0 + kStrip + threadIdx.x; i < n; i += blockDim.x) {
      float li[kStrip];
#pragma unroll
      for (int l = 0; l < kStrip; ++l) li[l] = lu[(size_t)i * n + k0 + l];
      for (int cb = 0; cb < w; cb += kColsInFlight) {
        float acc[kColsInFlight];
#pragma unroll
        for (int q = 0; q < kColsInFlight; ++q)
          acc[q] = cb + q < w ? ys[(cb + q) * ld + i] : 0.f;
#pragma unroll
        for (int l = 0; l < kStrip; ++l) {
#pragma unroll
          for (int q = 0; q < kColsInFlight; ++q)
            if (cb + q < w) acc[q] = __fsub_rn(acc[q], __fmul_rn(li[l], ys[(cb + q) * ld + k0 + l]));
        }
#pragma unroll
        for (int q = 0; q < kColsInFlight; ++q)
          if (cb + q < w) ys[(cb + q) * ld + i] = acc[q];
      }
    }
    __syncthreads();
  }

  // backward: U x = y; x_i -= u_ik * x_k in decreasing k, then x_i / u_ii
  for (int k0 = (n - 1) / kStrip * kStrip; k0 >= 0; k0 -= kStrip) {
    const int row = k0 + lane;
    const bool live = row < n;
    const int top = min(kStrip, n - k0);  // rows of this strip inside the matrix
    float ur[kStrip];
#pragma unroll
    for (int l = 0; l < kStrip; ++l)
      ur[l] = (live && l > lane && l < top) ? lu[(size_t)row * n + k0 + l] : 0.f;
    const float piv = live ? lu[(size_t)row * n + row] : 1.f;
    for (int cb = warp; cb < w; cb += kColsInFlight * nwarps) {
      float xr[kColsInFlight];
#pragma unroll
      for (int q = 0; q < kColsInFlight; ++q) {
        const int c = cb + q * nwarps;
        xr[q] = c < w ? ys[c * ld + row] : 0.f;
      }
#pragma unroll
      for (int l = kStrip - 1; l >= 0; --l) {
#pragma unroll
        for (int q = 0; q < kColsInFlight; ++q) {
          if (lane == l) xr[q] = __fdiv_rn(xr[q], piv);
          const float v = __shfl_sync(full, xr[q], l);
          if (l > lane && l < top) xr[q] = __fsub_rn(xr[q], __fmul_rn(ur[l], v));
        }
      }
#pragma unroll
      for (int q = 0; q < kColsInFlight; ++q) {
        const int c = cb + q * nwarps;
        if (c < w && live) ys[c * ld + row] = xr[q];
      }
    }
    __syncthreads();
    // the rows above the strip
    for (int i = threadIdx.x; i < k0; i += blockDim.x) {
      float ui[kStrip];
#pragma unroll
      for (int l = 0; l < kStrip; ++l) ui[l] = l < top ? lu[(size_t)i * n + k0 + l] : 0.f;
      for (int cb = 0; cb < w; cb += kColsInFlight) {
        float acc[kColsInFlight];
#pragma unroll
        for (int q = 0; q < kColsInFlight; ++q)
          acc[q] = cb + q < w ? ys[(cb + q) * ld + i] : 0.f;
#pragma unroll
        for (int l = kStrip - 1; l >= 0; --l) {
#pragma unroll
          for (int q = 0; q < kColsInFlight; ++q)
            if (cb + q < w && l < top)
              acc[q] = __fsub_rn(acc[q], __fmul_rn(ui[l], ys[(cb + q) * ld + k0 + l]));
        }
#pragma unroll
        for (int q = 0; q < kColsInFlight; ++q)
          if (cb + q < w) ys[(cb + q) * ld + i] = acc[q];
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < w * n; idx += blockDim.x) {
    const int i = idx / w, c = idx % w;
    x[(size_t)i * m + c0 + c] = ys[c * ld + i];
  }
}

// Block of the factor walk: x over columns (at most 32), y over rows, at
// most 1024 threads, at least 4 rows.
dim3 factor_block(int n) {
  int y = n < 32 ? n : 32;
  if (y < 4) y = 4;
  return dim3(32, y);
}

constexpr int kClusterSizes[4] = {2, 4, 8, 16};

// a launch of `grid` CTAs of the cluster kernel in clusters of `csize`
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int csize, int grid, size_t smem,
                                  cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kWalkThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of 2, 4, 8 and 16 CTAs of the cluster kernel the current
// device holds at once (one CTA an SM, and a cluster within one GPC), asked
// once per device.
cudaError_t cluster_room(int room[4]) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices][4];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if (dev < kMaxDevices && cached[dev][0].load()) {
    for (int i = 0; i < 4; ++i) room[i] = cached[dev][i].load();
    return cudaSuccess;
  }
  auto kernel = batched_lu_cluster_kernel;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWalkSmem))) return err;
  for (int i = 0; i < 4; ++i) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(&attr, kClusterSizes[i], kClusterSizes[i], kWalkSmem, 0);
    if ((err = cudaOccupancyMaxActiveClusters(&room[i], kernel, &cfg))) return err;
  }
  if (dev < kMaxDevices)
    for (int i = 3; i >= 0; --i) cached[dev][i].store(room[i]);  // [0] last: it marks the entry filled
  return cudaSuccess;
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
  auto kernel = batched_lu_cluster_kernel;  // cluster_room allowed clusters of 16 on this device
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes)))
    return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, csize, batch * csize, p.bytes, stream);
  int active = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg))) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;  // the card cannot hold one such cluster
  plan[2] = p.theta;
  plan[3] = static_cast<int>(p.bytes);
  plan[4] = active;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, a, n, p.theta, p.lbuf_at, p.rows_at))) return err;
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
  return 0;
}

// room[0..3]: how many clusters of 2, 4, 8 and 16 CTAs of the factor's
// cluster kernel the current device holds at once.
extern "C" int ebv_batched_cluster_room(int* room) { return cluster_room(room); }

// x (batch, n, m) = (LU)^-1 b per system on the packed (batch, n, n) factors;
// one block per system and tile of rt <= 32 RHS columns.
extern "C" int ebv_batched_lu_solve(const void* lu, const void* b, void* x, int batch, int n, int m,
                                    int rt, void* stream_ptr, int* launches) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  if (batch == 0 || n == 0 || m == 0) return 0;
  const int n32 = (n + kStrip - 1) / kStrip * kStrip;
  const size_t bytes = (size_t)rt * (n32 + 1) * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(batched_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)))
    return err;
  const dim3 grid((m + rt - 1) / rt, batch);
  batched_solve_kernel<<<grid, kSolveThreads, bytes, stream>>>(
      static_cast<const float*>(lu), static_cast<const float*>(b), static_cast<float*>(x), n, m, rt);
  if ((err = cudaGetLastError())) return err;
  ++*launches;
  return 0;
}
