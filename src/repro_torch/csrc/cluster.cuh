// Thread-block clusters, shared by the batched factor and solve
// (batched_lu.cu) and the wide-band factor (banded.cu): the split cluster
// barrier, the launch configuration of a cluster kernel, and how many
// clusters of 2, 4, 8 and 16 CTAs of a kernel the current device holds at
// once.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kClusterSizes[4] = {2, 4, 8, 16};

// The split cluster barrier: every thread of every CTA arrives, then waits.
// arrive.release makes the thread's earlier writes (to its own or another
// CTA's shared memory, or to device memory) visible to the threads that
// wait.acquire on the same phase.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// a thread that wrote nothing another CTA reads arrives without releasing
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// a launch of `grid` CTAs of `threads` threads in clusters of `csize`
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int csize, int grid, int threads,
                                         size_t smem, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Let `kernel` take clusters of 16 and `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_cluster(Kernel kernel, size_t smem) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// How many clusters of 2, 4, 8 and 16 CTAs of `kernel` (`threads` threads
// and `smem` bytes of shared memory a CTA: at full shared memory one CTA an
// SM, and a cluster within one GPC) the current device holds at once, asked
// once per device and kept in `cache` (one per kernel).
constexpr int kMaxDevices = 64;
using RoomCache = std::atomic<int>[kMaxDevices][4];

template <typename Kernel>
cudaError_t cluster_room_of(Kernel kernel, int threads, size_t smem, RoomCache& cache, int room[4]) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if (dev < kMaxDevices && cache[dev][0].load()) {
    for (int i = 0; i < 4; ++i) room[i] = cache[dev][i].load();
    return cudaSuccess;
  }
  if ((err = allow_cluster(kernel, smem))) return err;
  for (int i = 0; i < 4; ++i) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(&attr, kClusterSizes[i], kClusterSizes[i], threads, smem, 0);
    if ((err = cudaOccupancyMaxActiveClusters(&room[i], kernel, &cfg))) return err;
  }
  if (dev < kMaxDevices)
    for (int i = 3; i >= 0; --i) cache[dev][i].store(room[i]);  // [0] last: it marks the entry filled
  return cudaSuccess;
}

// Launch `kernel` on `grid` CTAs in clusters of `csize` with `smem` bytes a
// CTA; *active gets how many such clusters the card holds at once, and a
// card that cannot hold one refuses the launch (cudaErrorLaunchOutOfResources).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster_kernel(Kernel kernel, int csize, int grid, int threads, size_t smem,
                                  cudaStream_t stream, int* active, Args... args) {
  cudaError_t err;
  if ((err = allow_cluster(kernel, smem))) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, csize, grid, threads, smem, stream);
  *active = 0;
  if ((err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg))) return err;
  if (*active < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args...))) return err;
  return cudaGetLastError();
}

}  // namespace
