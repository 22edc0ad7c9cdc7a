// Launch helpers shared by the dense factor (ebv_lu.cu) and the dense
// solves (trsm.cu): programmatic dependent launch, and the set-up each
// device needs once.
//
// A chain of launches in stream order where each launch after the first
// carries cudaLaunchAttributeProgrammaticStreamSerialization: its blocks may
// be scheduled once every block of the launch before it has called
// allow_next_step(), and they run their prologue (set-up, and copies of data
// that no earlier launch of the chain writes) while that launch still runs.
// wait_prior_step() returns once the launch before has completed and its
// writes are visible; since that launch waited in turn, so have all before
// it.  Reads after the wait of data another SM wrote go past L1 (__ldcg,
// cp.async.cg): L1 is not coherent, and lines of it may predate the wait.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

__device__ __forceinline__ void allow_next_step() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prior_step() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// Launches kernel<<<grid, threads, smem, stream>>>(args...), as a dependent
// launch of the one before it in the stream when `chained`; returns the
// launch error, or 0.
template <class... Params, class... Args>
cudaError_t launch_step(void (*kernel)(Params...), dim3 grid, dim3 threads, size_t smem,
                        cudaStream_t stream, bool chained, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = threads;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = chained ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return err ? err : cudaGetLastError();
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// The current device's SM count into *sms.  Setup (the caller's shared
// memory attributes, a host call each) runs before the first return on each
// device and not again: each Setup has a cache of its own.
template <cudaError_t (*Setup)()>
cudaError_t device_sms(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if (dev < kMaxDevices && (*sms = cached[dev].load())) return cudaSuccess;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = Setup())) return err;
  if (dev < kMaxDevices) cached[dev].store(*sms);
  return cudaSuccess;
}

}  // namespace
