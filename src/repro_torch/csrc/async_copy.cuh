// Asynchronous copies from device memory into shared memory (cp.async),
// shared by the dense factor (ebv_lu.cu) and the dense solves (trsm.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (16 or 0) of src past L1 and zero-fills the rest of the
// 16 bytes; src and dst 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// Copies `bytes` (4 or 0) of src and zero-fills the rest of the 4-byte word.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `kPending` of the committed copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace
