// Element loads and stores in fp32 or bf16, shared by the unblocked walks
// (ebv_walk.cuh) and the SGEMM tile (sgemm.cuh): values are fp32 in
// registers and T in memory; a bf16 value widens to fp32 when it is read
// and rounds to bf16 when it is stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the _l2 forms go past L1 (__ldcg / __stcg), for data another SM writes or reads
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_l2(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_l2(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void store_l2(__nv_bfloat16* p, float v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// v rounded to T (the identity for fp32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace
