// One block's handoff to another inside one launch, in device memory.
// Either by a flag (the unblocked walks, legacy_lu.cu: lu_vmem, panel): the
// writer stores its data, then release-stores the flag; a reader spins on
// relaxed loads of the flag, then takes one acquire fence, after which it
// sees what the writer stored before its release (read past L1: L1 is not
// coherent).  Or by tagged cells (the dense solve, trsm.cu: solve_vmem):
// each value travels with its tag in one 8-byte word, so a reader polls the
// data itself: one L2 round trip a handoff where the flag takes three (the
// release, the flag, the data).  Every block of such a launch must be
// resident at once (a cooperative launch), or a reader could wait on a
// block that never runs.
#pragma once

#include <cuda_runtime.h>

namespace {

// A wait on a flag longer than kWaitCycles (seconds) traps, so a broken
// handoff ends the launch with an error instead of holding the card.
constexpr long long kWaitCycles = 20000000000LL;

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// spin on relaxed loads, then one acquire fence: what the flag's writer
// stored before its release is visible after
__device__ void wait_until(const int* p, int at_least) {
  const long long t0 = clock64();
  while (load_relaxed(p) < at_least)
    if (clock64() - t0 > kWaitCycles) __trap();
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// A value handed over with its tag in one 8-byte word: a single-copy
// atomic store and load, so a reader that sees the tag sees the value with
// it, with no flag, fence or second read between them.
__device__ __forceinline__ void store_cell(unsigned long long* p, float v, unsigned tag) {
  const unsigned long long w = (unsigned long long)tag << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long load_cell(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// spin (sleep_ns apart, where a reader has slack) until the cell's tag
// reaches `tag`; its value
__device__ float wait_cell(const unsigned long long* p, unsigned tag, unsigned sleep_ns = 0) {
  const long long t0 = clock64();
  unsigned long long w;
  while (static_cast<unsigned>((w = load_cell(p)) >> 32) < tag) {
    if (clock64() - t0 > kWaitCycles) __trap();
    if (sleep_ns) __nanosleep(sleep_ns);
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

}  // namespace
