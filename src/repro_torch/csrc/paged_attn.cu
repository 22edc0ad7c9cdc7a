// Paged-KV GQA decode attention, fp32 or bf16, for Hopper (sm_90a): the
// paged serving engine's attention, once per layer per decode step.
//
// paged_attn_kernel — replaces src/repro/kernels/paged_attn.py:
//   paged_decode_attention, one grid program per batch row that takes the
//   WHOLE pool as one VMEM block, gathers all NP pages of its row and runs
//   the single-chunk GQA softmax of _row_attention.  Here one block per
//   (row, KV head) reads from device memory only the pages its row's page
//   table names, and only those its live length reaches, so the rep = H/KV
//   query heads of a GQA group share every K/V load and no VMEM-sized cap
//   on NP remains.
//
//   Semantics kept from the reference:
//   - a -1 page-table entry is a hole inside the row: its K and V are zero,
//     so its positions score exactly 0 and take part in the softmax;
//   - positions j >= length score MASK_VALUE = -1e30; with m = max(max s,
//     -1e25), exp(MASK - m) is exactly 0, so the pages wholly past
//     ceil(length / page) are skipped: that differs from the reference only
//     if a skipped V holds inf or NaN (0 * inf is NaN there).  Positions
//     past the length inside the last live page are kept (p = 0 times v);
//   - a page id past the pool is clamped to the last page, as the
//     reference's dynamic slice clamps;
//   - the rounding order: fp32 scores from q and k in their dtype, times
//     Dh^-0.5 in fp32; fp32 p = exp(s - m); p rounded to the V dtype, p*v
//     summed in fp32 and rounded to the V dtype; l = max(sum p, 1e-30) in
//     fp32 rounded to the V dtype, and the division in that dtype.
//
//   The softmax needs the row's final max before any p is rounded, so a
//   block makes two passes: scores first (K staged through shared memory in
//   tiles of kTile positions), then p and p*v (V staged the same way).  The
//   scores of the row's rep heads stay in shared memory while they fit
//   (SCORE_SMEM_BYTES in kernels/paged_attn.py, 96 KB: 24576 positions at
//   rep = 1, 6144 at rep = 4); a longer row keeps them in a device-memory
//   scratch the same block writes and reads back, in the same launch, so no
//   combine launch is needed and the rounding order stays the reference's.
//
//   Bound: bytes.  Each live position's K and V row is read once (2 * Dh
//   elements per KV head) and the scores cost rep * 4 bytes per position in
//   shared memory; at B = 32 rows of 4096 positions, KV = 8, Dh = 128, bf16
//   that is 537 MB, 0.16 ms at 3.35 TB/s.  Staged tiles without
//   double-buffering keep few loads in flight: cp.async or TMA rings, and
//   wgmma for the rep x Dh products, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // positions staged per step
constexpr int kBatch = 4;   // 16-byte loads a thread issues before it stores
constexpr float kMask = -1e30f;
constexpr float kGuard = -1e25f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Block-wide max (kMax) or sum of v, returned to every thread.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// Stage positions j0 .. j0 + kTile - 1 (those below lp) of KV head g of the
// row's pages into tile (row stride `stride` floats), holes as zeros.
template <typename T>
__device__ void stage(const T* __restrict__ pool, const int* __restrict__ ptab, int j0, int lp,
                      int p, int page, int kvh, int g, int dh, int stride, float* tile) {
  constexpr int kVe = 16 / sizeof(T);
  const int vpr = dh / kVe;  // 16-byte vectors per K/V row
  const int n = min(kTile, lp - j0) * vpr;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n) {
        const int row = e / vpr, j = j0 + row;
        const int pid = ptab[j / page];
        if (pid >= 0) {
          const size_t at = ((size_t)min(pid, p - 1) * page + j % page) * kvh + g;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(pool + at * dh) + (e - row * vpr));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) {
        const int row = e / vpr;
        float* dst = tile + row * stride + (e - row * vpr) * kVe;
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int i = 0; i < kVe; ++i) dst[i] = to_f(vals[i]);
      }
    }
  }
}

// One block per (KV head g, row b); KOUT outputs (query head, dim) a thread.
template <typename T, int KOUT>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                  const int* __restrict__ pt, const int* __restrict__ lengths, T* __restrict__ out,
                  float* scratch, int scores_in_smem, int h, int kvh, int dh, int p, int page,
                  int np_, float scale) {
  extern __shared__ float smem[];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rep = h / kvh, ld = np_ * page, nout = rep * dh;
  float* qs = smem;               // rep * dh: the group's queries, fp32
  float* red = qs + nout;         // kWarps
  float* ls = red + kWarps;       // rep: sum of p per head
  float* tile = ls + rep;         // kTile * (dh + 1): staged K (padded rows) or V
  float* sc = scores_in_smem ? tile + kTile * (dh + 1)  // rep * ld: scores, then p
                             : scratch + ((size_t)b * kvh + g) * rep * ld;
  const int* ptab = pt + (size_t)b * np_;
  const int live = min(max(lengths[b], 0), ld);
  const int lp = (live + page - 1) / page * page;  // the live pages' positions

  const T* qg = q + ((size_t)b * h + (size_t)g * rep) * dh;
  for (int i = tid; i < nout; i += kThreads) qs[i] = to_f(qg[i]);

  // pass 1: s = (q . k) * scale, MASK past the length
  for (int j0 = 0; j0 < lp; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    stage(kp, ptab, j0, lp, p, page, kvh, g, dh, dh + 1, tile);
    __syncthreads();
    const int jn = min(kTile, lp - j0);
    for (int pr = tid; pr < rep * kTile; pr += kThreads) {
      const int r = pr / kTile, jj = pr - r * kTile;
      if (jj >= jn) continue;
      const float* qr = qs + r * dh;
      const float* kr = tile + jj * (dh + 1);
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
      const int j = j0 + jj;
      sc[(size_t)r * ld + j] = j < live ? acc * scale : kMask;
    }
  }
  __syncthreads();

  // the row max per head (guarded), then p = exp(s - m) in place and l
  for (int r = 0; r < rep; ++r) {
    float m = -INFINITY;
    for (int j = tid; j < lp; j += kThreads) m = fmaxf(m, sc[(size_t)r * ld + j]);
    m = fmaxf(block_reduce<true>(m, red), kGuard);
    float l = 0.f;
    for (int j = tid; j < lp; j += kThreads) {
      const float e = expf(sc[(size_t)r * ld + j] - m);
      sc[(size_t)r * ld + j] = e;
      l += e;
    }
    l = block_reduce<false>(l, red);
    if (tid == 0) ls[r] = l;
  }

  // pass 2: o = sum_j round(p_j) v_j in fp32
  int soff[KOUT], doff[KOUT];
  float acc[KOUT];
#pragma unroll
  for (int k = 0; k < KOUT; ++k) {
    const int o = tid + k * kThreads, r = o / dh;
    soff[k] = o < nout ? r * ld : 0;
    doff[k] = o - r * dh;
    acc[k] = 0.f;
  }
  for (int j0 = 0; j0 < lp; j0 += kTile) {
    __syncthreads();
    stage(vp, ptab, j0, lp, p, page, kvh, g, dh, dh, tile);
    __syncthreads();
    const int jn = min(kTile, lp - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float* vr = tile + jj * dh;
#pragma unroll
      for (int k = 0; k < KOUT; ++k) {
        if (tid + k * kThreads < nout)
          acc[k] = fmaf(round_to<T>(sc[soff[k] + j0 + jj]), vr[doff[k]], acc[k]);
      }
    }
  }

  // out = round(o) / round(max(l, 1e-30)), in the V dtype
  __syncthreads();  // ls is written (no pass-2 tile ran when the row is empty)
  T* ob = out + ((size_t)b * h + (size_t)g * rep) * dh;
#pragma unroll
  for (int k = 0; k < KOUT; ++k) {
    const int o = tid + k * kThreads;
    if (o < nout) {
      const float l = round_to<T>(fmaxf(ls[o / dh], 1e-30f));
      store(ob + o, round_to<T>(acc[k]) / l);
    }
  }
}

template <typename T, int KOUT>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* pt, const int* len,
                   void* out, float* scratch, int smem_scores, int b, int h, int kvh, int dh, int p,
                   int page, int np_, float scale, cudaStream_t s) {
  const int rep = h / kvh;
  size_t floats = (size_t)rep * dh + kWarps + rep + (size_t)kTile * (dh + 1);
  if (smem_scores) floats += (size_t)rep * np_ * page;
  const size_t bytes = floats * sizeof(float);
  auto kernel = paged_attn_kernel<T, KOUT>;
  static size_t allowed = 48 * 1024;  // what the instantiation may take without opting in
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  kernel<<<dim3(kvh, b), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), pt, len,
      static_cast<T*>(out), scratch, smem_scores, h, kvh, dh, p, page, np_, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp, const int* pt, const int* len,
                     void* out, float* scratch, int smem_scores, int b, int h, int kvh, int dh,
                     int p, int page, int np_, float scale, cudaStream_t s) {
  const int per = (h / kvh * dh + kThreads - 1) / kThreads;  // outputs per thread
#define PAGED_LAUNCH(K) \
  launch<T, K>(q, kp, vp, pt, len, out, scratch, smem_scores, b, h, kvh, dh, p, page, np_, scale, s)
  if (per <= 1) return PAGED_LAUNCH(1);
  if (per <= 2) return PAGED_LAUNCH(2);
  if (per <= 4) return PAGED_LAUNCH(4);
  if (per <= 8) return PAGED_LAUNCH(8);
  if (per <= 16) return PAGED_LAUNCH(16);
#undef PAGED_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// out (b, h * dh) = paged decode attention of q (b, h, dh) over the pools kp,
// vp (p, page, kvh, dh) through pt (b, np_) int32 and len (b,) int32; fp32,
// or bf16 when `bf16` is 1.  `scratch` holds (b, kvh, h / kvh, np_ * page)
// fp32 scores when smem_scores is 0.  One launch.
extern "C" int ebv_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                          const void* pt, const void* len, void* out,
                                          void* scratch, int smem_scores, int b, int h, int kvh,
                                          int dh, int p, int page, int np_, float scale, int bf16,
                                          void* stream) {
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pti = static_cast<const int*>(pt);
  const int* lni = static_cast<const int*>(len);
  float* scr = static_cast<float*>(scratch);
  return bf16 ? dispatch<__nv_bfloat16>(q, kp, vp, pti, lni, out, scr, smem_scores, b, h, kvh, dh,
                                        p, page, np_, scale, s)
              : dispatch<float>(q, kp, vp, pti, lni, out, scr, smem_scores, b, h, kvh, dh, p,
                                page, np_, scale, s);
}
