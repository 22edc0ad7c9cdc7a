// Paged-KV GQA decode attention, fp32 or bf16, for Hopper (sm_90a): the
// paged serving engine's attention, once per layer per decode step.
//
// paged_attn_kernel — replaces src/repro/kernels/paged_attn.py:
//   paged_decode_attention, one grid program per batch row that takes the
//   WHOLE pool as one VMEM block, gathers all NP pages of its row and runs
//   the single-chunk GQA softmax of _row_attention.  Here a thread-block
//   cluster of K CTAs takes one (row, KV head, group of up to 4 of the
//   head's query heads), and CTA r of the cluster the row's pages
//   [r * ppc, (r + 1) * ppc), ppc = ceil(NP / K): every position is owned by
//   exactly one CTA.  A CTA reads from device memory only the pages of its
//   share that the row's live length reaches, so the query heads of a group
//   share every K/V load, and a CTA whose share lies past the length reads
//   nothing and only takes part in the cluster's two exchanges.  K comes
//   from kernels/paged_attn.py:paged_plan, from the shapes alone: no length
//   is read on the host.
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
//     Dh^-0.5 in fp32; the row's max over all K CTAs (through DSMEM) before
//     any p is formed; fp32 p = exp(s - m); p rounded to the V dtype, p*v
//     summed in fp32 (a CTA's share, then the K shares in rank order) and
//     rounded to the V dtype; l = max(sum p, 1e-30) in fp32 rounded to the V
//     dtype, and the division in that dtype.  Only the fp32 summation order
//     differs from the plain version's.
//
//   A CTA streams its share's K tiles, then its V tiles, through a ring of
//   kStages tiles of kTileBytes by 16-byte cp.async, kStages - 1 tiles ahead
//   of use (holes zero-filled), so loads stay in flight while a tile is
//   used, and the first V tiles arrive while the cluster exchanges its max.
//   A score is computed across a warp: a position's Dh splits over LP lanes
//   (LP = 16 in bf16 at Dh = 128, each lane 8 elements of q in registers for
//   each head), the partial dot products shuffle-reduced; a warp takes 32 /
//   LP positions at once.  p*v uses the same lanes: each lane accumulates
//   its Dh elements for each head over its positions, then the partials
//   reduce over the warp's positions (shuffles), the CTA's warps (shared
//   memory, in warp order) and the cluster (the leader adds the K shares
//   through DSMEM and writes the output).  The scores of a share stay in
//   shared memory where they fit beside the ring, else in a device-memory
//   scratch the same CTA writes and reads back.
//
//   Bound: bytes.  Each live position's K and V row is read once (2 * Dh
//   elements per KV head); at B = 32 rows of 4096 positions, KV = 8,
//   Dh = 128, bf16 that is 537 MB, 0.16 ms at 3.35 TB/s.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "async_copy.cuh"
#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;           // query heads a CTA takes (a group)
constexpr int kMaxCtas = 16;        // CTAs a cluster
constexpr int kStages = 3;          // tiles in flight
constexpr int kTileBytes = 16384;   // one staged tile of K or V rows
constexpr int kLaneElems = 8;       // the most Dh elements a lane holds (Dh <= 256)
constexpr float kMask = -1e30f;
constexpr float kGuard = -1e25f;

extern __shared__ __align__(16) unsigned char smem_raw[];

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

// the 16 bytes at p as 16 / sizeof(T) floats
__device__ __forceinline__ void widen(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The shared memory of a CTA: the ring, the share's page ids, the scores
// (where they fit), the cluster's maxima, reduction scratch and (used in
// the leader) the K shares' partial outputs.  kernels/paged_attn.py:
// paged_plan mirrors the sizes.
struct PagedLayout {
  int tj, rg, sp;
  size_t pg_at, sc_at, misc_at, comb_at, bytes;
};

inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

inline PagedLayout paged_layout(int dh, int es, int rep, int page, int ppc, int K, int smem_scores) {
  PagedLayout l;
  l.tj = kTileBytes / (dh * es);
  l.rg = rep < kHeads ? rep : kHeads;
  l.sp = ppc * page;
  l.pg_at = (size_t)kStages * kTileBytes;
  l.sc_at = l.pg_at + align16((size_t)ppc * 4);
  l.misc_at = l.sc_at + (smem_scores ? align16((size_t)l.rg * l.sp * 4) : 0);
  l.comb_at = l.misc_at + 512;  // maxima [16][4], warp sums [8][4], the row's max [4]
  l.bytes = l.comb_at + (size_t)K * (kHeads * dh + kHeads) * 4;
  return l;
}

// grid (K, KV * groups, B), clusters of K along x
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                  const int* __restrict__ pt, const int* __restrict__ lengths, T* __restrict__ out,
                  float* scratch, int smem_scores, int h, int kvh, int dh, int p, int page, int np_,
                  int ppc, int tj, float scale, size_t pg_at, size_t sc_at, size_t misc_at,
                  size_t comb_at) {
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int K = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = h / kvh, groups = (rep + kHeads - 1) / kHeads;
  const int g = blockIdx.y / groups, hg = blockIdx.y - g * groups, b = blockIdx.z;
  const int h0 = g * rep + hg * kHeads, nr = min(kHeads, rep - hg * kHeads);  // the group's heads
  const int nc = dh / VE;                                                       // chunks a row
  int lp = 1;
  while (lp < nc && lp < 32) lp <<= 1;  // lanes a position
  const int pw = 32 / lp, sub = lane / lp, cl = lane - sub * lp;  // positions a warp step; chunk lane

  T* ring = reinterpret_cast<T*>(smem_raw);
  int* pg = reinterpret_cast<int*>(smem_raw + pg_at);
  float* misc = reinterpret_cast<float*>(smem_raw + misc_at);
  float* mx = misc;            // [kMaxCtas][kHeads]: each CTA's max
  float* red = misc + 64;      // [kWarps][kHeads]
  float* mrow = misc + 96;     // [kHeads]: the row's max
  float* comb = reinterpret_cast<float*>(smem_raw + comb_at);  // [K][kHeads * dh + kHeads]
  const int rg = min(rep, kHeads), sp = ppc * page;
  float* sc = smem_scores ? reinterpret_cast<float*>(smem_raw + sc_at)
                          : scratch + (((size_t)b * gridDim.y + blockIdx.y) * K + rank) * rg * sp;

  cluster_arrive();  // every CTA runs before another writes its shared memory

  // the share: pages [pa, pe) of the row that its live length reaches
  const int live = min(max(lengths[b], 0), np_ * page);
  const int pa = rank * ppc, pe = min(min(pa + ppc, np_), (live + page - 1) / page);
  const int spl = pe > pa ? (pe - pa) * page : 0;  // the share's positions
  const int nt = (spl + tj - 1) / tj;              // its tiles
  const int* ptab = pt + (size_t)b * np_;
  for (int i = tid; i < pe - pa; i += kThreads) pg[i] = ptab[pa + i];
  __syncthreads();

  // tile t of the stream (K tiles 0 .. nt-1, then V tiles) into its slot
  auto issue = [&](int t) {
    if (t < 2 * nt) {
      const T* pool = t < nt ? kp : vp;
      const int j0 = (t < nt ? t : t - nt) * tj, n = min(tj, spl - j0) * nc;
      T* dst = ring + (size_t)(t % kStages) * (kTileBytes / sizeof(T));
      for (int e = tid; e < n; e += kThreads) {
        const int jj = e / nc, c = e - jj * nc, j = j0 + jj;  // j: the share's position
        const int pid = pg[j / page];
        const size_t at = ((size_t)min(pid, p - 1) * page + j % page) * kvh + g;
        cp_async16(reinterpret_cast<float*>(dst + jj * dh + c * VE),
                   reinterpret_cast<const float*>(pid >= 0 ? pool + at * dh + c * VE : pool),
                   pid >= 0 ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // the lane's Dh elements (chunks cl, cl + lp) of each head's query
  float qv[kHeads][kLaneElems];
#pragma unroll
  for (int r = 0; r < kHeads; ++r)
#pragma unroll
    for (int u = 0; u < kLaneElems / VE; ++u) {
      const int c = cl + u * lp;
      const T* src = q + ((size_t)b * h + h0 + r) * dh + c * VE;
#pragma unroll
      for (int e = 0; e < VE; ++e) qv[r][u * VE + e] = r < nr && c < nc ? to_f(src[e]) : 0.f;
    }

  for (int t = 0; t < kStages - 1; ++t) issue(t);
  float mloc[kHeads], lsum[kHeads], acc[kHeads][kLaneElems];
#pragma unroll
  for (int r = 0; r < kHeads; ++r) {
    mloc[r] = -INFINITY;
    lsum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) acc[r][e] = 0.f;
  }
  // the lane's Dh elements of the row (of tile `tile`, its position jj)
  auto lane_row = [&](const T* tile, int jj, bool ok, float (&x)[kLaneElems]) {
#pragma unroll
    for (int u = 0; u < kLaneElems / VE; ++u) {
      const int c = cl + u * lp;
      if (ok && c < nc) {
        widen(tile + jj * dh + c * VE, x + u * VE);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) x[u * VE + e] = 0.f;
      }
    }
  };

  // ---- the K tiles: s = (q . k) * scale, MASK past the length ----
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; every thread is past tile t - 1
    issue(t + kStages - 1);
    const T* tile = ring + (size_t)(t % kStages) * (kTileBytes / sizeof(T));
    const int j0 = t * tj, tl = min(tj, spl - j0);
    for (int base = warp * pw; base < tl; base += kWarps * pw) {  // uniform across the warp
      const int jj = base + sub, jl = j0 + jj;
      float x[kLaneElems], sr[kHeads];
      lane_row(tile, jj, jj < tl, x);
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        sr[r] = 0.f;
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) sr[r] = fmaf(qv[r][e], x[e], sr[r]);
      }
      for (int o = lp >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < kHeads; ++r) sr[r] += __shfl_xor_sync(0xffffffffu, sr[r], o);
      if (jj < tl && cl == 0) {
        const bool in = pa * page + jl < live;
#pragma unroll
        for (int r = 0; r < kHeads; ++r)
          if (r < nr) {
            const float v = in ? sr[r] * scale : kMask;
            sc[(size_t)r * sp + jl] = v;
            mloc[r] = fmaxf(mloc[r], v);
          }
      }
    }
  }

  // ---- the row's max over the cluster (every CTA, also one whose share is
  // empty), while the first V tiles are in flight ----
#pragma unroll
  for (int r = 0; r < kHeads; ++r)
    for (int o = 16; o > 0; o >>= 1) mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], o));
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < kHeads; ++r) red[warp * kHeads + r] = mloc[r];
  __syncthreads();
  cluster_wait();  // every CTA of the cluster runs
  if (tid < K * kHeads) {
    const int d = tid / kHeads, r = tid - d * kHeads;
    float m = red[r];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * kHeads + r]);
    *cluster.map_shared_rank(mx + rank * kHeads + r, d) = m;
  }
  cluster_arrive_release();
  cluster_wait();
  if (tid < kHeads) {
    float m = mx[tid];
    for (int d = 1; d < K; ++d) m = fmaxf(m, mx[d * kHeads + tid]);
    mrow[tid] = fmaxf(m, kGuard);
  }
  __syncthreads();
  // p = exp(s - m) in place, and this thread's part of the share's sum of p
  for (int r = 0; r < nr; ++r) {
    const float m = mrow[r];
    for (int j = tid; j < spl; j += kThreads) {
      const float e = expf(sc[(size_t)r * sp + j] - m);
      sc[(size_t)r * sp + j] = e;
      lsum[r] += e;
    }
  }
  // ---- the V tiles: o = sum_j round(p_j) v_j in fp32 ----
  for (int t = nt; t < 2 * nt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // also: every p is in place (t == nt)
    issue(t + kStages - 1);
    const T* tile = ring + (size_t)(t % kStages) * (kTileBytes / sizeof(T));
    const int j0 = (t - nt) * tj, tl = min(tj, spl - j0);
    for (int jj = warp * pw + sub; jj < tl; jj += kWarps * pw) {
      const int jl = j0 + jj;
      float x[kLaneElems];
      lane_row(tile, jj, true, x);
#pragma unroll
      for (int r = 0; r < kHeads; ++r)
        if (r < nr) {
          const float pr = round_to<T>(sc[(size_t)r * sp + jl]);
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e) acc[r][e] = fmaf(pr, x[e], acc[r][e]);
        }
    }
  }
  cp_async_wait<0>();
  // the share's sum of p per head
#pragma unroll
  for (int r = 0; r < kHeads; ++r)
    for (int o = 16; o > 0; o >>= 1) lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], o);
  __syncthreads();  // every thread is past the last tile: the ring is free
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < kHeads; ++r) red[warp * kHeads + r] = lsum[r];
  // the warp's positions' partials (lanes of one chunk lane), then the warps'
  for (int o = lp; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < kHeads; ++r)
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  float* wsum = reinterpret_cast<float*>(ring);  // [kWarps][kHeads][dh]
  if (sub == 0)
#pragma unroll
    for (int r = 0; r < kHeads; ++r)
#pragma unroll
      for (int u = 0; u < kLaneElems / VE; ++u) {
        const int c = cl + u * lp;
        if (r < nr && c < nc)
#pragma unroll
          for (int e = 0; e < VE; ++e) wsum[((size_t)warp * kHeads + r) * dh + c * VE + e] = acc[r][u * VE + e];
      }
  __syncthreads();
  // this CTA's share into the leader's comb[rank]
  const int stride = kHeads * dh + kHeads;
  for (int i = tid; i < nr * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += wsum[((size_t)w * kHeads + r) * dh + d];
    *cluster.map_shared_rank(comb + rank * stride + r * dh + d, 0) = o;
  }
  if (tid < nr) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red[w * kHeads + tid];
    *cluster.map_shared_rank(comb + rank * stride + kHeads * dh + tid, 0) = l;
  }
  cluster_arrive_release();
  cluster_wait();
  if (rank != 0) return;
  // out = round(o) / round(max(l, 1e-30)), in the V dtype
  T* ob = out + ((size_t)b * h + h0) * dh;
  for (int i = tid; i < nr * dh; i += kThreads) {
    const int r = i / dh;
    float o = 0.f, l = 0.f;
    for (int d = 0; d < K; ++d) {
      o += comb[d * stride + i];
      l += comb[d * stride + kHeads * dh + r];
    }
    store(ob + i, round_to<T>(o) / round_to<T>(fmaxf(l, 1e-30f)));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* pt, const int* len,
                   void* out, float* scratch, int smem_scores, int b, int h, int kvh, int dh, int p,
                   int page, int np_, int K, float scale, int* plan, cudaStream_t s) {
  const int rep = h / kvh, groups = (rep + kHeads - 1) / kHeads, ppc = (np_ + K - 1) / K;
  const PagedLayout l = paged_layout(dh, sizeof(T), rep, page, ppc, K, smem_scores);
  plan[0] = K;
  plan[1] = groups;
  plan[2] = ppc;
  plan[3] = smem_scores;
  plan[4] = static_cast<int>(l.bytes);
  if (K < 1 || K > kMaxCtas || (K & (K - 1)) || dh * (int)sizeof(T) % 16 || dh > kLaneElems * 32 ||
      l.tj < 1 || l.bytes > 232448)
    return cudaErrorInvalidValue;
  auto kernel = paged_attn_kernel<T>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, K, K, kThreads, l.bytes, s);
  cfg.gridDim = dim3(K, kvh * groups, b);
  // the kernel's attributes and the clusters the card holds, asked once per
  // device, cluster size and CTA bytes: a decode step launches this 32 times
  static std::atomic<long long> asked[kMaxDevices][5];  // bytes + 1 (0: never), active << 32
  static std::atomic<size_t> allowed[kMaxDevices];       // the most bytes the kernel may take
  int dev = 0, ki = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  while ((1 << ki) < K) ++ki;
  const bool cached = dev < kMaxDevices;
  const long long seen = cached ? asked[dev][ki].load() : 0;
  int active = 0;
  if (seen && (seen & 0xffffffffLL) == (long long)l.bytes + 1) {
    active = static_cast<int>(seen >> 32);
  } else {
    if (!cached || l.bytes > allowed[dev].load()) {  // only ever raised: a cached launch may need more
      if ((err = allow_cluster(kernel, l.bytes))) return err;
      if (cached) allowed[dev].store(l.bytes);
    }
    if ((err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg))) return err;
    if (cached) asked[dev][ki].store(((long long)active << 32) | ((long long)l.bytes + 1));
  }
  plan[5] = active;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(kp),
                                static_cast<const T*>(vp), pt, len, static_cast<T*>(out), scratch,
                                smem_scores, h, kvh, dh, p, page, np_, ppc, l.tj, scale, l.pg_at,
                                l.sc_at, l.misc_at, l.comb_at)))
    return err;
  return cudaGetLastError();
}

}  // namespace

// out (b, h * dh) = paged decode attention of q (b, h, dh) over the pools kp,
// vp (p, page, kvh, dh) through pt (b, np_) int32 and len (b,) int32; fp32,
// or bf16 when `bf16` is 1; one launch of clusters of K CTAs
// (kernels/paged_attn.py:paged_plan).  `scratch` holds each CTA's scores,
// (b, kvh * groups, K, min(h / kvh, 4), ceil(np_ / K) * page) fp32, when
// smem_scores is 0.  plan[0..5]: K, head groups, pages a CTA, scores in
// shared memory, shared-memory bytes a CTA and the clusters the card holds
// at once.  A plan whose shared memory no CTA holds returns
// cudaErrorInvalidValue; a cluster the card cannot hold,
// cudaErrorLaunchOutOfResources.
extern "C" int ebv_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                          const void* pt, const void* len, void* out,
                                          void* scratch, int smem_scores, int b, int h, int kvh,
                                          int dh, int p, int page, int np_, int K, float scale,
                                          int bf16, int* plan, void* stream) {
  for (int i = 0; i < 6; ++i) plan[i] = 0;
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pti = static_cast<const int*>(pt);
  const int* lni = static_cast<const int*>(len);
  float* scr = static_cast<float*>(scratch);
  return bf16 ? launch<__nv_bfloat16>(q, kp, vp, pti, lni, out, scr, smem_scores, b, h, kvh, dh, p,
                                      page, np_, K, scale, plan, s)
              : launch<float>(q, kp, vp, pti, lni, out, scr, smem_scores, b, h, kvh, dh, p, page,
                              np_, K, scale, plan, s);
}
