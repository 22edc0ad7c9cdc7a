// The narrow-band no-pivot LU walk for Hopper (sm_90a), fp32, on the
// row-aligned band (row i holds A[i, i-bw .. i+bw] in 2bw+1 floats).
//
// band_lu_warp_kernel<BW, false> — replaces src/repro/kernels/banded.py:
//   banded_lu_blocked (B5) for bw <= 31, the Pallas megakernel that held the
//   whole skewed band in VMEM for ceil(n/C) window steps, and
//   batched_banded_lu_vmem (B11) for bw <= 31, one grid program per system of
//   a stack: here one warp per system, blockIdx.x picking the band at
//   blockIdx.x * n * (2bw+1) floats (64-bit offsets), each system its own
//   walk.  The factor is a chain of n pivots: pivot p divides the bw entries
//   below it by a[p][p] and takes l * u off the bw x bw block it reaches.
//   Bound: n(2bw^2 + bw) flops and the band read once and written once make
//   microseconds of work (0.00042 ms at n = 16000, bw = 5), but each pivot
//   waits on the one before, so what sets the pace is one pivot's latency.
//   The ring walk of banded.cu (band_lu_resident_kernel) pays a block
//   barrier a pivot and ~650 cycles; here the chain stays inside one warp,
//   with no barrier on it:
//   - the bw + 1 live rows of pivot p (p .. p+bw) sit on the warp's lanes,
//     row i on lane i mod 32, and each lane keeps its row's columns
//     p .. p+bw in registers r[0..bw] (r[k] holds column p+k, the same
//     register on every lane, so no register is indexed by the lane);
//   - per pivot the pivot lane's r[0..bw] go to every lane by __shfl_sync;
//     each row lane divides its r[0] (__fdiv_rn) and takes its bw terms
//     (__fmul_rn, __fsub_rn: the plain version's operations and rounding,
//     no contraction); the multiplier goes into the ring, and the pivot
//     row's final values too, lane k storing its entry k;
//   - then every lane shifts r down by one column; the column that enters,
//     p+1+bw, no pivot has touched yet, so each lane reads it at the start
//     of the pivot, off the chain.  For bw <= 15 a lane idles long enough
//     between its rows (31 - bw pivots) to gather its next row a column a
//     pivot the same way; wider bands read the entering row whole;
//   - nothing on the chain branches: a lane with no multiplier stores its l
//     into a spare slot, and the lanes' other choices are selects;
//   - the band streams through a ring of 4 chunks of 32 rows in shared
//     memory (rows padded to 2bw+2 floats, so the lanes' rows fall in
//     distinct banks): cp.async fills each chunk three chunks ahead of the
//     walk, and each chunk goes back to the band once its rows are final,
//     32 pivots apart; the raw band does not depend on the chain.
//   The chain a pivot is one shuffle, one division, one multiply and one
//   subtract.  The walk is templated on bw, so every register index is a
//   constant.  Every entry sees the plain version's operations in its order,
//   the band entries outside the matrix too, so the factor is the plain
//   version's (repro_torch.core.banded.banded_lu_blocked, over the stack for
//   B11) value for value.
//
// band_lu_warp_kernel<BW, true> — replaces src/repro/kernels/banded.py:
//   banded_lu_kernelized (B18) for bw <= 31, the legacy scalar-sequential
//   kernel: each pivot updates its whole (bw, 2bw+1) window, a - l * shifted,
//   where the pivot row's upper tail u enters each window entry by a one-hot
//   contraction, shifted = sum_t onehot_t * u_t with IEEE products (fault C7:
//   0 * inf is NaN).  So: where every u_t is finite, shifted is u on the bw
//   entries the pivot reaches and 0 elsewhere, and the window step is B5's
//   (the entries outside the reach keep their values while l is finite);
//   where exactly one u_t is infinite, the entries of column p+1+t keep it
//   and every other entry's shifted is NaN; otherwise every entry's is NaN.
//   The chain stays B5's (a shuffle, a division, a multiply and a subtract),
//   and nothing branches: the rule is selects beside it and one predicated
//   store.  The tail test reads the u the lanes already hold from the
//   shuffle (a mask of its non-finite entries, the same on every lane); the
//   reach takes a - l * u', u' = u but NaN where another tail entry is not
//   finite, computed beside the division.  A live row whose l or tail is
//   not finite turns NaN its entries outside the reach: its columns past
//   p+bw are read back only by its own lane, one a pivot as the column
//   entering, and the row's multiplier at every later pivot is then not
//   finite either (a - l * u' with l or u' not finite is not finite), so
//   the column read ahead turns NaN at each such pivot; its L part left of
//   column p is final, so the lane stores how many of its entries are NaN
//   into a count a ring slot (the last such pivot's), applied when the
//   chunk goes back to the band.  The anti-diagonal takes l.  Factor: the plain version's
//   (repro_torch.kernels.banded.banded_lu_window_plain) value for value.
//   Wider bands take banded.cu's ring walk or its device-memory walk.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "async_copy.cuh"

namespace {

constexpr int kChunk = 32;          // band rows a copy group stages
constexpr int kChunks = 4;          // chunks in the ring: two walked, two in flight
constexpr int kRingRows = kChunk * kChunks;
constexpr unsigned kFull = 0xffffffffu;
// pivots of the walk unrolled, so the compiler can interleave one pivot's
// reads and stores with the next one's chain
constexpr int kWalkUnroll = 4;

extern __shared__ __align__(16) float walk_smem[];

template <int BW, bool kWindow>
__global__ void __launch_bounds__(32, 1) band_lu_warp_kernel(float* __restrict__ band, int n) {
  constexpr int W = 2 * BW + 1;  // a band row
  band += (size_t)blockIdx.x * n * W;  // the system (0 for one band)
  constexpr int LD = W + 1;      // a ring row: even, so rows one apart lie LD - 1 (odd) banks apart
  // A lane idles 31 - bw pivots between its rows, enough for bw <= 15 to read
  // its next row's columns one a pivot, as every live lane does; wider bands
  // read the entering row whole.
  constexpr bool kPreload = 2 * BW <= 31;
  const int lane = threadIdx.x;
  const int chunks = (n + kChunk - 1) / kChunk;
  float* const spare = walk_smem + kRingRows * LD;  // where a lane with no multiplier stores its l
  // B18: a ring slot's row has its band entries 0 .. nan_left-1 NaN (its L
  // part left of the last pivot whose l or tail was not finite); then 32
  // slots where the other lanes store theirs, so that the store does not branch
  int* const nan_left = reinterpret_cast<int*>(spare + 32);
  auto row_at = [&](int i) { return walk_smem + (i & (kRingRows - 1)) * LD; };
  // chunk c of the band into its ring slots, one copy group (empty past the band)
  auto stage = [&](int c) {
    if (c < chunks) {
      const int r0 = c * kChunk, count = min(kChunk, n - r0) * W;
      const float* src = band + (size_t)r0 * W;
      float* dst = row_at(r0);
      for (int idx = lane; idx < count; idx += 32) {
        const int r = idx / W;
        cp_async4(dst + r * LD + (idx - r * W), src + idx);
      }
    }
    cp_async_commit();
  };
  // the final rows of chunk c back to the band
  auto write_back = [&](int c) {
    const int r0 = c * kChunk, count = min(kChunk, n - r0) * W;
    float* dst = band + (size_t)r0 * W;
    const float* src = row_at(r0);
    for (int idx = lane; idx < count; idx += 32) {
      const int r = idx / W, t = idx - r * W;
      float v = src[r * LD + t];
      if constexpr (kWindow) v = t < nan_left[(r0 + r) & (kRingRows - 1)] ? CUDART_NAN_F : v;
      dst[idx] = v;
    }
  };
  // B18: the slots of chunk c take new rows, with no NaN entries yet (after a __syncwarp)
  auto clear_nan_left = [&](int c) {
    if constexpr (kWindow) nan_left[(c * kChunk + lane) & (kRingRows - 1)] = 0;
  };

  for (int c = 0; c < kChunks; ++c) {
    stage(c);
    clear_nan_left(c);
  }
  cp_async_wait<kChunks - 2>();  // chunks 0 and 1
  __syncwarp();
  float r[BW + 1];  // r[k]: column p+k of this lane's row (row p + ((lane - p) mod 32))
  {
    const float* row = row_at(lane);
#pragma unroll
    for (int k = 0; k <= BW; ++k) {  // columns 0 .. bw of row `lane`, where its band has them
      const int t = k - lane + BW;
      r[k] = row[t > 0 ? t : 0];
    }
  }
  for (int c = 0; c < chunks; ++c) {
    if (c > 0) {
      // the rows before chunk c are final: their chunk goes back to the band
      // and its slots take the chunk three ahead
      __syncwarp();
      write_back(c - 1);
      __syncwarp();
      clear_nan_left(c - 1);
      stage(c + kChunks - 1);
      cp_async_wait<kChunks - 2>();  // chunks c and c+1, the rows the walk reads until p+32
      __syncwarp();
    }
    const int pend = min(n, (c + 1) * kChunk);
#pragma unroll kWalkUnroll
    for (int p = c * kChunk; p < pend; ++p) {
      const int d = (lane - p) & 31;  // this lane holds row p + d now
      const int dn = (d - 1) & 31;    // and row p+1+dn at pivot p+1
      const int i = p + d, in = p + 1 + dn;
      const bool live = d >= 1 && d <= BW && i < n;  // a row the pivot reaches
      // The reads for pivot p+1 first, off the chain: band entries no pivot up
      // to p touches (column p+1+bw of row p+1+dn, and row p+1+bw whole where
      // it enters), none of which pivot p's stores below write.
      const float* next_row = row_at(in);
      const int tn = 2 * BW - dn;
      float next = next_row[tn > 0 ? tn : 0];
      float enter[BW];  // row p+1+bw, read by every lane at one address (a broadcast), kept by its lane
      if constexpr (!kPreload) {
        const float* entering = row_at(p + 1 + BW);
#pragma unroll
        for (int k = 0; k < BW; ++k) enter[k] = entering[k];
      }
      // the pivot row p, from its lane to every lane
      const int pl = p & 31;
      const float piv = __shfl_sync(kFull, r[0], pl);
      float u[BW + 1];
#pragma unroll
      for (int k = 1; k <= BW; ++k) u[k] = __shfl_sync(kFull, r[k], pl);
      // B18: u' = u but NaN where another tail entry is not finite (0 * inf
      // in the one-hot contraction); B5: u' = u
      float us[BW + 1];
      unsigned bad = 0;  // the tail's non-finite entries, the same on every lane
#pragma unroll
      for (int k = 1; k <= BW; ++k) {
        us[k] = u[k];
        if constexpr (kWindow) bad |= isfinite(u[k]) ? 0u : 1u << k;
      }
      if constexpr (kWindow) {
#pragma unroll
        for (int k = 1; k <= BW; ++k) us[k] = (bad & ~(1u << k)) ? CUDART_NAN_F : us[k];
      }
      const float l = __fdiv_rn(live ? r[0] : piv, piv);
      float upd[BW + 1];
#pragma unroll
      for (int k = 1; k <= BW; ++k) upd[k] = __fsub_rn(r[k], __fmul_rn(l, us[k]));
      if constexpr (kWindow) {
        // the row's entries outside the reach take a - l * NaN: those past
        // column p+bw as they enter, those left of column p at write-back
        const bool hit = live && (bad || !isfinite(l));
        next = hit ? CUDART_NAN_F : next;
        nan_left[hit ? i & (kRingRows - 1) : kRingRows + lane] = BW - d;
      }
      // A[i, p] = l; lane k stores A[p, p+k], the pivot row's final values
      *(live ? row_at(i) + BW - d : spare + lane) = l;
      float mine = piv;
#pragma unroll
      for (int k = 1; k <= BW; ++k) mine = lane == k ? u[k] : mine;
      if (lane <= BW) row_at(p)[BW + lane] = mine;
      // pivot p+1: every register moves down a column
#pragma unroll
      for (int k = 0; k < BW; ++k) r[k] = live ? upd[k + 1] : kPreload ? r[k + 1] : enter[k];
      r[BW] = next;
    }
  }
  cp_async_wait<0>();
  __syncwarp();
  if (chunks > 0) write_back(chunks - 1);
}

template <int BW>
cudaError_t launch_warp_walk(float* band, int batch, int n, bool window, cudaStream_t stream) {
  // the ring, `spare` and B18's `nan_left`: at most 33 KB
  const size_t bytes = ((size_t)kRingRows * (2 * BW + 2) + 32 + kRingRows + 32) * sizeof(float);
  if (window) band_lu_warp_kernel<BW, true><<<batch, 32, bytes, stream>>>(band, n);
  else band_lu_warp_kernel<BW, false><<<batch, 32, bytes, stream>>>(band, n);
  return cudaGetLastError();
}

}  // namespace

// Factor the `batch` row-aligned (n, 2bw+1) fp32 bands at `band` (one after
// the other) in place by the warp walk, one launch of one warp a band (none
// for an empty stack or band); 1 <= bw <= 31, so that the bw + 1 live rows fit
// a warp's lanes.  `window`: B18's window step in place of B5's.
cudaError_t band_lu_warp_walk(float* band, int batch, int n, int bw, bool window,
                              cudaStream_t stream) {
  if (bw < 1 || bw > 31) return cudaErrorInvalidValue;
  if (n < 1 || batch < 1) return cudaSuccess;
  switch (bw) {
#define EBV_WALK(B) \
  case B:           \
    return launch_warp_walk<B>(band, batch, n, window, stream);
    EBV_WALK(1) EBV_WALK(2) EBV_WALK(3) EBV_WALK(4) EBV_WALK(5) EBV_WALK(6) EBV_WALK(7) EBV_WALK(8)
    EBV_WALK(9) EBV_WALK(10) EBV_WALK(11) EBV_WALK(12) EBV_WALK(13) EBV_WALK(14) EBV_WALK(15)
    EBV_WALK(16) EBV_WALK(17) EBV_WALK(18) EBV_WALK(19) EBV_WALK(20) EBV_WALK(21) EBV_WALK(22)
    EBV_WALK(23) EBV_WALK(24) EBV_WALK(25) EBV_WALK(26) EBV_WALK(27) EBV_WALK(28) EBV_WALK(29)
    EBV_WALK(30) EBV_WALK(31)
#undef EBV_WALK
    default:
      return cudaErrorInvalidValue;
  }
}
