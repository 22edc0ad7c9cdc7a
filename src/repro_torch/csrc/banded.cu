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
//   banded_lu_blocked (B5) for bands past bw = 31 (band_walk.cu's warp walk
//   takes the narrower ones), the Pallas megakernel that held the whole
//   skewed band in VMEM for ceil(n/C) window steps.  One launch, one block:
//   the band is streamed through a ring of R rows in shared memory
//   (R*(2bw+1) floats, up to 227 KB), so each band row is read once and
//   written once and the bw carry rows of a chunk stay on chip for the
//   next; one block barrier a pivot.  Where not even bw+1 rows fit
//   (bw > ~168), band_lu_global_kernel runs the same walk on the band in
//   device memory; its working set, bw+1 rows, stays in the 50 MB L2.
//
// band_lu_slab_kernel, band_lu_cluster_kernel — replace src/repro/kernels/
//   banded.py:banded_lu_tiled, whose grid steps ran in order on the TPU, step
//   s+1 reading the carry rows step s wrote.  Bands of bw <= 32 whose step's
//   (C+bw, 2bw+1) slab fits one block's shared memory take one launch a step
//   in stream order: S = ceil(n/C) launches, each staging its slab through
//   shared memory and writing it back (at n = 16384 the cluster walk below
//   is 1.5x slower at bw = 16 and 1.1x at 32, but 1.3x faster at 36, where
//   a block's 32 columns no longer cover a row's bw).  Wider bands (the Poisson band, bw = 256) are one launch of a
//   thread-block cluster of
//   K CTAs (band_lu_cluster_kernel; kernels/banded.py:tiled_plan picks the
//   path, K and the group g):
//   - the band's active rows live in a ring spread over the cluster's shared
//     memory, row i in CTA i mod K, so every CTA retires bw/K rows of each
//     pivot's bw x bw block (the paper's equal contribution); rows enter
//     the ring by cp.async a group ahead of need, and every entry of the
//     band is read once and written once;
//   - pivots go in groups of g: the owners of the group's panel rows (its g
//     pivot rows and the g columns of the bw rows below) write them into
//     every CTA's shared memory through DSMEM a group ahead, as soon as the
//     previous group's update has reached them, and every CTA factors the
//     panel itself, so no panel has to be handed back: the g columns a
//     thread a row in registers, one block barrier a pivot, then the pivot
//     rows past them (U12) a thread a column; then it applies one rank-g
//     update to its own rows, each entry taking the g terms in pivot order,
//     first the rows and columns the next panel needs (one group of
//     lookahead), then one split cluster barrier a group, then the rest of
//     the update.
//   Bound of both factors: n*(2bw^2+bw) flops and 2*n*(2bw+1)*4 bytes make
//   microseconds of work, but the n pivots are a dependent chain.  The slab
//   path pays one block barrier a pivot; the cluster walk one cluster
//   barrier and g block barriers a group of g pivots, with the bw^2 g update
//   split over K SMs.  A band whose group of rows and panels no cluster's
//   CTAs hold (bw past ~490) takes one launch of band_lu_global_kernel,
//   B5's walk on the band in device memory (its speed is not tuned here).
//
// band_solve_staged_kernel — replaces src/repro/kernels/banded.py:
//   banded_solve_kernelized.  Forward then backward substitution in strips
//   of 32 rows, one launch of a block of W warps (8 by default) per tile of
//   up to 8 RHS columns.  Bound: the band's n*(2bw+1)*4 bytes, but the
//   2 n/32 strips are a dependent chain, and what sets the pace is each
//   strip's latency.  So the design keeps band loads and the bulk of each
//   row's sum off the chain:
//   - a strip's half of the band (L forward, the diagonal and U backward)
//     enters a ring of R (2-4) shared-memory buffers by 16-byte cp.async,
//     R - 1 strips ahead of the helpers that need it first (the band does
//     not depend on x), rows skewed so that a band diagonal spans 32 banks;
//   - a solver warp per column walks the chain: its lanes' rows start from
//     b (y) less the helper warps' partial sums, retire the previous
//     strip's 32 x 32 block (its values in registers, passed by
//     __shfl_sync; the block's band entries loaded into registers one step
//     ahead) and solve the strip's triangle by 31 shuffles; one block
//     barrier a strip;
//   - meanwhile the helper warps (past the solvers, or all where there are
//     none) retire the next strip's terms against strips solved two or more
//     strips before, each a slice of the band's diagonals, against a ring
//     of the last bw + 64 solved values a column, into partial sums.
//   The sums run in another order than the plain version's blocks: B7 is
//   held to it within 1e-4 normwise.  Bands too wide for two staged strips
//   (bw past ~870) keep band_solve_kernel.
//
// band_solve_kernel — B7 before its staged redesign, kept for the bands too
//   wide to stage (for B7 and B12).  One warp per RHS column walks the
//   rows in 32-row strips, forward then backward: each lane holds one row,
//   first retires the rows of earlier strips (at most bw terms, read from a
//   ring of the warp's last solved values in shared memory), then the
//   strip's triangle is solved in registers with the solved value passed
//   by __shfl_sync.  No block barrier at all; a vector RHS runs on one SM
//   with every band load on the chain.
//
// band_gemm_kernel + band_tail_scan_kernel — replace src/repro/kernels/
//   banded.py:banded_solve_inverted.  From the artifact's (S, C, C) inverses
//   and (S, C, bw) transfer blocks each sweep is a batched product over all S
//   blocks (many blocks in flight), the (bw, m) tail recurrence over S, and a
//   second batched product: six launches in stream order (two when S = 1).
//   Bound: the inverses' 2*S*C*C*4 bytes.  Up to 4 RHS columns a product is
//   band_gemv_kernel, a thread per row (a 32-wide tile would keep 4 of its
//   32 columns).  The recurrence is a chain of S steps y_i = z_i - T_i
//   y_{i-1}, each a (bw, bw) by (bw, m) product; up to bw = 32 it is
//   band_scan_warp_kernel: a block of two warps per group of KC RHS columns
//   (one up to m = 512, at most 8).  A producer warp copies T_i's (bw, bw) tail and z_i's rows up to
//   32 steps ahead into a shared-memory ring (cp.async, a full and an empty
//   mbarrier a slot); the solver warp's lane r computes row r of the state,
//   the last state coming by __shfl_sync, so no block barrier and no
//   device-memory load sits on the chain.  Wider bands keep
//   band_tail_scan_kernel (one block per 32 columns, the state in shared
//   memory; at bw = 256 one step's T is 256 KB, more than a block's shared
//   memory), its threads on the (row, column) pairs that exist and each
//   thread's row of T read in chunks of 16 16-byte loads.  Every sum runs as
//   the tile product's and the block scan's do (k ascending), so the values
//   are theirs.
//   The products' grid folds (column tile, row tile, s) into blockIdx.x, so
//   S may pass the 65,535 of a grid's z extent (n past 65,535 * C rows,
//   2,097,120 for a tridiagonal band); offsets are 64-bit.
// batched_band_lu (ebv_batched_band_lu) — replaces src/repro/kernels/
//   banded.py:batched_banded_lu_vmem, one grid program per system running
//   the band_block_step loop on its VMEM-resident skewed band.  Up to
//   bw = 31 it is band_walk.cu's warp walk with one warp per system, in one
//   launch; wider bands take band_lu_resident_kernel's walk
//   (band_lu_global_kernel's for bands too wide for the ring) with one block
//   per system.  blockIdx.x picks the system, whose band starts at
//   blockIdx.x * n * (2bw+1) floats (64-bit offsets).  Each system is the
//   same dependent pivot chain as the unbatched factor, so the batch only
//   fills more SMs; the chain bounds each system as it does B5.  Bitwise
//   equal to the plain version (repro_torch.core.banded.banded_lu_blocked
//   over the stack).
//
// batched band solve (ebv_band_solve over a stack) — replaces src/repro/kernels/
//   banded.py:batched_banded_solve_vmem, one grid program per system.  Here
//   it is B7's band_solve_staged_kernel over the stack in one launch, with
//   B7's plan for one system (kernels/banded.py:band_solve_plan): one block
//   per (system, tile of RHS columns), blockIdx.x = system * tiles + tile,
//   so any number of systems fits the grid (up to 2^31 - 1 blocks); bands
//   past the staged kernel's reach keep band_solve_kernel with the same
//   fold.  A system's band starts s * n * (2bw+1) floats into the stack
//   (64-bit offsets), not always on a 16-byte boundary, so the staged
//   strips' chunks are aligned on the stack's base.  Each system runs B7's
//   operations in B7's order: its x is bitwise B7's on that system alone.
//   Bound and latency as for B7, per system: a stack of m = 1 systems is
//   one system's chain while the systems fit the card at once.
//
// band_lu_resident_kernel<true> (ebv_band_lu_scalar) — replaces src/repro/
//   kernels/banded.py:banded_lu_kernelized, the legacy scalar-sequential
//   Pallas kernel: n-1 fori_loop steps on the VMEM-resident band, each
//   updating the whole (bw, 2bw+1) window below the pivot, the pivot row's
//   upper tail shifted into each row by a one-hot contraction.  Up to
//   bw = 31 it is band_walk.cu's warp walk with that step; wider bands take
//   the one-launch ring walk of B5 with that step body
//   (retire_pivots_window): every window entry takes a - l*shifted, two
//   barriers per pivot (multipliers first, then the window), or the same
//   step in device memory for bands too wide for the ring.  shifted follows
//   the contraction's IEEE products (fault C7): u on the entries the tail
//   reaches and 0 elsewhere while the tail is finite; where exactly one tail
//   entry is infinite, that entry on the entries that take its column and
//   NaN elsewhere; otherwise NaN throughout.  So the factor is the plain
//   version's (repro_torch.kernels.banded.banded_lu_window_plain) value for
//   value.  Bound and latency as for B5, with 2bw+1 entries per window row
//   instead of bw.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>

#include "async_copy.cuh"
#include "cluster.cuh"
#include "nonfinite.cuh"

namespace cg = cooperative_groups;

// the warp walk of B5, B11 and (window) B18 for bands up to bw = 31 (band_walk.cu)
cudaError_t band_lu_warp_walk(float* band, int batch, int n, int bw, bool window,
                              cudaStream_t stream);

namespace {

constexpr int kWarpWalkMaxBw = 31;  // the widest band the warp walk takes (band_walk.cu)

constexpr int kSmemBytes = 232448;  // dynamic shared memory one H100 block may use
constexpr int kTile = 32;           // batched-product tile and scan column group
constexpr int kGemvCols = 4;        // widest RHS of the narrow product (band_gemv_kernel)
constexpr int kInFlight = 8;        // band updates a factor thread loads before it stores

extern __shared__ __align__(16) float smem[];  // 16 bytes for cp.async and float4

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

// The step of the scalar-sequential factor (B18) for pivots [p0, p1):
// the bw multipliers go to lv (bw floats), then every entry t of window
// row r (band row p+1+r, rows at or past n absent) takes a - l*shifted,
// shifted the one-hot contraction of the pivot row's upper tail (fault C7):
// the tail entry that column t meets, or 0 where it meets none, while the
// tail is finite; else NaN, but for the entries that meet a lone infinity.
// The anti-diagonal entry takes its multiplier.  Two barriers per pivot:
// the window update reads the raw L column only through lv; the first
// counts the threads that found a non-finite tail entry, and a second, only
// where some did, tells one such entry from several.
template <class Rows>
__device__ void retire_pivots_window(const Rows& rows, float* lv, int p0, int p1, int n, int bw) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const int W = 2 * bw + 1;
  for (int p = p0; p < p1; ++p) {
    const int nr = min(bw, n - 1 - p);  // rows below the pivot
    if (nr <= 0) break;                 // the last pivot reaches no row
    const float* prow = rows.row(p);
    const float piv = prow[bw];
    for (int r = tid; r < nr; r += nt) lv[r] = __fdiv_rn(rows.row(p + 1 + r)[bw - 1 - r], piv);
    int bad = 0;  // this thread's non-finite tail entries
    for (int t = tid; t < bw; t += nt) bad += !isfinite(prow[bw + 1 + t]);
    const int bad_threads = __syncthreads_count(bad > 0);
    // block-uniform: a lone non-finite entry, or more than one
    const bool lone = bad_threads == 1 && !__syncthreads_or(bad > 1);
    for (int idx = tid; idx < nr * W; idx += nt) {
      const int r = idx / W, t = idx - r * W;
      const int src = t - (bw - r);  // band row p+1+r, column t is A[p+1+r, p+1+src]
      float u = (src >= 0 && src < bw) ? prow[bw + 1 + src] : 0.0f;
      if (bad_threads && !(lone && !isfinite(u))) u = CUDART_NAN_F;
      float* a = rows.row(p + 1 + r) + t;
      const float v = __fsub_rn(*a, __fmul_rn(lv[r], u));
      *a = t == bw - 1 - r ? lv[r] : v;
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

// One block per system: blockIdx.x picks the band (one block when unbatched).
// kWindow: the scalar-sequential step (B18) in place of the staged one.
template <bool kWindow>
__global__ void band_lu_resident_kernel(float* band, int n, int bw, int R, int C) {
  const int W = 2 * bw + 1;
  band += (size_t)blockIdx.x * n * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const RingRows rows{smem, R, W};
  float* lbuf = smem + (size_t)R * W;
  const int first = min(R, n);
  for (int idx = tid; idx < first * W; idx += nt) smem[idx] = band[idx];
  __syncthreads();
  for (int k0 = 0; k0 < n; k0 += C) {
    const int k1 = min(k0 + C, n);
    if (kWindow) retire_pivots_window(rows, lbuf, k0, k1, n, bw);
    else retire_pivots_staged(rows, lbuf, k0, k1, n, bw);
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

template <bool kWindow>
__global__ void band_lu_global_kernel(float* band, int n, int bw, int p0, int p1) {
  band += (size_t)blockIdx.x * n * (2 * bw + 1);  // the system (0 when unbatched)
  const GlobalRows rows{band, 2 * bw + 1};
  if (kWindow) retire_pivots_window(rows, smem, p0, p1, n, bw);
  else retire_pivots_global(rows, smem, smem + bw, p0, p1, n, bw);
}

// ---------------------------------------------------------------------------
// the wide-band factor on a thread-block cluster (band_lu_cluster_kernel)
// ---------------------------------------------------------------------------
constexpr int kClusterThreads = 512;  // a CTA; at least the G + bw rows of a panel

// The shared memory of a CTA of the cluster walk with K CTAs and groups of G
// pivots: the ring (RK rows of 2bw+1 floats; row i of the band in CTA i mod K,
// slot (i / K) mod RK), then the panels: a group's G pivot rows over the
// columns [p0, p0 + G + bw) (UP, stride ldu; the columns past the group
// used; three, for groups g mod 3), the group's G columns of the rows
// p0 .. p0+G+bw-1 (PC, stride G+1: a thread a row reads them free of bank
// conflicts; two, for groups g mod 2) and their multipliers (ML).  The
// owners of a panel's rows write it into every CTA's UP and PC a group
// ahead; a CTA may still read group g-1's UP while group g+1's arrives.
// K * RK covers the 2G + bw rows live during a group.
struct BandCluster {
  int K, G, RK, ldu;
  size_t up_at, pc_at, ml_at, bytes;
};

inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

inline BandCluster band_cluster_layout(int bw, int K, int G) {
  BandCluster c{K, G, (2 * G + bw + K - 1) / K, (G + bw + 3) / 4 * 4, 0, 0, 0, 0};
  c.up_at = align16((size_t)c.RK * (2 * bw + 1) * sizeof(float));
  c.pc_at = c.up_at + 3 * (size_t)G * c.ldu * sizeof(float);
  c.ml_at = c.pc_at + 2 * (size_t)(G + bw) * (G + 1) * sizeof(float);
  c.bytes = c.ml_at + (size_t)(G + bw) * (G + 1) * sizeof(float);
  return c;
}

template <int G>
__global__ void __launch_bounds__(kClusterThreads, 1)
band_lu_cluster_kernel(float* band, int n, int bw, int RK, int ldu, size_t up_at, size_t pc_at,
                       size_t ml_at) {
  constexpr int LDL = G + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = cluster.num_blocks(), rank = cluster.block_rank();
  const int W = 2 * bw + 1, tid = threadIdx.x, nt = blockDim.x;
  char* base = reinterpret_cast<char*>(smem);
  float* ring = smem;
  float* const UP0 = reinterpret_cast<float*>(base + up_at);
  float* const PC0 = reinterpret_cast<float*>(base + pc_at);
  float* ML = reinterpret_cast<float*>(base + ml_at);
  const int up_size = G * ldu, pc_size = (G + bw) * LDL;
  auto slot = [&](int i) { return (size_t)((i / K) % RK) * W; };
  auto first_own = [&](int lo) { return lo + ((rank - lo % K) % K + K) % K; };
  // cp.async of the own rows of [lo, hi) into the ring
  auto load_rows = [&](int lo, int hi) {
    hi = min(hi, n);
    const int first = first_own(lo), count = first < hi ? (hi - 1 - first) / K + 1 : 0;
    for (int idx = tid; idx < count * W; idx += nt) {
      const int i = first + idx / W * K, t = idx % W;
      cp_async4(ring + slot(i) + t, band + (size_t)i * W + t);
    }
    cp_async_commit();
  };
  // Write the own rows' entries of group gi's panel into every CTA's UP
  // and PC for the group: its pivot rows [q0, qe) past its columns
  // (U12), and the group's columns of the rows [q0, min(n, qe + bw)).  The
  // entries carry every earlier group's terms: the previous group's update
  // has reached them, or they are fresh from the band.
  auto push = [&](int gi) {
    const int q0 = gi * G, qe = min(q0 + G, n), prows = min(n, qe + bw) - q0;
    float* up = UP0 + (gi % 3) * up_size;
    float* pc = PC0 + (gi & 1) * pc_size;
    const int first = first_own(q0), rows = first < q0 + prows ? (q0 + prows - 1 - first) / K + 1 : 0;
    for (int idx = tid; idx < rows * G; idx += nt) {
      const int r = first + idx / G * K, j = q0 + idx % G;
      if (j >= qe || j < r - bw || j > r + bw) continue;
      const float v = ring[slot(r) + j - r + bw];
      float* dst = pc + (r - q0) * LDL + (j - q0);
      for (int d = 0; d < K; ++d) *cluster.map_shared_rank(dst, d) = v;
    }
    const int qrows = first < qe ? (qe - 1 - first) / K + 1 : 0, wide = ldu - G;
    for (int idx = tid; idx < qrows * wide; idx += nt) {
      const int q = first + idx / wide * K, j = qe + idx % wide;
      if (j > q + bw || j >= n) continue;
      const float v = ring[slot(q) + j - q + bw];
      float* dst = up + (q - q0) * ldu + (j - q0);
      for (int d = 0; d < K; ++d) *cluster.map_shared_rank(dst, d) = v;
    }
  };
  // the rank-G update of the own rows [r_lo, r_hi) over the columns
  // [c_lo, c_hi) (c_lo - p0 a multiple of 4): a[r][j] -= l_rp u_pj for the
  // group's pivots p in order, those the band reaches (p >= r - bw, j - bw)
  auto trail = [&](int p0, const float* UP, int r_lo, int r_hi, int c_lo, int c_hi) {
    r_hi = min(r_hi, n);
    c_hi = min(c_hi, n);
    if (r_lo >= r_hi || c_lo >= c_hi) return;
    const int first = first_own(r_lo), rows = first < r_hi ? (r_hi - 1 - first) / K + 1 : 0;
    const int quads = (c_hi - c_lo + 3) / 4;
    for (int it = tid; it < rows * quads; it += nt) {
      const int r = first + it / quads * K, j = c_lo + 4 * (it % quads);
      float* row = ring + slot(r) + bw - r;  // row[j] = A[r, j]
      const float* ml = ML + (size_t)(r - p0) * LDL;
      const float* up = UP + (j - p0);
      float acc[4];
      int lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = j + q < c_hi;
        acc[q] = ok ? row[j + q] : 0.f;
        lo[q] = ok ? max(p0, max(r, j + q) - bw) - p0 : G;  // the first term the entry takes
      }
#pragma unroll
      for (int pp = 0; pp < G; ++pp) {
        const float l = ml[pp];
        const float4 u = *reinterpret_cast<const float4*>(up + (size_t)pp * ldu);
        if (pp >= lo[0]) acc[0] = __fsub_rn(acc[0], __fmul_rn(l, u.x));
        if (pp >= lo[1]) acc[1] = __fsub_rn(acc[1], __fmul_rn(l, u.y));
        if (pp >= lo[2]) acc[2] = __fsub_rn(acc[2], __fmul_rn(l, u.z));
        if (pp >= lo[3]) acc[3] = __fsub_rn(acc[3], __fmul_rn(l, u.w));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < c_hi) row[j + q] = acc[q];
    }
  };

  load_rows(0, G + bw);
  cp_async_wait<0>();
  __syncthreads();
  cluster_arrive();  // every CTA runs before any writes another's shared memory
  cluster_wait();
  push(0);
  cluster_arrive_release();
  const int groups = (n + G - 1) / G;
  for (int gi = 0; gi < groups; ++gi) {
    const int p0 = gi * G, pe = min(p0 + G, n), np = pe - p0;
    cluster_wait();  // the group's panel is in UP and PC
    load_rows(p0 + G + bw, p0 + 2 * G + bw);  // the next panel's new rows, into retired slots
    const int prows = min(n, pe + bw) - p0;  // the panel's rows p0 .. min(n, pe+bw)-1
    float* UP = UP0 + (gi % 3) * up_size;
    float* PC = PC0 + (gi & 1) * pc_size;
    // factor the panel's columns, pivot by pivot: thread t holds panel row
    // t (band row p0 + t) over the group's columns in registers; row r takes
    // l = a[r][p] / a[p][p] (into ML) and a[r][j] -= l * a[p][j] over the
    // group's columns j > p (its L part and, for the group's own rows, the
    // upper triangle); the next pivot row's owner publishes it in PC; one
    // block barrier a pivot
    float x[G];  // the pivot loop is unrolled so that x stays in registers
#pragma unroll
    for (int jj = 0; jj < G; ++jj) x[jj] = tid < prows ? PC[tid * LDL + jj] : 0.f;
#pragma unroll
    for (int pp = 0; pp < G; ++pp) {
      if (pp >= np) break;
      const int rend = min(n - 1, p0 + pp + bw) - p0;  // rows pp+1 .. rend of the panel
      const float* prow = PC + pp * LDL;
      if (tid > pp && tid <= rend) {
        const float l = __fdiv_rn(x[pp], prow[pp]);
        ML[tid * LDL + pp] = l;
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
          if (jj > pp && jj < np) x[jj] = __fsub_rn(x[jj], __fmul_rn(l, prow[jj]));
      }
      if (tid == pp + 1)
#pragma unroll
        for (int jj = 0; jj < G; ++jj) PC[tid * LDL + jj] = x[jj];
      __syncthreads();
    }
    if (tid < np)  // the group's upper triangle, for the band
#pragma unroll
      for (int jj = 0; jj < G; ++jj) PC[tid * LDL + jj] = x[jj];
    // the group's rows past its columns (U12), a thread a column held in
    // registers: row q takes the terms of the group's pivots p < q in
    // order, those the band reaches (j <= p + bw)
    for (int jj = G + tid; jj < ldu && p0 + jj < n; jj += nt) {
      float u[G];
#pragma unroll
      for (int qq = 0; qq < G; ++qq) u[qq] = UP[qq * ldu + jj];
#pragma unroll
      for (int qq = 1; qq < G; ++qq) {
        if (qq >= np || jj > qq + bw) continue;  // past the group, or past row q's band
#pragma unroll
        for (int pp = 0; pp < qq; ++pp)
          if (jj <= pp + bw) u[qq] = __fsub_rn(u[qq], __fmul_rn(ML[qq * LDL + pp], u[pp]));
      }
#pragma unroll
      for (int qq = 1; qq < G; ++qq)
        if (qq < np) UP[qq * ldu + jj] = u[qq];
    }
    __syncthreads();
    // the panel's entries are final: the own rows' go to the band (L from
    // ML, the group's upper triangle from PC, U12 from UP)
    {
      const int first = first_own(p0), rows = first < p0 + prows ? (p0 + prows - 1 - first) / K + 1 : 0;
      for (int idx = tid; idx < rows * G; idx += nt) {
        const int r = first + idx / G * K, rr = r - p0, jj = idx % G, j = p0 + jj;
        if (j < pe && j >= r - bw && j <= r + bw)
          band[(size_t)r * W + j - r + bw] = j < r ? ML[rr * LDL + jj] : PC[rr * LDL + jj];
      }
      const int qrows = first < pe ? (pe - 1 - first) / K + 1 : 0, wide = ldu - G;
      for (int idx = tid; idx < qrows * wide; idx += nt) {
        const int q = first + idx / wide * K, jj = G + idx % wide, j = p0 + jj;
        if (j <= q + bw && j < n) band[(size_t)q * W + j - q + bw] = UP[(q - p0) * ldu + jj];
      }
    }
    // the rank-G update: first what the next panel reads (the next G rows,
    // and the next G columns of the rows below them), then the rest
    trail(p0, UP, pe, pe + G, pe, pe + bw);
    trail(p0, UP, pe + G, pe + bw, pe, pe + G);
    cp_async_wait<0>();
    __syncthreads();
    if (gi + 1 < groups) push(gi + 1);
    cluster_arrive_release();
    trail(p0, UP, pe + G, pe + bw, pe + G, pe + bw);
    __syncthreads();  // the panel buffers are free for the next group
  }
  cluster_wait();
}

// x = (LU)^-1 b; one warp per RHS column, blockDim.x / 32 columns per block;
// blockIdx.x = system * tiles + RHS tile (system 0 when unbatched), so a
// stack of any size fits the grid's x extent.
// With cap > 0 each warp keeps the last cap (>= min(bw, n) + 32) solved
// values of its column in a ring in shared memory, so the next strip reads
// them without a round trip through L2; with cap = 0 it reads them back
// from x.
__global__ void band_solve_kernel(const float* __restrict__ lu, const float* __restrict__ b,
                                  float* x, int n, int bw, int m, int cap, int tiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sys = blockIdx.x / tiles;
  const int col = (blockIdx.x - sys * tiles) * (blockDim.x >> 5) + warp;
  if (col >= m) return;  // uniform across the warp
  const int W = 2 * bw + 1;
  lu += (size_t)sys * n * W;
  b += (size_t)sys * n * m;
  x += (size_t)sys * n * m;
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

// ---------------------------------------------------------------------------
// the band solve B7 with its strips staged ahead (band_solve_staged_kernel)
// ---------------------------------------------------------------------------
constexpr int kSolveCols = 8;          // RHS columns a block of the staged solve takes at most
constexpr int kSolveMaxThreads = 512;  // 16 warps

// A staged strip: 32 band rows of one half of the band (forward: the L half,
// band columns [0, bw); backward: the diagonal and the U half, [bw, 2bw]),
// each row copied in 16-byte chunks from the aligned chunk that holds its
// first entry; row rr starts at rr * S + 4 * (rr / 8) floats with S / 4
// odd, so the 32 lanes that read one band diagonal (entry e of 32 rows)
// hit 32 banks.  The kernels/banded.py:band_solve_plan mirror computes the
// same sizes.
struct SolveLayout {
  int S, stage, cap, bytes;
};

inline SolveLayout solve_layout(int bw, int cols, int warps, int stages) {
  int q = (bw + 7 + 3) / 4;  // a half's bw + 1 entries and up to 6 of alignment
  if (!(q & 1)) ++q;
  SolveLayout l;
  l.S = 4 * q;
  l.stage = 32 * l.S + 16;
  l.cap = (bw + 64 + 31) / 32 * 32;
  const int helpers = warps > cols ? warps - cols : warps;
  l.bytes = (stages * l.stage + cols * l.cap + 2 * helpers * cols * 32) * (int)sizeof(float);
  return l;
}

// x = (LU)^-1 b on the packed band, RHS columns c0 .. c0 + ct - 1 of the
// block's tile (ct <= kSolveCols), strips of 32 rows forward then backward,
// one block barrier a strip.  In a stack of `batch` bands blockIdx.x =
// system * tiles + tile; system s's band starts s * n * (2bw+1) floats past
// the stack's base, which need not be a multiple of 4, so each strip row's
// 16-byte chunks are aligned on the stack's base and bounded by its end (a
// chunk may take floats of the next or the previous system into the
// buffer, which entry() never reads).  Solver warp w < cols owns column c0 + w and
// walks the chain: its lanes' rows start from b (y) less the partial sums
// the helpers left, then retire the previous strip's 32 x 32 block (the
// previous strip's values in registers, passed by __shfl_sync) and solve the
// strip's triangle by shuffles.  Meanwhile the helper warps (those past the
// solvers, or every warp where there are none) retire the next strip's terms
// against strips solved two or more before, read from a ring of the last
// cap solved values a column, each helper a slice of the band diagonals,
// into partial sums (double buffered by strip parity).  The band rows do
// not depend on x: strips enter a ring of R buffers by cp.async R - 1 steps
// ahead of the helpers, and a solver loads the next strip's near block and
// triangle into registers at the end of a step, so no band load sits on
// the chain.
template <int R>
__global__ void __launch_bounds__(kSolveMaxThreads)
band_solve_staged_kernel(const float* __restrict__ lu, const float* __restrict__ b, float* x, int n,
                         int bw, int m, int cols, int S, int stage_floats, int cap, int tiles, int batch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = 2 * bw + 1;
  const int sys = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - sys * tiles) * cols, ct = min(cols, m - c0);
  const bool solver = warp < ct;
  const int col = c0 + warp;
  const bool helper = nw > cols ? warp >= cols : true;
  const int nh = nw > cols ? nw - cols : nw, h = nw > cols ? warp - cols : warp;
  const int strips = (n + 31) / 32;
  float* stages = smem;
  float* ring = smem + (size_t)R * stage_floats;
  float* part = ring + (size_t)cols * cap;  // [2][nh][cols][32]
  const unsigned full = 0xffffffffu;
  const size_t base = (size_t)sys * n * W, end = (size_t)batch * n * W;  // in the stack's floats
  b += (size_t)sys * n * m;
  x += (size_t)sys * n * m;

  // stage strip k's half into buffer `buf` (nothing past the last strip);
  // one commit group either way
  auto stage = [&](int k, int buf, bool upper) {
    if (k >= 0 && k < strips) {
      float* dst = stages + (size_t)buf * stage_floats;
      const int rows = min(32, n - 32 * k), chunks = S / 4, len = upper ? bw + 1 : bw;
      for (int idx = tid; idx < rows * chunks; idx += nt) {
        const int rr = idx / chunks, cc = idx - rr * chunks;
        const size_t start = base + (size_t)(32 * k + rr) * W + (upper ? bw : 0);
        const size_t a = (start & ~(size_t)3) + 4 * (size_t)cc;
        if (a >= start + len) continue;
        cp_async16(dst + rr * S + 4 * (rr >> 3) + 4 * cc, lu + a, a + 4 <= end ? 16 : (int)(end - a) * 4);
      }
    }
    cp_async_commit();
  };
  // entry e of row rr's half in buffer `buf`
  auto entry = [&](int buf, int k, int rr, bool upper) -> const float* {
    const size_t start = base + (size_t)(32 * k + rr) * W + (upper ? bw : 0);
    return stages + (size_t)buf * stage_floats + rr * S + 4 * (rr >> 3) + (int)(start & 3);
  };

  float near_l[32], tri[32];
  float prev = 0.f, next_b = 0.f, inv_diag = 1.f;
  // the solver's registers for strip k (buffer buf): its lanes' rows' near
  // block (the previous strip's columns) and triangle, and the row's b or y
  auto preload = [&](int k, int buf, bool upper) {
    const int i = 32 * k + lane;
    const bool live = k >= 0 && k < strips && i < n;
    const float* row = live ? entry(buf, k, lane, upper) : nullptr;
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      if (!upper) {  // near: column 32k - 32 + s (t = bw - 32 + s - lane); triangle: 32k + s, s < lane
        const int tn = bw - 32 + s - lane, tt = bw + s - lane;
        near_l[s] = live && k > 0 && tn >= 0 ? row[tn] : 0.f;
        tri[s] = live && s < lane && tt >= 0 ? row[tt] : 0.f;
      } else {       // near: column 32k + 32 + s (u = 32 + s - lane); triangle: 32k + s, s > lane
        const int un = 32 + s - lane, ut = s - lane;
        near_l[s] = live && un <= bw && 32 * k + 32 + s < n ? row[un] : 0.f;
        tri[s] = live && s > lane && ut <= bw && 32 * k + s < n ? row[ut] : 0.f;
      }
    }
    if (upper) inv_diag = live ? __frcp_rn(row[0]) : 1.f;
  };
  // the row's b (forward) or y (backward: from x, which this kernel wrote,
  // so past the read-only path) for strip k, loaded a step ahead of use
  auto fetch = [&](int k, bool upper) {
    const int i = 32 * k + lane;
    if (k < 0 || k >= strips || i >= n) return 0.f;
    return upper ? __ldcg(x + (size_t)i * m + col) : b[(size_t)i * m + col];
  };

  for (int pass = 0; pass < 2; ++pass) {
    const bool upper = pass == 1;
    auto strip_of = [&](int q) { return upper ? strips - 1 - q : q; };
    for (int q = 0; q < R; ++q) stage(strip_of(q), q, upper);
    for (int idx = tid; idx < nh * cols * 32; idx += nt) part[idx] = 0.f;  // the first strip's: none
    cp_async_wait<R - 2>();
    __syncthreads();
    prev = 0.f;
    if (solver) {
      preload(strip_of(0), 0, upper);
      next_b = fetch(strip_of(0), upper);
    }
    __syncthreads();  // before step 0 stages a strip into buffer 0
    for (int q = 0; q < strips; ++q) {
      const int k = strip_of(q), r0 = 32 * k;
      float* pin = part + (size_t)(q & 1) * nh * cols * 32;
      float* pout = part + (size_t)((q + 1) & 1) * nh * cols * 32;
      if (solver) {
        const int i = r0 + lane;
        float acc = next_b;
        next_b = fetch(strip_of(q + 1), upper);  // in flight through the chain
        for (int hh = 0; hh < nh; ++hh) acc -= pin[(hh * cols + warp) * 32 + lane];
#pragma unroll
        for (int s = 0; s < 32; ++s) acc -= near_l[s] * __shfl_sync(full, prev, s);
        // the triangle in four sub-blocks of 8 rows: every lane solves a
        // sub-block itself (its values and triangle passed by __shfl_sync),
        // then the rows past it retire its terms; each row takes its terms
        // in the order of the one-row-at-a-time substitution
        if (!upper) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float y[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) y[e] = __shfl_sync(full, acc, 8 * t + e);
#pragma unroll
            for (int e = 0; e < 7; ++e)
#pragma unroll
              for (int f = e + 1; f < 8; ++f) y[f] -= __shfl_sync(full, tri[8 * t + e], 8 * t + f) * y[e];
            const int own = lane - 8 * t;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (own == e) acc = y[e];
              if (own >= 8) acc -= tri[8 * t + e] * y[e];
            }
          }
        } else {  // x_l = acc_l / U(l, l), by the reciprocal each lane holds: no division on the chain
#pragma unroll
          for (int t = 3; t >= 0; --t) {
            float y[8], xs[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) y[e] = __shfl_sync(full, acc, 8 * t + e);
#pragma unroll
            for (int f = 7; f >= 0; --f) {
              xs[f] = y[f] * __shfl_sync(full, inv_diag, 8 * t + f);
#pragma unroll
              for (int e = 0; e < f; ++e) y[e] -= __shfl_sync(full, tri[8 * t + f], 8 * t + e) * xs[f];
            }
            const int own = lane - 8 * t;
#pragma unroll
            for (int f = 7; f >= 0; --f) {
              if (own == f) acc = y[f];
              if (own < 0) acc -= tri[8 * t + f] * xs[f];
            }
          }
          acc *= inv_diag;
        }
        if (i < n) {
          ring[(size_t)warp * cap + i % cap] = acc;
          x[(size_t)i * m + col] = acc;
        }
        prev = i < n ? acc : 0.f;
      }
      // the strip R steps on enters the buffer of strip q, which its solver
      // holds in registers; after the solver's reads of b or y above
      stage(strip_of(q + R), q % R, upper);
      if (helper) {
        // the next strip's terms against the strips solved before this one
        const int kn = upper ? k - 1 : k + 1, i = 32 * kn + lane;
        float acc[kSolveCols];
#pragma unroll
        for (int c = 0; c < kSolveCols; ++c) acc[c] = 0.f;
        const int span = bw - 32, ts = span > 0 ? (span + nh - 1) / nh : 0;
        if (kn >= 0 && kn < strips && i < n && ts > 0) {
          const float* row = entry((q + 1) % R, kn, lane, upper);
          // forward: t in [max(0, bw - i), bw - 32 - lane) reads y_{i - bw + t};
          // backward: u in [64 - lane, min(bw, n - 1 - i)] reads x_{i + u}
          int lo, hi;
          if (!upper) {
            lo = max(h * ts, max(0, bw - i));
            hi = min((h + 1) * ts, bw - 32 - lane);
          } else {
            lo = max(33 + h * ts, 64 - lane);
            hi = min(33 + (h + 1) * ts, min(bw, n - 1 - i) + 1);
          }
          if (lo < hi) {
            int slot = (upper ? i + lo : i - bw + lo) % cap;
            int e = lo;
            for (; e + 4 <= hi; e += 4) {  // four diagonals, their loads together
              float l[4];
              int sl[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                l[u] = row[e + u];
                sl[u] = slot;
                slot = slot + 1 == cap ? 0 : slot + 1;
              }
#pragma unroll
              for (int c = 0; c < kSolveCols; ++c)
                if (c < ct) {
                  const float* rc = ring + (size_t)c * cap;
                  const float y0 = rc[sl[0]], y1 = rc[sl[1]], y2 = rc[sl[2]], y3 = rc[sl[3]];
                  acc[c] = fmaf(l[3], y3, fmaf(l[2], y2, fmaf(l[1], y1, fmaf(l[0], y0, acc[c]))));
                }
            }
            for (; e < hi; ++e) {
              const float l = row[e];
#pragma unroll
              for (int c = 0; c < kSolveCols; ++c)
                if (c < ct) acc[c] = fmaf(l, ring[(size_t)c * cap + slot], acc[c]);
              slot = slot + 1 == cap ? 0 : slot + 1;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kSolveCols; ++c)
          if (c < ct) pout[(h * cols + c) * 32 + lane] = acc[c];
      }
      cp_async_wait<R - 2>();
      if (solver) preload(strip_of(q + 1), (q + 1) % R, upper);
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

// out[s] = base[s] - A[s] @ X[s + shift]   (base == nullptr: out[s] = A[s] @ X[s + shift]);
// A is (S, M, K), X (S, K, m), out and base (S, M, m); X[s + shift] outside
// 0..S-1 is zero.  One 32x32 output tile of one block s per CUDA block, 256
// threads, 4 outputs each.  blockIdx.x = (s * row tiles + row tile) *
// column tiles + column tile, the order of a (column, row, s) grid, so any S
// fits the grid (a z extent would stop at 65,535).
__global__ void band_gemm_kernel(const float* __restrict__ A, const float* __restrict__ X,
                                 const float* __restrict__ base, float* __restrict__ out, int S,
                                 int M, int K, int m, int shift) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Xs[kTile][kTile + 1];
  const int tc = (m + kTile - 1) / kTile, tr = (M + kTile - 1) / kTile;
  const int sr = blockIdx.x / tc, s = sr / tr;  // sr = s * tr + row tile
  const int r0 = (sr - s * tr) * kTile, c0 = (blockIdx.x - sr * tc) * kTile;
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

// band_gemm_kernel's product for m <= 4 columns, where its 32-wide tiles
// would keep at most 4 of 32: one thread per row of A (all S * M rows over
// the grid), its row read in 16-byte pieces where `vec`, each sum over k
// ascending as band_gemm_kernel's, so the same values.
__global__ void __launch_bounds__(256) band_gemv_kernel(const float* __restrict__ A, const float* __restrict__ X,
                                                        const float* __restrict__ base, float* __restrict__ out,
                                                        int S, int M, int K, int m, int shift, int vec) {
  const size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;  // s * M + r
  if (row >= (size_t)S * M) return;
  const int xs = (int)(row / M) + shift;
  float acc[kGemvCols] = {0.f, 0.f, 0.f, 0.f};
  if (xs >= 0 && xs < S) {
    const float* a = A + row * K;
    const float* x = X + (size_t)xs * K * m;
    int k = 0;
    if (vec) {
#pragma unroll 4
      for (; k + 4 <= K; k += 4) {
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(a + k));
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c)
          if (c < m) {
            acc[c] += a4.x * __ldg(x + k * m + c);
            acc[c] += a4.y * __ldg(x + (k + 1) * m + c);
            acc[c] += a4.z * __ldg(x + (k + 2) * m + c);
            acc[c] += a4.w * __ldg(x + (k + 3) * m + c);
          }
      }
    }
    for (; k < K; ++k) {
      const float av = __ldg(a + k);
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c)
        if (c < m) acc[c] += av * __ldg(x + k * m + c);
    }
  }
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)
    if (c < m) {
      const size_t o = row * m + c;
      out[o] = base ? base[o] - acc[c] : acc[c];
    }
}

// out[s] = base[s] - A[s] @ X[s + shift] on the narrow kernel for m <= 4,
// else (or where `tiles`) on band_gemm_kernel's 32 x 32 tiles.
cudaError_t launch_product(const float* A, const float* X, const float* base, float* out, int S, int M, int K,
                           int m, int shift, bool tiles, cudaStream_t stream) {
  if (m <= kGemvCols && !tiles) {
    const long long rows = (long long)S * M;
    if ((rows + 255) / 256 > INT_MAX) return cudaErrorInvalidValue;
    const int vec = K % 4 == 0 && reinterpret_cast<size_t>(A) % 16 == 0;
    band_gemv_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(A, X, base, out, S, M, K, m, shift, vec);
    return cudaGetLastError();
  }
  const long long grid = (long long)((m + kTile - 1) / kTile) * ((M + kTile - 1) / kTile) * S;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  band_gemm_kernel<<<(unsigned)grid, 256, 0, stream>>>(A, X, base, out, S, M, K, m, shift);
  return cudaGetLastError();
}

// Y[i] = Z[i][roff .. roff+bw) - T_i @ Y[i -+ 1] over the S blocks, forward
// (reverse = 0: i = 0 .. S-1) or backward (reverse = 1: i = S-1 .. 0), with
// T_i = A[i][roff .. roff+bw) and the first state Y = Z rows.  A is
// (S, C, bw), Z (S, C, m), Y (S, bw, m).  One block per group of w <= 32
// columns: the group's bw * w outputs split over the threads, columns
// fastest (a warp's threads of one row share its loads of T), the previous
// state in shared memory (two (bw, w) buffers).  A thread reads its row of
// T in 16-byte pieces where `vec` and asks L2 for its next row ahead of
// the step; each sum runs over k ascending.
__global__ void band_tail_scan_kernel(const float* __restrict__ A, const float* __restrict__ Z,
                                      float* __restrict__ Y, int S, int C, int bw, int m,
                                      int roff, int reverse, int vec) {
  float* prev = smem;
  float* cur = smem + bw * kTile;
  const int c0 = blockIdx.x * kTile, w = min(kTile, m - c0);
  for (int q = 0; q < S; ++q) {
    const int i = reverse ? S - 1 - q : q;
    const int inext = reverse ? i - 1 : i + 1;
    for (int idx = threadIdx.x; idx < bw * w; idx += blockDim.x) {
      const int r = idx / w, c = idx % w;
      if (q + 1 < S && c == 0) {  // the next step's row of T, into L2
        const char* nt = reinterpret_cast<const char*>(A + ((size_t)inext * C + roff + r) * bw);
        for (int off = 0; off < bw * (int)sizeof(float); off += 128)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(nt + off));
      }
      float v = Z[((size_t)i * C + roff + r) * m + c0 + c];
      if (q) {
        const float* t = A + ((size_t)i * C + roff + r) * bw;
        const float* p = prev + c;
        int k = 0;
        if (vec) {  // chunks of 64: the chunk's 16 loads in flight before its sums
          for (; k + 64 <= bw; k += 64) {
            float4 t4[16];
#pragma unroll
            for (int j = 0; j < 16; ++j) t4[j] = __ldg(reinterpret_cast<const float4*>(t + k) + j);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int kk = k + 4 * j;
              v -= t4[j].x * p[kk * w];
              v -= t4[j].y * p[(kk + 1) * w];
              v -= t4[j].z * p[(kk + 2) * w];
              v -= t4[j].w * p[(kk + 3) * w];
            }
          }
          for (; k + 4 <= bw; k += 4) {
            const float4 t4 = __ldg(reinterpret_cast<const float4*>(t + k));
            v -= t4.x * p[k * w];
            v -= t4.y * p[(k + 1) * w];
            v -= t4.z * p[(k + 2) * w];
            v -= t4.w * p[(k + 3) * w];
          }
        }
        for (; k < bw; ++k) v -= t[k] * p[k * w];
      }
      Y[((size_t)i * bw + r) * m + c0 + c] = v;
      cur[r * w + c] = v;
    }
    __syncthreads();
    float* swap = prev;
    prev = cur;
    cur = swap;
  }
}

// The recurrence of band_tail_scan_kernel for bw <= 32: a block of two
// warps per group of KC columns (blockIdx.x; KC = 1 up to kScanGroups
// columns: the state's shuffles grow with KC and the groups run apart).  The producer warp stages step
// q's rows of T (the (bw, bw) tail, contiguous in A) and of Z into ring slot
// q % D with cp.async (16-byte pieces where `vec`), each lane's copies
// signalling the slot's `full` mbarrier as they land, up to D steps ahead;
// it refills a slot once the solver warp has arrived on its `empty` one.
// The solver warp waits on `full`, lane r < bw computes state row r from
// the slot and the previous state, which stays in registers and comes to
// the other lanes by __shfl_sync, writes it out and releases the slot: only
// shared-memory reads, shuffles and the sums sit on the chain.  T's rows lie
// ldt = bw rounded up to 4, plus 4, floats apart, so a lane's 16-byte reads
// of its row meet no bank conflict.
constexpr int kScanMaxStages = 32;
constexpr int kScanGroups = 512;  // column groups (blocks) past which a block takes more columns

__host__ __device__ inline int scan_ldt(int bw) { return (bw + 3) / 4 * 4 + 4; }

template <int KC>
__host__ __device__ size_t scan_slot_floats(int bw) {
  return ((size_t)bw * scan_ldt(bw) + (size_t)bw * KC + 3) / 4 * 4;
}

__device__ __forceinline__ unsigned bar_addr(const unsigned long long* b) {
  return static_cast<unsigned>(__cvta_generic_to_shared(b));
}
__device__ __forceinline__ void bar_init(unsigned long long* b, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(bar_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(unsigned long long* b) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}" ::"r"(bar_addr(b)) : "memory");
}
// the barrier's arrival once this thread's cp.async copies so far have landed
__device__ __forceinline__ void bar_arrive_copies(unsigned long long* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(bar_addr(b)) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done)
                 : "r"(bar_addr(b)), "r"(parity)
                 : "memory");
  } while (!done);
}

// KC columns a group, BW4 = ceil(bw / 4) (1 .. 8) known to the compiler, so
// a step's loads of T all start before its sums; a producer lane's copies
// are the same every step, so their offsets are computed once.
template <int KC, int BW4>
__global__ void __launch_bounds__(64) band_scan_warp_kernel(const float* __restrict__ A, const float* __restrict__ Z,
                                                            float* __restrict__ Y, int S, int C, int bw, int m,
                                                            int roff, int reverse, int vec, int D) {
  const int lane = threadIdx.x % 32, c0 = blockIdx.x * KC, ldt = scan_ldt(bw);
  const size_t slot = scan_slot_floats<KC>(bw);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + D * slot);
  unsigned long long* empty = full + D;
  if (threadIdx.x == 0)
    for (int d = 0; d < D; ++d) {
      bar_init(full + d, 32);  // every producer lane's copies
      bar_init(empty + d, 1);  // the solver warp, once it has read the slot
    }
  __syncthreads();
  if (threadIdx.x >= 32) {  // the producer warp
    constexpr int kChunks = (4 * BW4 * BW4 + 31) / 32;  // 16-byte pieces of T's tail a lane copies, at most
    constexpr int kZ = (4 * BW4 * KC + 31) / 32;        // values of Z a lane copies, at most
    int tsrc[kChunks], tdst[kChunks], zsrc[kZ], zbytes[kZ];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int per = bw / 4, ch = lane + 32 * j;
      tsrc[j] = vec && ch < bw * per ? 4 * ch : -1;
      tdst[j] = per ? ch / per * ldt + 4 * (ch % per) : 0;
    }
#pragma unroll
    for (int j = 0; j < kZ; ++j) {
      const int e = lane + 32 * j, c = c0 + e % KC;
      zsrc[j] = e < bw * KC ? e / KC * m + (c < m ? c : 0) : -1;
      zbytes[j] = c < m ? 4 : 0;
    }
    // step q's rows of T and Z, stepping a block of C rows a step
    const long long tstep = reverse ? -(long long)C * bw : (long long)C * bw;
    const long long zstep = reverse ? -(long long)C * m : (long long)C * m;
    const float* t = A + ((size_t)(reverse ? S - 1 : 0) * C + roff) * bw;
    const float* z = Z + ((size_t)(reverse ? S - 1 : 0) * C + roff) * m;
    for (int q = 0, d = 0, phase = 1; q < S; ++q, t += tstep, z += zstep) {
      if (q >= D) bar_wait(empty + d, phase);  // the solver is done with step q - D
      float* dt = smem + (size_t)d * slot;
      if (q && vec) {
#pragma unroll
        for (int j = 0; j < kChunks; ++j)
          if (tsrc[j] >= 0) cp_async16(dt + tdst[j], t + tsrc[j]);
      } else if (q) {
        for (int e = lane; e < bw * bw; e += 32) cp_async4(dt + e / bw * ldt + e % bw, t + e);
      }
      float* dz = dt + (size_t)bw * ldt;
#pragma unroll
      for (int j = 0; j < kZ; ++j)
        if (zsrc[j] >= 0) cp_async4(dz + lane + 32 * j, z + zsrc[j], zbytes[j]);
      bar_arrive_copies(full + d);
      if (++d == D) d = 0, phase ^= 1;
    }
    asm volatile("cp.async.wait_all;" ::: "memory");  // no copy outlives its warp
    return;
  }
  float prev[KC];  // this lane's row of the previous state (0 past bw)
#pragma unroll
  for (int c = 0; c < KC; ++c) prev[c] = 0.f;
  const long long ystep = reverse ? -(long long)bw * m : (long long)bw * m;
  float* y = Y + ((size_t)(reverse ? S - 1 : 0) * bw + (lane < bw ? lane : 0)) * m + c0;
  for (int q = 0, d = 0, phase = 0; q < S; ++q, y += ystep) {
    bar_wait(full + d, phase);
    const float* dt = smem + (size_t)d * slot;
    float v[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) v[c] = lane < bw ? dt[(size_t)bw * ldt + lane * KC + c] : 0.f;
    if (q) {
      const float* tr = dt + (lane < bw ? lane : 0) * ldt;
#pragma unroll
      for (int k4 = 0; k4 < BW4; ++k4) {  // k ascending, as band_tail_scan_kernel sums
        const int k = 4 * k4;
        float4 t4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k + 4 <= bw) {
          t4 = *reinterpret_cast<const float4*>(tr + k);
        } else {
          t4.x = tr[k];
          if (k + 1 < bw) t4.y = tr[k + 1];
          if (k + 2 < bw) t4.z = tr[k + 2];
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const float p0 = __shfl_sync(0xffffffffu, prev[c], k), p1 = __shfl_sync(0xffffffffu, prev[c], k + 1);
          const float p2 = __shfl_sync(0xffffffffu, prev[c], k + 2), p3 = __shfl_sync(0xffffffffu, prev[c], k + 3);
          v[c] -= t4.x * p0;
          if (k + 1 < bw) v[c] -= t4.y * p1;
          if (k + 2 < bw) v[c] -= t4.z * p2;
          if (k + 3 < bw) v[c] -= t4.w * p3;
        }
      }
    }
    __syncwarp();  // every lane has read the slot
    if (lane == 0) bar_arrive(empty + d);
    if (++d == D) d = 0, phase ^= 1;
    if (lane < bw)
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c0 + c < m) y[c] = v[c];
#pragma unroll
    for (int c = 0; c < KC; ++c) prev[c] = v[c];
  }
}

// The ring's depth: up to kScanMaxStages slots, no more than the steps.
template <int KC>
int scan_stages(int bw, int S) {
  const int per = (int)(scan_slot_floats<KC>(bw) * sizeof(float) + 2 * sizeof(unsigned long long));
  const int D = S < kScanMaxStages ? S : kScanMaxStages, cap = kSmemBytes / per;
  return D < cap ? D : cap;
}

template <int KC, int BW4>
cudaError_t launch_scan_warp_bw(const float* A, const float* Z, float* Y, int S, int C, int bw, int m, int roff,
                                int reverse, cudaStream_t stream) {
  const int D = scan_stages<KC>(bw, S);
  const size_t bytes = D * (scan_slot_floats<KC>(bw) * sizeof(float) + 2 * sizeof(unsigned long long));
  auto kernel = band_scan_warp_kernel<KC, BW4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const int vec = bw % 4 == 0 && reinterpret_cast<size_t>(A) % 16 == 0;
  kernel<<<(m + KC - 1) / KC, 64, bytes, stream>>>(A, Z, Y, S, C, bw, m, roff, reverse, vec, D);
  return cudaGetLastError();
}

template <int KC>
cudaError_t launch_scan_warp(const float* A, const float* Z, float* Y, int S, int C, int bw, int m, int roff,
                             int reverse, cudaStream_t stream) {
  switch ((bw + 3) / 4) {
    case 1: return launch_scan_warp_bw<KC, 1>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    case 2: return launch_scan_warp_bw<KC, 2>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    case 3: return launch_scan_warp_bw<KC, 3>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    case 4: return launch_scan_warp_bw<KC, 4>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    case 5: return launch_scan_warp_bw<KC, 5>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    case 6: return launch_scan_warp_bw<KC, 6>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    case 7: return launch_scan_warp_bw<KC, 7>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    default: return launch_scan_warp_bw<KC, 8>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
  }
}

// One sweep's tail recurrence: the warp kernel up to bw = 32, else, or
// where `block`, band_tail_scan_kernel.
cudaError_t launch_scan(const float* A, const float* Z, float* Y, int S, int C, int bw, int m, int roff, int reverse,
                        bool block, cudaStream_t stream) {
  if (bw <= 32 && !block) {  // a column a block while the blocks number at most kScanGroups
    if (m <= kScanGroups) return launch_scan_warp<1>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    if (m <= 2 * kScanGroups) return launch_scan_warp<2>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    if (m <= 4 * kScanGroups) return launch_scan_warp<4>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
    return launch_scan_warp<8>(A, Z, Y, S, C, bw, m, roff, reverse, stream);
  }
  const size_t bytes = 2 * (size_t)bw * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(band_tail_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const int vec = bw % 4 == 0 && reinterpret_cast<size_t>(A) % 16 == 0;
  band_tail_scan_kernel<<<(m + kTile - 1) / kTile, 256, bytes, stream>>>(A, Z, Y, S, C, bw, m, roff, reverse, vec);
  return cudaGetLastError();
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

cudaError_t launch_global(float* band, int batch, int n, int bw, int p0, int p1,
                          cudaStream_t stream, bool window = false) {
  auto kernel = window ? band_lu_global_kernel<true> : band_lu_global_kernel<false>;
  kernel<<<batch, factor_block(bw), 2 * bw * sizeof(float), stream>>>(band, n, bw, p0, p1);
  return cudaGetLastError();
}

// Factor `batch` row-aligned (n, 2bw+1) fp32 bands in place, in one launch
// of one block per band (the ring of band_lu_resident_kernel, or
// band_lu_global_kernel for wide bands; none for an empty stack or band);
// `window`: the scalar-sequential step of B18.  *path: 1 the ring walk, 2 the
// device-memory walk.
int band_lu_one_launch(float* band, int batch, int n, int bw, cudaStream_t stream, int* launches,
                       bool window, int* path) {
  *launches = 0;
  cudaError_t err;
  int R = n, C = n;  // the whole band fits: one chunk
  if (ring_bytes(n, bw) > (size_t)kSmemBytes) {
    const long long room = kSmemBytes - 2LL * bw * (long long)sizeof(float);
    R = room > 0 ? (int)(room / ((2LL * bw + 1) * (long long)sizeof(float))) : 0;
    C = R - bw;  // pivots per chunk: rows p .. p+bw of each must be in the ring
  }
  *path = C < 1 ? 2 : 1;
  if (batch < 1 || n < 1) return 0;  // nothing to factor
  if (C < 1) {
    if ((err = launch_global(band, batch, n, bw, 0, n, stream, window))) return err;
    ++*launches;
    return 0;
  }
  const size_t bytes = ring_bytes(R, bw);
  auto kernel = window ? band_lu_resident_kernel<true> : band_lu_resident_kernel<false>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)))
    return err;
  kernel<<<batch, factor_block(bw), bytes, stream>>>(band, n, bw, R, C);
  if ((err = cudaGetLastError())) return err;
  ++*launches;
  return 0;
}

// x (batch, n, m) = (LU)^-1 b on the packed bands (batch, n, 2bw+1);
// `cols` RHS columns (one warp each, at most 32) per block, a block per
// (system, tile) on the grid's x axis.
int band_solve_launch(const void* lu, const void* b, void* x, int batch, int n, int bw, int m,
                      int cols, cudaStream_t stream, int* launches) {
  *launches = 0;
  // a ring of the last min(bw, n) + 32 solved values per warp, fewer warps
  // per block where the rings would not fit, none where one does not
  int cap = (bw < n ? bw : n) + 32;
  const int fit = kSmemBytes / (cap * (int)sizeof(float));
  if (fit < 1) cap = 0;
  else if (cols > fit) cols = fit;
  const size_t bytes = (size_t)cols * cap * sizeof(float);
  const int tiles = (m + cols - 1) / cols;
  if ((long long)batch * tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(band_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)))
    return err;
  band_solve_kernel<<<batch * tiles, 32 * cols, bytes, stream>>>(
      static_cast<const float*>(lu), static_cast<const float*>(b), static_cast<float*>(x), n, bw,
      m, cap, tiles);
  if ((err = cudaGetLastError())) return err;
  ++*launches;
  return 0;
}

// The warp walk for bw <= 31 (path 0), else band_lu_one_launch's ring
// (path 1) or device-memory walk (path 2), over `batch` bands; one launch,
// none for an empty stack or band.
int band_lu_walk(float* band, int batch, int n, int bw, bool window, int* path,
                 cudaStream_t stream, int* launches) {
  *launches = 0;
  *path = 0;
  if (bw <= kWarpWalkMaxBw) {
    const cudaError_t err = band_lu_warp_walk(band, batch, n, bw, window, stream);
    if (!err && n > 0 && batch > 0) *launches = 1;
    return err;
  }
  return band_lu_one_launch(band, batch, n, bw, stream, launches, window, path);
}

}  // namespace

// Factor the row-aligned (n, 2bw+1) fp32 band in place, in one launch: the
// warp walk of band_walk.cu for bw <= 31 (none for an empty band), else the
// ring of band_lu_resident_kernel, or band_lu_global_kernel for bands too
// wide for it.  *path: 0 the warp walk, 1 the ring walk, 2 the
// device-memory walk.  Stores in *launches how many kernels it launched;
// returns the first error.
extern "C" int ebv_band_lu_resident(void* band_ptr, int n, int bw, int* path, void* stream_ptr,
                                    int* launches) {
  return band_lu_walk(static_cast<float*>(band_ptr), 1, n, bw, false, path,
                      static_cast<cudaStream_t>(stream_ptr), launches);
}

// Factor the row-aligned (n, 2bw+1) fp32 band in place with the
// scalar-sequential step of the legacy kernel (B18), in one launch (none for
// an empty band), on the walk *path names as for ebv_band_lu_resident.
extern "C" int ebv_band_lu_scalar(void* band_ptr, int n, int bw, int* path, void* stream_ptr,
                                  int* launches) {
  return band_lu_walk(static_cast<float*>(band_ptr), 1, n, bw, true, path,
                      static_cast<cudaStream_t>(stream_ptr), launches);
}

// Factor `batch` bands (batch, n, 2bw+1) in place in one launch (none for an
// empty stack or band): one warp a band up to bw = 31, else one block a band;
// *path as for ebv_band_lu_resident.
extern "C" int ebv_batched_band_lu(void* band_ptr, int batch, int n, int bw, int* path,
                                   void* stream_ptr, int* launches) {
  return band_lu_walk(static_cast<float*>(band_ptr), batch, n, bw, false, path,
                      static_cast<cudaStream_t>(stream_ptr), launches);
}

// Factor the band in place: on path 0 in S = ceil(n/C) launches, one per
// block step of C pivots, in stream order, each staging its slab in one
// block's shared memory; on path 1 in one launch of the cluster walk with K
// CTAs and groups of G = 8, 16 or 32 pivots; on path 2 (bands no cluster
// holds) in one launch of band_lu_global_kernel, B5's walk on the band in
// device memory (kernels/banded.py:tiled_plan picks the path, K and G).
// plan[0..5]: the path, K, G, the ring's rows a CTA, the shared memory
// bytes a CTA and how many such clusters the card holds at once.  A slab,
// K or G whose shared memory no block holds returns cudaErrorInvalidValue;
// a cluster the card cannot hold, cudaErrorLaunchOutOfResources.
extern "C" int ebv_band_lu_steps(void* band_ptr, int n, int bw, int path, int C, int K, int G,
                                 int* plan, void* stream_ptr, int* launches) {
  float* band = static_cast<float*>(band_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  for (int i = 0; i < 6; ++i) plan[i] = 0;
  if (n == 0) return 0;
  cudaError_t err;
  plan[0] = path;
  if (path == 2) {
    plan[4] = static_cast<int>(2 * bw * sizeof(float));
    if ((err = launch_global(band, 1, n, bw, 0, n, stream))) return err;
    ++*launches;
    return 0;
  }
  if (path == 1) {
    const BandCluster c = band_cluster_layout(bw, K, G);
    plan[1] = c.K;
    plan[2] = c.G;
    plan[3] = c.RK;
    plan[4] = static_cast<int>(c.bytes);
    const bool built = G == 8 || G == 16 || G == 32;
    if (K < 1 || !built || G > bw || G + bw > kClusterThreads || c.bytes > (size_t)kSmemBytes)
      return cudaErrorInvalidValue;
    auto kernel = G == 8 ? band_lu_cluster_kernel<8>
                : G == 16 ? band_lu_cluster_kernel<16> : band_lu_cluster_kernel<32>;
    if ((err = launch_cluster_kernel(kernel, c.K, c.K, kClusterThreads, c.bytes, stream, &plan[5], band,
                                     n, bw, c.RK, c.ldu, c.up_at, c.pc_at, c.ml_at)))
      return err;
    ++*launches;
    return 0;
  }
  const size_t bytes = ring_bytes(C + bw, bw);
  if (path != 0 || C < 1 || bytes > (size_t)kSmemBytes) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(band_lu_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)))
    return err;
  for (int k0 = 0; k0 < n; k0 += C) {
    band_lu_slab_kernel<<<1, factor_block(bw), bytes, stream>>>(band, n, bw, k0, C);
    if ((err = cudaGetLastError())) return err;
    ++*launches;
  }
  return 0;
}

// x (batch, n, m) = (LU)^-1 b per system on the packed bands (batch, n,
// 2bw+1), in one launch of the plan kernels/banded.py:band_solve_plan picks
// for one system (B7: batch = 1; B12: the stack): path 1
// band_solve_staged_kernel, a block of `warps` warps per (system, tile of
// `cols` RHS columns: at most 8 and at most `warps`) with `stages` (2-4)
// staged strips; path 0 band_solve_kernel, `cols` columns (one warp each,
// at most 32) a block.  Every system runs the same plan, so its x is
// bitwise the unbatched solve's on it alone.  plan[0..4]: the path, warps,
// columns a block, stages and shared-memory bytes a block.  A plan whose
// shared memory no block holds, or a grid of more than 2^31 - 1 blocks,
// returns cudaErrorInvalidValue; the stack must start on a 16-byte boundary.
extern "C" int ebv_band_solve(const void* lu, const void* b, void* x, int batch, int n, int bw, int m,
                              int path, int warps, int cols, int stages, int strip, int* plan,
                              void* stream_ptr, int* launches) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  for (int i = 0; i < 5; ++i) plan[i] = 0;
  cudaError_t err;
  if (path == 0) {
    plan[2] = cols;
    if ((err = static_cast<cudaError_t>(band_solve_launch(lu, b, x, batch, n, bw, m, cols, stream, launches))))
      return err;
    return nonfinite::launch_solve_fill(static_cast<float*>(x), batch, n, m, strip, stream, launches);
  }
  const SolveLayout l = solve_layout(bw, cols, warps, stages);
  plan[0] = 1;
  plan[1] = warps;
  plan[2] = cols;
  plan[3] = stages;
  plan[4] = l.bytes;
  if (path != 1 || cols < 1 || cols > kSolveCols || warps < cols || 32 * warps > kSolveMaxThreads ||
      stages < 2 || stages > 4 || l.bytes > kSmemBytes || reinterpret_cast<size_t>(lu) % 16)
    return cudaErrorInvalidValue;
  const int tiles = (m + cols - 1) / cols;
  if ((long long)batch * tiles > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = stages == 2 ? band_solve_staged_kernel<2>
              : stages == 3 ? band_solve_staged_kernel<3> : band_solve_staged_kernel<4>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes)))
    return err;
  kernel<<<batch * tiles, 32 * warps, l.bytes, stream>>>(
      static_cast<const float*>(lu), static_cast<const float*>(b), static_cast<float*>(x), n, bw, m,
      cols, l.S, l.stage, l.cap, tiles, batch);
  if ((err = cudaGetLastError())) return err;
  ++*launches;
  // the NaN the plain version's masked strips of `strip` rows spread
  // (nonfinite.cuh), one more launch
  return nonfinite::launch_solve_fill(static_cast<float*>(x), batch, n, m, strip, stream, launches);
}

// out (S, C, m) = the inverted-diagonal band solve of xb (S, C, m) from
// linv/uinv (S, C, C) and tlo/tup (S, C, bw).  z and y are (S, C, m) and
// t (S, bw, m) scratch the caller allocates.  path 0: band_gemv_kernel for
// m <= 4 and the warp scan up to bw = 32; path 1 (the tests' reference):
// the products on band_gemm_kernel's tiles at any m and the recurrences on
// band_tail_scan_kernel at any bw; the same values either way.
extern "C" int ebv_band_solve_inverted(const void* linv, const void* uinv, const void* tlo,
                                       const void* tup, const void* xb, void* out, void* z,
                                       void* y, void* t, int S, int C, int bw, int m,
                                       int path, void* stream_ptr, int* launches) {
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
  // each product's grid on one axis, at most 2^31 - 1 blocks (launch_product)
  cudaError_t err;
  if (path < 0 || path > 1) return cudaErrorInvalidValue;
  const bool tiles = path == 1;
  if (S == 1) {  // one block: no coupling
    if ((err = launch_product(Li, static_cast<const float*>(xb), nullptr, Z, S, C, C, m, 0, tiles, stream))) return err;
    ++*launches;
    if ((err = launch_product(Ui, Z, nullptr, O, S, C, C, m, 0, tiles, stream))) return err;
    ++*launches;
    return 0;
  }
  // forward: z = linv @ xb; tails; y = z - tlo @ ytail[i-1]
  if ((err = launch_product(Li, static_cast<const float*>(xb), nullptr, Z, S, C, C, m, 0, tiles, stream))) return err;
  ++*launches;
  if ((err = launch_scan(Tl, Z, T, S, C, bw, m, C - bw, 0, tiles, stream))) return err;
  ++*launches;
  if ((err = launch_product(Tl, T, Z, Y, S, C, bw, m, -1, tiles, stream))) return err;
  ++*launches;
  // backward: w = uinv @ y (into z); heads; x = w - tup @ xhead[i+1]
  if ((err = launch_product(Ui, Y, nullptr, Z, S, C, C, m, 0, tiles, stream))) return err;
  ++*launches;
  if ((err = launch_scan(Tu, Z, T, S, C, bw, m, 0, 1, tiles, stream))) return err;
  ++*launches;
  if ((err = launch_product(Tu, T, Z, O, S, C, bw, m, 1, tiles, stream))) return err;
  ++*launches;
  return 0;
}
