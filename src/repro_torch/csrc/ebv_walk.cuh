// The unblocked EbV walk shared by the legacy factor and panel
// (legacy_lu.cu: lu_vmem, panel) and the batched factor's cluster kernel
// (batched_lu.cu): the n-1 (or b) rank-1 steps of the reference's _lu_body
// (src/repro/kernels/ebv_lu.py) spread over P participants, the blocks of
// one grid or the CTAs of one thread-block cluster.
//
// Ownership.  Rows are owned for the whole walk by the paper's equalized
// pairing (core/ebv.py:equalized_pairing) over the m-1 updatable rows: unit
// u (0 <= u < m/2) pairs row u+1, live u+1 steps, with row m-1-u, live
// m-1-u steps, so every unit carries the same m row-steps.  Participant c
// owns units c, c+P, c+2P, ...; its rows, taken in decreasing order (the
// high rows, then the low ones), are live as a prefix of that list.  Row 0
// is never updated and has no owner.
//
// Residency.  Rows stay in the participant's shared memory from step to
// step.  Where all of them do not fit, rows above a threshold theta keep
// their columns [theta, ncols) there and everything else lives in the
// matrix in device memory (streamed through L2): a row's live columns at
// step k are (k, ncols) for every row, so the rightmost columns live
// longest, and rows with a high index live longest.  theta is the least
// column at which every participant's resident rows fit (walk_plan); the
// plain rule of spending the room on those rows and columns is the static
// split that streams least.  A bf16 matrix is held as bf16: its values are
// rounded to bf16 already, so either form is exact.
//
// A step k: the pivot row is staged in shared memory (fp32, one round trip
// for every load of the step), each live row's multiplier l = a[r][k] /
// a[k][k] is computed once (kept kLag steps) and stored into column k, then
// every live row takes a[r][j] - l * u[j] over the columns j > k, with IEEE
// divide, multiply and subtract and no contraction into fused multiply-adds,
// rounded to T after each operation (the plain versions' order).  The row
// k+1 is updated first by its owner, which hands it over; the kernels differ
// only in how a pivot row is handed over and read.  Bound, as measured on an
// H100: the resident update by shared memory's bandwidth (two accesses an
// element), the chain by the pivot row's round trip and the handoff (the
// flag or the cluster barrier), not by the 2n^3/3 operations.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "elem.cuh"

namespace {

constexpr int kWalkThreads = 512;   // one block (CTA) per SM
constexpr int kWalkSmem = 232448;   // dynamic shared memory one H100 block may use
constexpr int kLag = 8;             // steps a streamed element's updates are applied together
constexpr int kKeep = 8;            // columns of the next-but-one pivot row a thread keeps in registers

// The rows of participant c of P over an m-row matrix, in decreasing order:
// row(t) for t < count().  J units, Jl low rows (J less the middle
// singleton u+1 == m-1-u of an even m, counted once as a high row).
struct Owned {
  int c, P, m, J, Jl;
  __host__ __device__ Owned(int c_, int P_, int m_) : c(c_), P(P_), m(m_) {
    const int units = m / 2;
    J = c < units ? (units - c + P - 1) / P : 0;
    const bool singleton = (m % 2 == 0) && J > 0 && c + (J - 1) * P == units - 1;
    Jl = J - (singleton ? 1 : 0);
  }
  __host__ __device__ int count() const { return J + Jl; }
  __host__ __device__ int row(int t) const {
    return t < J ? m - 1 - (c + t * P) : c + (Jl - 1 - (t - J)) * P + 1;
  }
  // how many of the rows are above theta: a prefix of the list
  __host__ __device__ int above(int theta) const {
    const int xh = m - 1 - c - theta;  // high rows m-1-c-tP > theta
    int nh = xh > 0 ? (xh + P - 1) / P : 0;
    if (nh > J) nh = J;
    const int xl = theta - 1 - c;       // low rows c+qP+1 <= theta
    int low_below = xl >= 0 ? xl / P + 1 : 0;
    if (low_below > Jl) low_below = Jl;
    return nh + Jl - low_below;
  }
};

// the participant owning row i >= 1 and its place in that participant's list
__host__ __device__ inline void row_owner(int i, int P, int m, int* c, int* t) {
  const int units = m / 2;
  if (i >= m - units) {  // a high row (the singleton of an even m among them)
    const int u = m - 1 - i;
    *c = u % P;
    *t = u / P;
  } else {
    const int u = i - 1;
    *c = u % P;
    const Owned o(*c, P, m);
    *t = o.J + o.Jl - 1 - u / P;
  }
}

// The shared-memory plan of a walk over P participants: the pivot row and
// the last kLag steps' multipliers (fp32), then the resident rows (T, ldr =
// ncols - theta each).
struct WalkPlan {
  int theta;
  size_t lbuf_at, rows_at, bytes;
};

inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

inline int resident_max(int m, int P, int theta) {
  int most = 0;
  for (int c = 0; c < P; ++c) {
    const int r = Owned(c, P, m).above(theta);
    most = r > most ? r : most;
  }
  return most;
}

// The least theta at which every participant's rows above it, holding
// columns [theta, ncols), fit beside the pivot row and the multipliers;
// bytes == 0 if not even those fit.
inline WalkPlan walk_plan(int m, int ncols, int P, int elem) {
  WalkPlan p{};
  const int rows_max = 2 * ((m / 2 + P - 1) / P);  // a participant's rows, at most
  p.lbuf_at = (size_t)ncols * sizeof(float);
  p.rows_at = align16(p.lbuf_at + (size_t)kLag * rows_max * sizeof(float));
  if (p.rows_at > (size_t)kWalkSmem) return p;
  auto bytes = [&](int theta) {
    return p.rows_at + (size_t)resident_max(m, P, theta) * (ncols - theta) * elem;
  };
  int lo = 0, hi = ncols;  // bytes(hi) fits; find the least theta that does
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (bytes(mid) <= (size_t)kWalkSmem) hi = mid;
    else lo = mid + 1;
  }
  p.theta = lo;
  p.bytes = bytes(lo);
  return p;
}

// One participant's view of the walk: its rows, where each lives, and the
// recent steps' pivot row and multipliers.
//
// A streamed element's updates are applied kLag steps at a time, in step
// order (sweep), so the stream moves each element once per kLag steps
// instead of once a step.  An element is brought up to date earlier where a
// step needs it: the column k entries of the live rows before their
// multipliers (caught_up), and the row k+2 by its owner a step ahead (keep),
// so that handing it over as the row k+1 waits on nothing more.
// The pivot rows of the pending steps are read back from the matrix, where
// their streamed columns are current.  Every element still takes the same
// operations in the same order.
template <typename T>
struct Walk {
  T* a;  // the (m, ncols) row-major matrix in device memory
  int ncols, theta, nres, ldr, rows_max;
  Owned own;
  float* prow;   // prow[j] = pivot row's column j, for j >= k
  float* lhist;  // the multipliers of step s at lhist + (s % kLag) * rows_max, by slot
  T* rs;         // slot t < nres: columns [theta, ncols) at rs + t * ldr

  __device__ Walk(T* a_, int ncols_, const Owned& o, int theta_, char* smem, size_t lbuf_at,
                  size_t rows_at)
      : a(a_), ncols(ncols_), theta(theta_), nres(o.above(theta_)), ldr(ncols_ - theta_),
        rows_max(2 * ((o.m / 2 + o.P - 1) / o.P)), own(o), prow(reinterpret_cast<float*>(smem)),
        lhist(reinterpret_cast<float*>(smem + lbuf_at)), rs(reinterpret_cast<T*>(smem + rows_at)) {}

  __device__ T* at(int t, int j) const { return a + (size_t)own.row(t) * ncols + j; }
  __device__ bool resident(int t, int j) const { return t < nres && j >= theta; }
  __device__ float* lbuf(int s) const { return lhist + (s % kLag) * rows_max; }
  __device__ void put(int t, int j, float v) const {
    if (resident(t, j)) store(rs + (size_t)t * ldr + j - theta, v);
    else store_l2(at(t, j), v);
  }

  // v less l_s * u_s for the steps s in [w0, w0 + n) of slot t: u[s - w0] = pivot row s's entry
  __device__ float apply(float v, int t, int w0, int n, const float* u) const {
#pragma unroll
    for (int s = 0; s < kLag; ++s)
      if (s < n) v = rnd<T>(__fsub_rn(v, rnd<T>(__fmul_rn(lbuf(w0 + s)[t], u[s]))));
    return v;
  }

  // the pivot rows [w0, w0 + n) at column j, from the matrix
  __device__ void pivots(int j, int w0, int n, float* u) const {
#pragma unroll
    for (int s = 0; s < kLag; ++s) u[s] = s < n ? load_l2(a + (size_t)(w0 + s) * ncols + j) : 0.f;
  }

  // the streamed element (t, j) with the pending steps [w0, k) applied
  __device__ float caught_up(int t, int j, int w0, int k) const {
    float u[kLag];
    pivots(j, w0, k - w0, u);
    return apply(load_l2(at(t, j)), t, w0, k - w0, u);
  }

  // Slot t's streamed columns from j0 (a resident row's below theta): the
  // steps [from, upto) applied, then step `upto` itself when `step` (its
  // pivot row in prow); into the matrix.
  __device__ void advance(int t, int j0, int from, int upto, bool step) const {
    const int end = t < nres ? theta : ncols;
    const float l = step ? lbuf(upto)[t] : 0.f;
    T* g = at(t, 0);
    constexpr int kDeep = 4;  // columns a thread carries at once
    for (int j = j0 + threadIdx.x; j < end; j += kDeep * blockDim.x) {
      float v[kDeep];
#pragma unroll
      for (int q = 0; q < kDeep; ++q) {
        const int jq = j + q * blockDim.x;
        v[q] = jq < end ? caught_up(t, jq, from, upto) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kDeep; ++q) {
        const int jq = j + q * blockDim.x;
        if (jq < end) store_l2(g + jq, step ? rnd<T>(__fsub_rn(v[q], rnd<T>(__fmul_rn(l, prow[jq])))) : v[q]);
      }
    }
  }

  // After step k: the row k+2, where this participant owns it, brought up
  // to date through step k off the next handoff's path (the row k+1 is slot
  // `next`, or not ours), its streamed columns from k+1 also kept in `kv`:
  // column k+1 + threadIdx.x + q * blockDim.x in kv[q] (where the row's
  // streamed part fits kKeep a thread).  Returns its slot (its pending steps
  // start at k+1 from here), or -1.
  __device__ int keep(int k, int w0, int live, int next, float* kv) const {
    const int s = next >= 0 ? next - 1 : live - 1;
    if (s < 0 || own.row(s) != k + 2) return -1;
    const int end = s < nres ? theta : ncols, j0 = k + 1;
    if (end - j0 > kKeep * (int)blockDim.x) {  // too wide for the registers
      if (w0 <= k) advance(s, j0, w0, k + 1, false);
      return s;
    }
    T* g = at(s, 0);
    if (w0 > k) __syncthreads();  // a sweep just brought it up to date: its stores first
#pragma unroll
    for (int q = 0; q < kKeep; ++q) {
      const int j = j0 + threadIdx.x + q * blockDim.x;
      kv[q] = j < end ? caught_up(s, j, w0 <= k ? w0 : k + 1, k + 1) : 0.f;
    }
    if (w0 <= k)
#pragma unroll
      for (int q = 0; q < kKeep; ++q) {
        const int j = j0 + threadIdx.x + q * blockDim.x;
        if (j < end) store_l2(g + j, kv[q]);
      }
    return s;
  }

  // the resident rows' columns [theta, ncols) from the matrix
  __device__ void load_rows() const {
    for (int t = 0; t < nres; ++t)
      for (int j = theta + threadIdx.x; j < ncols; j += blockDim.x)
        store(rs + (size_t)t * ldr + j - theta, load_l2(at(t, j)));
  }

  // the resident rows' columns [theta, min(row or ncols, ncols)) back to the matrix
  __device__ void write_back(bool below_diagonal_only) const {
    for (int t = 0; t < nres; ++t) {
      const int end = below_diagonal_only && own.row(t) < ncols ? own.row(t) : ncols;
      for (int j = theta + threadIdx.x; j < end; j += blockDim.x)
        store_l2(at(t, j), load(rs + (size_t)t * ldr + j - theta));
    }
  }

  // Step k's pivot row into prow (src(j) reads column j of it) and the
  // multipliers of the live slots [0, live) into step k's multipliers and
  // column k.  A slot's inputs and the thread's pivot-row columns are all
  // loaded before the first store, so the step waits on one round trip.
  template <class Src>
  __device__ void stage(int k, int w0, int live, int kept, Src src) const {
    const int t = threadIdx.x;
    const bool mine = t < live, behind = mine && !resident(t, k);
    const int from = t == kept ? k : w0;  // the kept row is up to date already
    float x = 0.f, piv = 1.f, u[kLag];
    if (mine) {
      piv = src(k);
      x = behind ? load_l2(at(t, k)) : load(rs + (size_t)t * ldr + k - theta);
    }
    if (behind) pivots(k, from, k - from, u);  // its pending steps, applied once the pivot row is in flight
    constexpr int kStage = 8;  // pivot-row columns a thread carries at once
    for (int j = k + t; j < ncols; j += kStage * blockDim.x) {
      float v[kStage];
#pragma unroll
      for (int q = 0; q < kStage; ++q) {
        const int jq = j + q * blockDim.x;
        v[q] = jq < ncols ? src(jq) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kStage; ++q) {
        const int jq = j + q * blockDim.x;
        if (jq < ncols) prow[jq] = v[q];
      }
    }
    if (behind) x = apply(x, t, from, k - from, u);
    if (mine) multiplier(t, k, x, piv);
    for (int r = t + blockDim.x; r < live; r += blockDim.x)  // more slots than threads
      multiplier(r, k, resident(r, k) ? load(rs + (size_t)r * ldr + k - theta)
                                      : caught_up(r, k, r == kept ? k : w0, k), piv);
  }

  // slot t's multiplier x / piv at step k: into step k's multipliers and column k
  __device__ void multiplier(int t, int k, float x, float piv) const {
    const float l = rnd<T>(__fdiv_rn(x, piv));
    lbuf(k)[t] = l;
    put(t, k, l);
  }

  // the slots [s0, s1) but `skip`, as a list: entry i is slot s0 + i, past `skip` one more
  __device__ static int listed(int s0, int s1, int skip) {
    return s1 - s0 - (skip >= s0 && skip < s1 ? 1 : 0);
  }
  __device__ static int entry(int s0, int i, int skip) { return s0 + i + (skip >= s0 && s0 + i >= skip ? 1 : 0); }

  // Step k's update of the row k+1 (slot `next`, its pending steps from
  // `from`), ahead of the others: its streamed columns (k, ncols) caught up
  // and stepped, into the matrix (from `kv` where keep left them there at
  // step k-1); its resident columns stepped, in place or, with `publish`,
  // into the matrix (the row retires after this step; its next reader reads
  // the matrix).
  __device__ void ahead(int k, int next, int from, bool publish, bool kept, const float* kv) const {
    const float l = lbuf(k)[next];
    const float* u = prow;
    const int end = next < nres ? theta : ncols;
    T* g = at(next, 0);
    if (kept && end - k <= kKeep * (int)blockDim.x) {
#pragma unroll
      for (int q = 0; q < kKeep; ++q) {
        const int j = k + threadIdx.x + q * blockDim.x;  // keep's columns, from k
        if (j > k && j < end) store_l2(g + j, rnd<T>(__fsub_rn(kv[q], rnd<T>(__fmul_rn(l, u[j])))));
      }
    } else {
      advance(next, k + 1, from, k, true);
    }
    if (next >= nres) return;
    T* s = rs + (size_t)next * ldr - theta;
    for (int j = (k + 1 > theta ? k + 1 : theta) + threadIdx.x; j < ncols; j += blockDim.x) {
      const float w = rnd<T>(__fsub_rn(load(s + j), rnd<T>(__fmul_rn(l, u[j]))));
      if (publish) store_l2(g + j, w);
      else store(s + j, w);
    }
  }

  // Step k's rank-1 update of the resident columns (k, ncols) of the live
  // slots [0, live) but `skip`.  Lanes of up to 128 threads (a power of two
  // up to the live columns) take Q columns each per pass, their pivot
  // entries in registers; the rest of the block splits the rows into
  // groups.  Q columns a row per pass (up to 8) keep the loop's own
  // instructions few beside the element updates.
  __device__ void update(int k, int live, int skip) const {
    const int jr = k + 1 > theta ? k + 1 : theta, tr = live < nres ? live : nres;
    if (jr >= ncols || tr <= 0) return;
    const int width = ncols - jr;
    const int shift = width >= 128 ? 7 : width <= 32 ? 5 : 31 - __clz(width);
    const int per = (width + (1 << shift) - 1) >> shift;  // columns a lane takes
    if (per > 4) update_q<8>(jr, tr, skip, shift, k);
    else if (per > 2) update_q<4>(jr, tr, skip, shift, k);
    else if (per > 1) update_q<2>(jr, tr, skip, shift, k);
    else update_q<1>(jr, tr, skip, shift, k);
  }

  template <int Q>
  __device__ void update_q(int jr, int tr, int skip, int shift, int k) const {
    const int lanes = 1 << shift, groups = blockDim.x >> shift;
    const int x = threadIdx.x & (lanes - 1), y = threadIdx.x >> shift;
    const float* l = lbuf(k);
    const int cnt = listed(0, tr, skip);
    for (int j = jr - theta + x; j < ncols - theta; j += Q * lanes) {  // a pass of Q columns a lane
      float u[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = j + q * lanes;
        u[q] = c < ncols - theta ? prow[theta + c] : 0.f;
      }
      for (int i = y; i < cnt; i += groups) {
        const int t = entry(0, i, skip);
        const float lt = l[t];
        T* row = rs + (size_t)t * ldr + j;
        float v[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = j + q * lanes < ncols - theta ? load(row + q * lanes) : 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (j + q * lanes < ncols - theta)
            store(row + q * lanes, rnd<T>(__fsub_rn(v[q], rnd<T>(__fmul_rn(lt, u[q])))));
      }
    }
  }

  // The pending steps [w0, k] of the streamed columns (k, ncols) of the live
  // slots [0, live) but `skip` (the row k+1, already current): a resident
  // row's columns below theta, all of a streamed row's.  Lanes of 128
  // threads over the columns, each holding the steps' pivot entries of its
  // column; the rest row groups, eight rows in flight.
  __device__ void sweep(int k, int w0, int live, int skip) const {
    const int j0 = k + 1, n = k + 1 - w0;
    if (j0 >= ncols || (live <= nres && j0 >= theta)) return;
    constexpr int kLanes = 128, kRows = 8;
    const int groups = blockDim.x / kLanes, x = threadIdx.x % kLanes, y = threadIdx.x / kLanes;
    for (int j = j0 + x; j < ncols; j += kLanes) {
      const int r0 = j < theta ? 0 : nres, cnt = listed(r0, live, skip);
      if (cnt <= 0) continue;
      float u[kLag];
      pivots(j, w0, n, u);
      for (int i = y; i < cnt; i += kRows * groups) {
        float v[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int iq = i + q * groups;
          v[q] = iq < cnt ? load_l2(at(entry(r0, iq, skip), j)) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int iq = i + q * groups;
          if (iq < cnt) {
            const int t = entry(r0, iq, skip);
            store_l2(at(t, j), apply(v[q], t, w0, n, u));
          }
        }
      }
    }
  }
};

}  // namespace
