// The legacy dense EbV kernels for Hopper (sm_90a): the paper-faithful
// unblocked factor, the tall-panel factor, the fused bi-vector step and the
// rank-k trailing update.  Each is templated on its element type, fp32 or
// bf16; in bf16 every operation is computed in fp32 and rounded to bf16 at
// once, as PyTorch's elementwise bf16 ops round, and products accumulate in
// fp32.
//
// ebv_walk_kernel — replaces src/repro/kernels/ebv_lu.py:lu_vmem (n-1 steps
//   on the whole (n, n) matrix) and :panel (b steps on a tall (m, b) panel,
//   pivots in the top b rows).  Both run the step body _lu_body of that file
//   (csrc/ebv_walk.cuh has the walk, its row ownership and its residency).
//   The TPU kernel holds the whole matrix in VMEM (64 MB at n = 4096).
//   Here it is ONE cooperative launch of one block per SM (at most m/2),
//   every block resident: the rows, owned by equalized pairs, stay in the
//   blocks' shared memory from step to step (all of them up to n = 2641 in
//   fp32 and 3698 in bf16; at n = 4096 the rows above theta = 1519 keep
//   columns [theta, n), and the rest streams through L2, eight steps' updates
//   a pass), so a step moves the pivot row and little else.  A pivot waits on one handoff instead of a barrier over
//   the card: the owner of row k+1 updates that row first (one pivot of
//   lookahead), stores it to the matrix and release-stores its ready flag;
//   every block acquire-loads flag k before it reads pivot row k through
//   L2.  A flag that stays unset past kWaitCycles traps.  The flags are m+1
//   ints the wrapper zeroes; the last counts the blocks done.
//   The plain version masks instead of slicing (kernels/ebv_lu.py:
//   _lu_steps_plain), so a non-finite value spreads further there than the
//   rank-1 updates carry it: a row whose last multiplier is not finite
//   turns NaN left of it (a - l*0), and a column whose pivot-row entry
//   above the diagonal is not finite turns NaN in every row above (a - 0*u).
//   The kernel applies both rules after the walk (the second after one grid
//   barrier), so it equals the plain version value for value, NaN and inf
//   positions included.  Bound: 2n^3/3 flops in 2n^3/3 separately rounded
//   operations, and n-1 dependent handoffs (~3 L2 round trips each).
//
// u12_solve_kernel + the SGEMM tile — replace src/repro/kernels/ebv_lu.py:
//   fused_step: per column tile, U12 = L11^-1 A12 (unit lower, b sequential
//   masked axpys) and then A22 - L21 U12.  The TPU kernel keeps the whole
//   (m, b) panel in VMEM (8 MB at m = 8000, b = 256) and solves U12 in every
//   grid step.  Here it is two launches in stream order, the second a
//   programmatic dependent launch of the first:
//   - u12_solve_kernel solves each tile of 16 U12 columns once, a block a
//     tile (112 blocks at n = 2000, step 1: W = 1792), the tile in shared
//     memory: in strips of 32 pivots, L11's strip staged in shared memory,
//     one warp solves the strip's 32 x 32 triangle in registers (a lane a
//     column), then every thread retires the strip's 32 terms, in pivot
//     order, from its row and four columns below the strip.  Each element
//     takes its terms k = 0, 1, ... in turn, each multiply and subtract
//     rounded to T (__fmul_rn, __fsub_rn, rnd<T>), so U12 is the plain
//     version's bit for bit in fp32 and bf16.  The plain version masks each
//     axpy (y - where(rows > k, l, 0) y_k), so a non-finite y_k turns every
//     row at or above k NaN (0 * inf), and each later y_j is non-finite in
//     turn: a column holding any non-finite value ends NaN throughout.  The
//     kernel retires only the rows below each pivot and then applies that
//     rule, so it equals the plain version value for value;
//   - A22 - L21 U12 on the dense factor's SGEMM tile (sgemm.cuh), as update
//     below: L21 row-major as it lies in the panel, U12 from the first
//     launch (read after griddepcontrol.wait), a NaN column of U12 a NaN
//     column of A22.
//   Bound: b(b-1)W flops of the solve and 2(m-b)bW of the product (1.6
//   GFLOP at n = 2000, step 1), fp32 on the CUDA cores.  The product runs at
//   the tile's rate; the solve has b/(2(m-b)) of its flops, in one wave.
//
// update — replaces src/repro/kernels/ebv_lu.py:update: A22 - L21 U12 into
//   a new tensor, one launch of the dense factor's SGEMM tile (sgemm.cuh):
//   128x128, 128x64 or 64x64 output tiles, whichever splits (m, w) most
//   evenly over the SMs; L21 arrives row-major and stays so in shared
//   memory, bf16 operands widen to fp32 as they are read, the product
//   accumulates in fp32 and rounds once to the output type.  Bound: 2mbw
//   flops (fp32 outside the tensor cores) against (mb + bw + 2mw) elements
//   of traffic; the tile runs the card's CUDA cores at about half their
//   fp32 peak at large sizes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ebv_walk.cuh"
#include "handoff.cuh"
#include "pdl.cuh"
#include "sgemm.cuh"

namespace {

constexpr int kSolveCols = 16;       // U12 columns a solve block owns
constexpr int kSolveThreads = 256;
constexpr int kStrip = 32;           // pivots of L11 staged at once
constexpr int kSmemMax = 232448;     // dynamic shared memory one H100 block may use

extern __shared__ __align__(16) float smem[];  // 16 bytes for the solve's float4 reads

template <typename T>
__global__ void __launch_bounds__(kWalkThreads, 1)
ebv_walk_kernel(T* a, int m, int ncols, int steps, int theta, size_t lbuf_at, size_t rows_at,
                int* ready) {
  const int G = gridDim.x;
  const Walk<T> w(a, ncols, Owned(blockIdx.x, G, m), theta, reinterpret_cast<char*>(smem), lbuf_at,
                  rows_at);
  w.load_rows();
  int live = w.own.count(), w0 = 0, kept = -1;  // the streamed elements have steps [w0, k) pending
  float kv[kKeep];                               // the kept row's streamed columns (Walk::keep)
  for (int k = 0; k < steps; ++k) {
    if (k > 0 && threadIdx.x == 0) wait_until(ready + k, 1);  // row 0 is the input's
    __syncthreads();  // pivot row k is in the matrix, and this block's step k-1 is done
    while (live > 0 && w.own.row(live - 1) <= k) --live;
    const T* pk = a + (size_t)k * ncols;
    w.stage(k, w0, live, kept, [&](int j) { return load_l2(pk + j); });
    __syncthreads();
    const int next = live > 0 && w.own.row(live - 1) == k + 1 ? live - 1 : -1;
    if (next >= 0) {  // row k+1 first, into the matrix, then its flag
      w.ahead(k, next, next == kept ? k : w0, true, next == kept, kv);
      __syncthreads();
      if (threadIdx.x == 0) store_release(ready + k + 1, 1);  // the block's stores before it
    }
    w.update(k, live, next);
    if ((k + 1) % kLag == 0) {
      w.sweep(k, w0, live, next);
      w0 = k + 1;
    }
    kept = w.keep(k, w0, live, next, kv);
  }
  __syncthreads();
  w.write_back(true);  // the multipliers; each row's U part went out with its flag
  __syncthreads();
  const float nan = __int_as_float(0x7fffffff);
  // a row whose last multiplier is not finite: NaN left of it
  for (int t = 0; t < w.own.count(); ++t) {
    const int r = w.own.row(t), last = (r < steps ? r : steps) - 1;
    if (!isfinite(load_l2(w.at(t, last))))
      for (int j = threadIdx.x; j < last; j += blockDim.x) store_l2(w.at(t, j), nan);
  }
  // every block has read its last pivot row before any column turns NaN
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ready + m, 1);
    wait_until(ready + m, G);
  }
  __syncthreads();
  // a column whose entry in its last pivot row is not finite: NaN above it
  for (int j = 1 + blockIdx.x; j < ncols; j += G) {
    const int t = (j - 1 < steps - 1 ? j - 1 : steps - 1);
    if (!isfinite(load_l2(a + (size_t)t * ncols + j)))
      for (int i = threadIdx.x; i <= t; i += blockDim.x) store_l2(a + (size_t)i * ncols + j, nan);
  }
}

// The solve's shared memory in floats: the tile ys (b rows of 16), a strip
// of L11 (max(b, 32) rows of 33: the triangle reads 32 rows, and those past
// the panel feed only rows it never stores) and a flag a column.
inline size_t u12_solve_floats(int b) {
  return (size_t)b * kSolveCols + (size_t)(b > kStrip ? b : kStrip) * (kStrip + 1) + kSolveCols;
}

// grid: tiles of 16 columns; pan (m, b) and top (b, w) row-major, u12 (b, w).
template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
u12_solve_kernel(const T* __restrict__ pan, const T* __restrict__ top, T* __restrict__ u12, int b, int w) {
  allow_next_step();  // the product's blocks may start; they wait for this launch before reading U12
  constexpr int lds = kStrip + 1;
  float* ys = smem;                     // ys[i * 16 + c]
  float* ls = smem + b * kSolveCols;    // ls[(i - s0) * 33 + l] = L11[i, s0 + l]
  int* bad = reinterpret_cast<int*>(ls + (b > kStrip ? b : kStrip) * lds);  // a column holds a non-finite value
  const int col0 = blockIdx.x * kSolveCols, cols = min(kSolveCols, w - col0);
  const int tid = threadIdx.x;
  if (tid < kSolveCols) bad[tid] = 0;
  for (int idx = tid; idx < b * kSolveCols; idx += kSolveThreads) {
    const int i = idx / kSolveCols, c = idx % kSolveCols;
    ys[idx] = c < cols ? load(top + (size_t)i * w + col0 + c) : 0.f;
  }
  // a thread retires rows q0, q0 + 64, ... of four columns c4 .. c4+3
  const int c4 = 4 * (tid % 4), q0 = tid / 4;
  for (int s0 = 0; s0 < b; s0 += kStrip) {
    const int kw = min(kStrip, b - s0);
    __syncthreads();  // the last strip's retire has read ls
    for (int idx = tid; idx < (b - s0) * kStrip; idx += kSolveThreads) {
      const int r = idx / kStrip, l = idx % kStrip;
      ls[r * lds + l] = l < kw ? load(pan + (size_t)(s0 + r) * b + s0 + l) : 0.f;
    }
    __syncthreads();
    if (tid < kSolveCols) {  // the strip's triangle: lane c solves column c in registers
      float y[kStrip];
#pragma unroll
      for (int j = 0; j < kStrip; ++j) y[j] = j < kw ? ys[(s0 + j) * kSolveCols + tid] : 0.f;
#pragma unroll
      for (int l = 0; l < kStrip - 1; ++l)
#pragma unroll
        for (int j = l + 1; j < kStrip; ++j)  // rows past kw read rows of ls never stored back
          y[j] = rnd<T>(__fsub_rn(y[j], rnd<T>(__fmul_rn(ls[j * lds + l], y[l]))));
#pragma unroll
      for (int j = 0; j < kStrip; ++j)
        if (j < kw) ys[(s0 + j) * kSolveCols + tid] = y[j];
    }
    __syncthreads();
    // the rows below the strip take its 32 terms in order (a strip with rows
    // below it is a whole one)
    for (int i = s0 + kStrip + q0; i < b; i += kSolveThreads / 4) {
      float4 acc = *reinterpret_cast<const float4*>(ys + i * kSolveCols + c4);
      const float* li = ls + (i - s0) * lds;
#pragma unroll
      for (int l = 0; l < kStrip; ++l) {
        const float lv = li[l];
        const float4 yk = *reinterpret_cast<const float4*>(ys + (s0 + l) * kSolveCols + c4);
        acc.x = rnd<T>(__fsub_rn(acc.x, rnd<T>(__fmul_rn(lv, yk.x))));
        acc.y = rnd<T>(__fsub_rn(acc.y, rnd<T>(__fmul_rn(lv, yk.y))));
        acc.z = rnd<T>(__fsub_rn(acc.z, rnd<T>(__fmul_rn(lv, yk.z))));
        acc.w = rnd<T>(__fsub_rn(acc.w, rnd<T>(__fmul_rn(lv, yk.w))));
      }
      *reinterpret_cast<float4*>(ys + i * kSolveCols + c4) = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < b * kSolveCols; idx += kSolveThreads)
    if (!isfinite(ys[idx])) bad[idx % kSolveCols] = 1;
  __syncthreads();
  const float nan = __int_as_float(0x7fffffff);
  for (int idx = tid; idx < b * cols; idx += kSolveThreads) {
    const int i = idx / cols, c = idx % cols;
    store(u12 + (size_t)i * w + col0 + c, bad[c] ? nan : ys[i * kSolveCols + c]);
  }
}

template <typename T>
cudaError_t launch_walk(void* a, int m, int ncols, int steps, void* ready, cudaStream_t stream,
                        int* plan, int* launched) {
  auto kernel = ebv_walk_kernel<T>;
  int device = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device))) return err;
  if (!coop) return cudaErrorNotSupported;
  const int units = m / 2;
  int grid = units < sms ? units : sms;
  const WalkPlan p = walk_plan(m, ncols, grid, sizeof(T));
  if (!p.bytes) return cudaErrorInvalidValue;  // not even the pivot row fits
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(p.bytes))))
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWalkThreads, p.bytes)))
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  plan[0] = grid;
  plan[1] = p.theta;
  plan[2] = static_cast<int>(p.bytes);
  T* mat = static_cast<T*>(a);
  int theta = p.theta;
  size_t lbuf_at = p.lbuf_at, rows_at = p.rows_at;
  int* flags = static_cast<int*>(ready);
  void* args[] = {&mat, &m, &ncols, &steps, &theta, &lbuf_at, &rows_at, &flags};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(kWalkThreads),
                                    args, p.bytes, stream);
  if (err) return err;
  *launched = 1;
  return cudaGetLastError();
}

// The shared memory attributes of the update's tiles, set once per device.
cudaError_t allow_update_smem() {
  cudaError_t err;
  if ((err = allow_gemm_smem<float, false>())) return err;
  return allow_gemm_smem<__nv_bfloat16, false>();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_update(const void* l, const void* u, const void* c, void* o, int m, int kd, int w,
                          cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = device_sms<allow_update_smem>(&sms);
  if (err) return err;
  const bool f32 = sizeof(T) == 4;
  const int vec = f32 && w % 4 == 0 && aligned16(c) && aligned16(o);
  const int vec_b = f32 && w % 4 == 0 && aligned16(u);
  const int vec_a = f32 && kd % 4 == 0 && aligned16(l);
  const Gemm<T> g{static_cast<const T*>(l), kd, static_cast<const T*>(u), w, static_cast<const T*>(c),
                  static_cast<T*>(o), w, m, w, kd, vec, vec_b, vec_a};
  return launch_gemm_rect<T, false>(g, 0, 0, m, w, sms, 0, false, stream);
}

// The shared memory attributes of the fused step's two kernels, set once
// per device.
cudaError_t allow_fused_step_smem() {
  cudaError_t err;
  if ((err = allow_update_smem())) return err;
  if ((err = allow_smem(u12_solve_kernel<float>, kSmemMax))) return err;
  return allow_smem(u12_solve_kernel<__nv_bfloat16>, kSmemMax);
}

// U12 = L11^-1 top, then out = trail - L21 U12 on the SGEMM tile, a
// programmatic dependent launch of the solve (none where out is empty).
template <typename T>
cudaError_t launch_fused_step(const void* pan, const void* top, const void* trail, void* u12, void* out, int m,
                              int b, int w, cudaStream_t stream, int* launched) {
  const size_t bytes = u12_solve_floats(b) * sizeof(float);
  if (bytes > (size_t)kSmemMax) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err;
  if ((err = device_sms<allow_fused_step_smem>(&sms))) return err;
  if ((err = launch_step(u12_solve_kernel<T>, dim3((w + kSolveCols - 1) / kSolveCols), dim3(kSolveThreads),
                         bytes, stream, false, static_cast<const T*>(pan), static_cast<const T*>(top),
                         static_cast<T*>(u12), b, w)))
    return err;
  *launched = 1;
  if (m - b < 1) return cudaSuccess;
  const bool f32 = sizeof(T) == 4;
  const T* l21 = static_cast<const T*>(pan) + (size_t)b * b;
  const int vec = f32 && w % 4 == 0 && aligned16(trail) && aligned16(out);
  const int vec_b = f32 && w % 4 == 0 && aligned16(u12);
  const int vec_a = f32 && b % 4 == 0 && aligned16(l21);
  const Gemm<T> g{l21, b, static_cast<const T*>(u12), w, static_cast<const T*>(trail), static_cast<T*>(out), w,
                  m - b, w, b, vec, vec_b, vec_a};
  if ((err = launch_gemm_rect<T, false>(g, 0, 0, m - b, w, sms, 0, true, stream))) return err;
  *launched = 2;
  return cudaSuccess;
}

}  // namespace

// In place, the EbV steps on the row-major (m, ncols) matrix `a` (fp32, or
// bf16 when `bf16` is 1): lu_vmem with m = ncols and steps = n - 1, panel
// with m >= ncols and steps = b = ncols.  `ready` points to m + 1 zeroed
// ints (the rows' ready flags and the count of blocks done).  One
// cooperative launch when there is a row to update; `*launched` says how
// many were made, plan[0..2] the blocks, theta and the shared-memory bytes.
extern "C" int ebv_legacy_walk(void* a, int m, int ncols, int steps, int bf16, void* ready,
                               void* stream, int* plan, int* launched) {
  *launched = 0;
  plan[0] = plan[1] = plan[2] = 0;
  if (steps <= 0 || m < 2) return 0;
  const bool square = m == ncols && steps == ncols - 1, tall = m >= ncols && steps == ncols;
  if (!square && !tall) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_walk<__nv_bfloat16>(a, m, ncols, steps, ready, s, plan, launched)
              : launch_walk<float>(a, m, ncols, steps, ready, s, plan, launched);
}

// u12 = L11^-1 top and out = trail - L21 u12 for the packed panel pan (m, b),
// top (b, w) and trail (m - b, w): the solve, then the product (none where
// m = b); *launched says how many launches were made.
extern "C" int ebv_legacy_fused_step(const void* pan, const void* top, const void* trail, void* u12,
                                     void* out, int m, int b, int w, int bf16, void* stream, int* launched) {
  *launched = 0;
  if (b < 1 || w < 1) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused_step<__nv_bfloat16>(pan, top, trail, u12, out, m, b, w, s, launched)
              : launch_fused_step<float>(pan, top, trail, u12, out, m, b, w, s, launched);
}

// o = c - l u for l (m, kd), u (kd, w), c and o (m, w), row-major; one
// launch, none where o is empty.
extern "C" int ebv_legacy_update(const void* l, const void* u, const void* c, void* o, int m, int kd,
                                 int w, int bf16, void* stream) {
  if (m < 1 || w < 1) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_update<__nv_bfloat16>(l, u, c, o, m, kd, w, s)
              : launch_update<float>(l, u, c, o, m, kd, w, s);
}
