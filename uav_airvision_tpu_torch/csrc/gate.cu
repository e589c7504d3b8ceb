// K10: the chi-square gate of the feature blocks, the whole gate in one launch.
//
// Replaces uav_airvision_tpu/models/msckf/update.py::gating_test_batch
// (:170-230).  The JAX function decides in one lax.cond tree with no host
// read; so does this kernel (entry point gate_f32 / gate_f64), which writes
// the (B,) decisions:
//
//   thresh = chi2_table[clip(dof)], looked up per block;
//   R <= 32: gamma < thresh on all R rows, one block per feature;
//   R > 32, a cooperative launch (every block co-resident):
//     phase 1, per feature: rtr = r.r and tr = trace(H P H^T), the flags
//       pass = rtr < thresh s2 and fail = rtr > thresh (s2 + tr);
//     grid.sync();
//     phase 2, every block reads all B flags and max(rows_true): if no
//       feature is undecided the result is pass; else EVERY feature takes
//       gamma < thresh, on the first 32 rows when max(rows_true) <= 32,
//       else on all R rows.  So gamma runs only when some feature needs it,
//       as in JAX.
//   gamma = r^T S^-1 r with S = H P H^T + s2 I, by right-looking
//   elimination S = L D L^T (unit L) with r as a border row: entry j of the
//   border before step j is y_j of L y = r, and gamma = sum_j y_j^2 / d_j,
//   which is |chol(S)^-1 r|^2.  A pivot that is not > 0 makes gamma NaN,
//   which fails the gate as a failed factorisation does in the plain version.
//
// The grid is sized to the co-resident limit (cudaOccupancy... x SMs) and
// blocks walk over the features, so every B runs; on the main path B <= 64
// (capacity.max_lost_per_frame) and one block per feature fits on the 132
// SMs.  Phase 2 walks a block's features in reverse, so that the feature
// still in shared memory from phase 1 is not loaded again, and its H P,
// which phase 1 computed for the trace, is not computed again.
//
// Shared memory (float32, 77 x 141 blocks, 190 KB of the 227 KB): P
// (141 x 141, 79.5 KB), staged once per block by one bulk asynchronous copy
// (cp.async.bulk, completion on an mbarrier; the last D*D*4 mod 16 bytes
// and an unaligned P by plain loads); H and all of H P (43 KB each); S's
// lower triangle with the border row (24 KB).  So the products read shared
// memory, not L2.  In float64 P (159 KB) does not fit beside them and stays
// in L2 (in float32 too for a state too large); H P is kept in chunks of 16
// rows when all of it does not fit.  When even that does not fit (float32
// from 36 window slots, 137-row blocks of 231 columns and up), each block
// keeps its H, H P chunk and S in a workspace in device memory that the
// caller allocates, where they stay in L2.  Both products are register-tiled, as
// shared-memory reads bound them: H P a warp per four rows, a lane per
// column block (per k 4 reads of H, one per column block of P, for 4
// products each); S a thread per 4 x 4 tile (8 reads for 16 products).
// The products are fused multiply-adds (the kernel's other arithmetic
// keeps the build's -fmad=false): the plain version's products are
// cuBLAS's, whose order and rounding differ anyway, and the gate is held
// to it within 1e-4 of gamma.  512 threads (16 warps) a block, so that the
// dependent loads and products of a warp overlap those of others.  The
// elimination takes one barrier a column, a warp per row.  Rows of H
// past the last nonzero row (the feature's true height 4 n_obs - 3) add
// nothing to either result: their part of S is s2 I and their residual 0,
// so the block stops at that row.  The only exception is kept: with
// s2 <= 0 such a row fails the factorisation.
//
// Tensor cores are not the lever: float32 must stay full float32 (TF32 is
// off to match the JAX package's HIGHEST precision, device.py) and the
// blocks are 5 to 77 rows.
//
// Bound on the card: bytes at the main path's shapes.  Each feature's H
// (77 x 141, 43 KB in float32) is read whole, but only its ~4 n_obs - 3
// rows of data take the 2 nz D^2 FLOP of H P.  In practice the time is the
// launch and, on the device, one SM's products and the elimination's
// chain of barriers per feature.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 16;  // rows of H P held at a time when all do not fit
constexpr int kQ = 8;       // most column blocks of 32 a warp takes at once in hp_rows
constexpr int kTier = 32;   // GATE_TIER: the small tier's row prefix

template <typename T>
struct GateArgs {
  const T* H;  // (B, R, D), rows contiguous; block b at H + b * h_stride
  const T* r;  // (B, R), block b at r + b * r_stride
  int B, R, D;
  long long h_stride, r_stride;
  const int* rows_true;  // (B,)
  const void* dof;       // (B,) int32 or int64
  int dof_i64;
  const T* P;          // (D, D)
  const T* obs_noise;  // (1,)
  const T* table;      // (n_table,) chi-square thresholds
  int n_table;
  int p_shared;     // stage P in shared memory
  int hp_full;      // keep all rows of H P (else kChunk rows at a time)
  T* work;          // past a block's shared memory: H, H P and A of each block here
  uint8_t* out;     // (B,) decisions
  uint8_t* flags;   // (B,) phase 1's bound flags (bit 0 pass, bit 1 fail)
  T* gamma;         // (B,) gamma where it was computed
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Copy n elements of P into shared memory: one bulk asynchronous copy of the
// 16-byte multiple when P is 16-byte aligned, plain loads for the rest.
template <typename T>
__device__ void stage_p(T* Ps, const T* P, int n, uint64_t* mbar) {
  const uint32_t bulk = ((uintptr_t)P % 16 == 0) ? (uint32_t)((size_t)n * sizeof(T)) & ~15u : 0u;
  const int head = (int)(bulk / sizeof(T));
  const uint32_t bar = smem_addr(mbar);
  if (bulk > 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bulk)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(Ps)),
        "l"(P), "r"(bulk), "r"(bar)
        : "memory");
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads) Ps[i] = P[i];
  __syncthreads();  // the barrier is initialised before anyone waits on it
  if (bulk > 0) mbar_wait(bar, 0);
  __syncthreads();
}

template <typename T>
__device__ T threshold(const GateArgs<T>& a, int b) {
  long long d = a.dof_i64 ? static_cast<const long long*>(a.dof)[b]
                          : (long long)static_cast<const int*>(a.dof)[b];
  d = d < 0 ? 0 : (d > a.n_table - 1 ? a.n_table - 1 : d);
  return a.table[d];
}

// Rows [0, m) of feature b's H into shared memory (row stride D).
template <typename T>
__device__ void load_rows(const GateArgs<T>& a, int b, int m, T* Hs) {
  __syncthreads();  // the previous feature's readers are done with Hs
  const T* H_b = a.H + (size_t)b * a.h_stride;
  for (int e = threadIdx.x; e < m * a.D; e += kThreads) Hs[e] = H_b[e];
  __syncthreads();
}

// The number of rows among the first m up to the last one with a nonzero
// entry of H or r.
template <typename T>
__device__ int rows_needed(const T* Hs, const T* r_b, int m, int D, int* s_nz) {
  __syncthreads();  // every thread has read the previous value
  if (threadIdx.x == 0) *s_nz = 0;
  __syncthreads();
  int nz = 0;
  for (int e = threadIdx.x; e < m * D; e += kThreads)
    if (Hs[e] != T(0)) nz = max(nz, e / D + 1);
  for (int i = threadIdx.x; i < m; i += kThreads)
    if (r_b[i] != T(0)) nz = max(nz, i + 1);
  atomicMax(s_nz, nz);
  __syncthreads();
  return *s_nz;
}

// (H P)_ic for the rows i in [i0, i0 + rows) of the shared H (row stride D)
// and every column c, into out (row i - i0, stride D).  A warp takes four
// rows and a run of Q column blocks, a lane the columns lane + 32 q of them:
// per k it reads four entries of H (one address a warp) and one of P per
// column block, for 4 products each.  The runs are as long as the warps
// allow (all five blocks of 141 columns for 77 rows, one for 5 rows); Q is
// a template parameter, so that no column block is issued in vain.  The sum
// over k runs in order, one accumulator per entry.  P is in shared memory
// or in global memory (a generic pointer).
template <typename T, int Q>
__device__ void hp_run(const T* Hs, const T* P, int D, int i0, int rows, int runs, T* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (rows + 3) / 4;
  for (int task = warp; task < groups * runs; task += kThreads / 32) {
    const int g = task / runs, c0 = (task % runs) * Q * 32;
    const int r0 = i0 + 4 * g, nr = min(4, i0 + rows - r0);
    const T* h[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) h[a] = Hs + (r0 + min(a, nr - 1)) * D;  // past the range: the last row
    bool in[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) in[q] = c0 + lane + 32 * q < D;
    T acc[4][Q];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[a][q] = T(0);
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      T hv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) hv[a] = h[a][k];
      const T* pk = P + (size_t)k * D + c0 + lane;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const T pv = in[q] ? pk[32 * q] : T(0);
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][q] = fma(hv[a], pv, acc[a][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = c0 + lane + 32 * q;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (in[q] && a < nr) out[(r0 - i0 + a) * D + c] = acc[a][q];
    }
  }
}

template <typename T>
__device__ void hp_rows(const T* Hs, const T* P, int D, int i0, int rows, T* out) {
  const int groups = (rows + 3) / 4, n_blocks = (D + 31) / 32;
  const int run = max(1, min(min(kQ, n_blocks), n_blocks * groups / (kThreads / 32)));
  const int runs = (n_blocks + run - 1) / run;
  switch (run) {
    case 1: hp_run<T, 1>(Hs, P, D, i0, rows, runs, out); break;
    case 2: hp_run<T, 2>(Hs, P, D, i0, rows, runs, out); break;
    case 3: hp_run<T, 3>(Hs, P, D, i0, rows, runs, out); break;
    case 4: hp_run<T, 4>(Hs, P, D, i0, rows, runs, out); break;
    case 5: hp_run<T, 5>(Hs, P, D, i0, rows, runs, out); break;
    case 6: hp_run<T, 6>(Hs, P, D, i0, rows, runs, out); break;
    case 7: hp_run<T, 7>(Hs, P, D, i0, rows, runs, out); break;
    default: hp_run<T, 8>(Hs, P, D, i0, rows, runs, out); break;
  }
}

// Rows [i0, i0 + rows) (i0 a multiple of 4) of the lower triangle of
// S = (H P) H^T + s2 I on its first nz rows, into A (row stride lda), from
// HPc (those rows of H P) and the shared H.  With enough 4 x 4 tiles to
// occupy the block, a thread takes a tile (8 reads for 16 products per
// column); with fewer (a few rows), a thread takes an entry, so that the
// block's threads share the work.
template <typename T>
__device__ void s_rows(const T* HPc, const T* Hs, int D, int i0, int rows, int nz, int lda, T s2,
                       T* A) {
  const int last = min(i0 + rows, nz) - 1;
  const int I0 = i0 / 4, I1 = (last + 4) / 4;
  const int t0 = I0 * (I0 + 1) / 2, n_tiles = I1 * (I1 + 1) / 2 - t0;
  if (n_tiles < kThreads / 2) {  // an entry a thread: (i, k), k <= i, rows i of this range
    const int e0 = i0 * (i0 + 1) / 2, n_entries = (last + 1) * (last + 2) / 2 - e0;
    for (int t = threadIdx.x; t < n_entries; t += kThreads) {
      const int u = e0 + t;
      int i = (int)((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
      while ((i + 1) * (i + 2) / 2 <= u) ++i;
      while (i * (i + 1) / 2 > u) --i;
      const int k = u - i * (i + 1) / 2;
      const T* x = HPc + (i - i0) * D;
      const T* y = Hs + k * D;
      T acc = T(0);
      for (int c = 0; c < D; ++c) acc = fma(x[c], y[c], acc);
      A[i * lda + k] = k == i ? acc + s2 : acc;
    }
    return;
  }
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    const int u = t0 + t;  // tile (I, K), K <= I, in row-major triangular order
    int I = (int)((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
    while ((I + 1) * (I + 2) / 2 <= u) ++I;
    while (I * (I + 1) / 2 > u) --I;
    const int K = u - I * (I + 1) / 2;
    const T* x[4];
    const T* y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = HPc + (min(4 * I + a, last) - i0) * D;
      y[a] = Hs + min(4 * K + a, nz - 1) * D;
    }
    T acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = T(0);
    for (int c = 0; c < D; ++c) {
      T xv[4], yv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = x[a][c], yv[a] = y[a][c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fma(xv[a], yv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * I + a, k = 4 * K + b;
        if (i <= last && k <= i) A[i * lda + k] = k == i ? acc[a][b] + s2 : acc[a][b];
      }
  }
}

struct Smem {  // the dynamic shared memory's layout, in elements of T
  size_t p, h, hp, a, total;
};

// P (if staged), H (R x D), H P (R x D, or kChunk x D when the whole does
// not fit) and A ((R + 1) x (R | 1): S's lower triangle, row R the
// residual; an odd row stride, so that a column's entries lie in 32 banks).
template <typename T>
__host__ __device__ Smem layout(int R, int D, bool p_shared, bool hp_full) {
  Smem s;
  s.p = 0;
  s.h = p_shared ? ((size_t)D * D + 1) / 2 * 2 : 0;  // keeps H 8-byte aligned
  s.hp = s.h + (size_t)R * D;
  s.a = s.hp + (size_t)(hp_full ? R : kChunk) * D;
  s.total = (s.a + (size_t)(R + 1) * (R | 1)) * sizeof(T);
  return s;
}

// Shared state of a block: P (or the global P), H, H P and A.
template <typename T>
struct Block {
  const T* P;
  T *Hs, *HP, *A;
  bool hp_full;
};

// The bound flags of feature b, whose R rows are in Hs: bit 0 pass, bit 1
// fail.  Returns them to every thread; *nz_out gets the rows that hold
// data (H P is in HP for those rows with the full layout).
template <typename T>
__device__ int bound_flags(const GateArgs<T>& a, int b, const Block<T>& blk, T* red, int* s_nz,
                           int* nz_out) {
  const T* r_b = a.r + (size_t)b * a.r_stride;
  const int D = a.D;
  const int nz = rows_needed(blk.Hs, r_b, a.R, D, s_nz);
  T rr = T(0);
  for (int i = threadIdx.x; i < a.R; i += kThreads) rr += r_b[i] * r_b[i];
  // trace(H P H^T) = sum_ic (H P)_ic H_ic
  T acc = T(0);
  const int step = blk.hp_full ? (nz > 0 ? nz : 1) : kChunk;
  for (int i0 = 0; i0 < nz; i0 += step) {
    const int rows = min(step, nz - i0);
    hp_rows(blk.Hs, blk.P, D, i0, rows, blk.HP);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * D; e += kThreads)
      acc = fma(blk.HP[e], blk.Hs[i0 * D + e], acc);
    __syncthreads();
  }
  const T tr = msckf::block_sum(acc, red);
  const T rtr = msckf::block_sum(rr, red);
  const T s2 = *a.obs_noise, thr = threshold(a, b);
  *nz_out = nz;
  return (rtr < thr * s2 ? 1 : 0) | (rtr > thr * (s2 + tr) ? 2 : 0);
}

// gamma < thresh for feature b on its first m rows (in Hs, row stride D);
// thread 0 writes gamma and the decision.  hp_done: rows of H P already in
// HP for this feature (full layout; 0 when none).
template <typename T>
__device__ void gamma_decide(const GateArgs<T>& a, int b, int m, const Block<T>& blk,
                             int hp_done, T* red, int* s_nz, int* s_bad, T* s_gamma) {
  const int tid = threadIdx.x, D = a.D;
  const T* r_b = a.r + (size_t)b * a.r_stride;
  const int nz = rows_needed(blk.Hs, r_b, m, D, s_nz);
  const T s2 = *a.obs_noise;
  T* A = blk.A;
  const int lda = m | 1;  // odd: the column reads of the elimination hit 32 banks
  for (int j = tid; j < nz; j += kThreads) A[m * lda + j] = r_b[j];
  if (tid == 0) *s_bad = (nz < m && !(s2 > T(0))) ? 1 : 0, *s_gamma = T(0);

  // lower triangle of S = (H P) H^T + s2 I: H P from the bounds when it is
  // there, else all of it (full layout) or kChunk rows at a time
  const int step = blk.hp_full ? (nz > 0 ? nz : 1) : kChunk;
  for (int i0 = 0; i0 < nz; i0 += step) {
    const int rows = min(step, nz - i0);
    if (!(blk.hp_full && hp_done >= nz)) hp_rows(blk.Hs, blk.P, D, i0, rows, blk.HP);
    __syncthreads();
    s_rows(blk.HP, blk.Hs, D, i0, rows, nz, lda, s2, A);
    __syncthreads();
  }

  // S = L D L^T by right-looking elimination, one barrier a column; the
  // border row m is eliminated with the others, so that its entry j before
  // step j is y_j of L y = r and gamma = sum_j y_j^2 / d_j
  // (= |chol(S)^-1 r|^2).  A pivot that is not > 0 fails the factorisation.
  const int warp = tid >> 5, lane = tid & 31;
  for (int j = 0; j < nz; ++j) {
    const T d = A[j * lda + j], inv = T(1) / d;
    if (tid == 0) {
      if (!(d > T(0))) *s_bad = 1;
      const T y = A[m * lda + j];
      *s_gamma += y * y / d;
    }
    const int n_rows = nz - j;  // rows j+1 .. nz-1, and the border row
    for (int t = warp; t < n_rows; t += kThreads / 32) {
      const int i = t < n_rows - 1 ? j + 1 + t : m;
      const int k_end = i < m ? i : nz - 1;
      const T l = A[i * lda + j] * inv;
      for (int k = j + 1 + lane; k <= k_end; k += 32)
        A[i * lda + k] = fma(-l, A[k * lda + j], A[i * lda + k]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const T g = *s_bad ? T(NAN) : *s_gamma;
    a.gamma[b] = g;
    a.out[b] = g < threshold(a, b) ? 1 : 0;
  }
}

template <typename T>
__device__ Block<T> setup(const GateArgs<T>& a, unsigned char* dyn, uint64_t* mbar) {
  const Smem s = layout<T>(a.R, a.D, a.p_shared != 0, a.hp_full != 0);
  T* base = a.work != nullptr ? a.work + (size_t)blockIdx.x * (s.total / sizeof(T))
                              : reinterpret_cast<T*>(dyn);
  Block<T> blk{a.P, base + s.h, base + s.hp, base + s.a, a.hp_full != 0};
  if (a.p_shared) {
    stage_p(base + s.p, a.P, a.D * a.D, mbar);
    blk.P = base + s.p;
  }
  return blk;
}

// R <= 32: gamma on all R rows for every feature; no decision couples them.
template <typename T>
__global__ void __launch_bounds__(kThreads) gate_small_kernel(GateArgs<T> a) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ uint64_t mbar;
  __shared__ T red[32], s_gamma;
  __shared__ int s_nz, s_bad;
  const Block<T> blk = setup(a, dyn_smem, &mbar);
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    load_rows(a, b, a.R, blk.Hs);
    gamma_decide(a, b, a.R, blk, 0, red, &s_nz, &s_bad, &s_gamma);
  }
}

// R > 32: the bounds, one grid-wide barrier, then the bounds' result or
// gamma on the tier that max(rows_true) selects.  Cooperative launch only.
template <typename T>
__global__ void __launch_bounds__(kThreads) gate_tiered_kernel(GateArgs<T> a) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ uint64_t mbar;
  __shared__ T red[32], s_gamma;
  __shared__ int s_nz, s_bad, s_any, s_max;
  const Block<T> blk = setup(a, dyn_smem, &mbar);
  int loaded = -1, hp_done = 0;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    load_rows(a, b, a.R, blk.Hs);
    const int f = bound_flags(a, b, blk, red, &s_nz, &hp_done);
    loaded = b;
    if (threadIdx.x == 0) a.flags[b] = (uint8_t)f;
  }
  cg::this_grid().sync();

  if (threadIdx.x == 0) s_any = 0, s_max = 0;
  __syncthreads();
  int any = 0, mx = 0;
  for (int i = threadIdx.x; i < a.B; i += kThreads) {
    any |= a.flags[i] == 0;
    mx = max(mx, a.rows_true[i]);
  }
  if (any) atomicOr(&s_any, 1);
  atomicMax(&s_max, mx);
  __syncthreads();
  if (!s_any) {
    if (threadIdx.x == 0)
      for (int b = blockIdx.x; b < a.B; b += gridDim.x) a.out[b] = a.flags[b] & 1;
    return;
  }
  const int m = s_max <= kTier ? kTier : a.R;
  // this block's features in reverse: the first is the one still in Hs,
  // whose H P the bounds left in HP
  const int x = (int)blockIdx.x, g = (int)gridDim.x;
  for (int b = x < a.B ? x + (a.B - 1 - x) / g * g : -1; b >= 0; b -= g) {
    if (b != loaded) {
      load_rows(a, b, m, blk.Hs);
      hp_done = 0;
    }
    gamma_decide(a, b, m, blk, hp_done, red, &s_nz, &s_bad, &s_gamma);
    loaded = -1;
  }
}

template <typename T>
int launch_gate(const void* H, const void* r, int B, int R, int D, long long h_stride,
                long long r_stride, const void* rows_true, const void* dof, int dof_i64,
                const void* P, const void* obs_noise, const void* table, int n_table, void* out,
                void* flags, void* gamma, void* work, void* stream) {
  // the card's properties, and per kernel the shared memory allowed and the
  // co-resident blocks at that size, looked up once
  static int sms = 0, optin = 0;
  static size_t small_allowed = 0, tiered_allowed = 0, occ_smem = 0;
  static int occ_per_sm = 0;  // 0: not looked up yet for occ_smem
  if (B == 0) return 0;
  if (sms == 0) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != 0) return err;
  }
  // the first layout that fits beside the static part (the mbarrier, the
  // reduction scratch, the counters): P staged and all of H P, then (the
  // tiered kernel, whose gamma reuses the bounds' H P) all of H P before
  // P, then H P in chunks
  const bool tiered = R > kTier;
  const bool order[4][2] = {{true, true}, {!tiered, tiered}, {tiered, !tiered}, {false, false}};
  bool p_shared = false, hp_full = false;
  for (const auto& o : order) {
    p_shared = o[0], hp_full = o[1];
    if (layout<T>(R, D, p_shared, hp_full).total + 512 <= (size_t)optin) break;
  }
  size_t smem = layout<T>(R, D, p_shared, hp_full).total;
  // even H in chunks of H P does not fit: each block's H, H P chunk and S
  // in the caller's workspace (min(B, co-resident blocks) x layout), in L2
  T* ws = nullptr;
  if (smem + 512 > (size_t)optin) {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    ws = (T*)work;
    smem = 0;
  }
  GateArgs<T> a{(const T*)H, (const T*)r, B, R, D, h_stride, r_stride,
                (const int*)rows_true, dof, dof_i64, (const T*)P, (const T*)obs_noise,
                (const T*)table, n_table, p_shared ? 1 : 0, hp_full ? 1 : 0, ws, (uint8_t*)out,
                (uint8_t*)flags, (T*)gamma};
  if (!tiered) {
    const int err = msckf::allow_smem(gate_small_kernel<T>, smem, &small_allowed);
    if (err != 0) return err;
    gate_small_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  int err = msckf::allow_smem(gate_tiered_kernel<T>, smem, &tiered_allowed);
  if (err != 0) return err;
  if (occ_per_sm == 0 || smem != occ_smem) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_per_sm, gate_tiered_kernel<T>,
                                                             kThreads, smem);
    if (err != 0) return err;
    occ_smem = smem;
  }
  if (occ_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  // one block per feature up to the co-resident limit; blocks walk the rest
  const int grid = B < occ_per_sm * sms ? B : occ_per_sm * sms;
  void* params[] = {&a};
  err = (int)cudaLaunchCooperativeKernel((const void*)gate_tiered_kernel<T>, dim3(grid),
                                         dim3(kThreads), params, smem, (cudaStream_t)stream);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// H, r, B, R, D, h_stride, r_stride, rows_true (int32), dof, dof is int64,
// P, obs_noise, table, n_table, out (B,) uint8, flags (B,) uint8 scratch,
// gamma (B,) T, work (B x the smallest layout's elements, or nullptr where
// that layout fits a block's shared memory), stream
extern "C" int gate_f32(const void* H, const void* r, int B, int R, int D, long long h_stride,
                        long long r_stride, const void* rows_true, const void* dof, int dof_i64,
                        const void* P, const void* obs_noise, const void* table, int n_table,
                        void* out, void* flags, void* gamma, void* work, void* stream) {
  return launch_gate<float>(H, r, B, R, D, h_stride, r_stride, rows_true, dof, dof_i64, P,
                            obs_noise, table, n_table, out, flags, gamma, work, stream);
}

extern "C" int gate_f64(const void* H, const void* r, int B, int R, int D, long long h_stride,
                        long long r_stride, const void* rows_true, const void* dof, int dof_i64,
                        const void* P, const void* obs_noise, const void* table, int n_table,
                        void* out, void* flags, void* gamma, void* work, void* stream) {
  return launch_gate<double>(H, r, B, R, D, h_stride, r_stride, rows_true, dof, dof_i64, P,
                             obs_noise, table, n_table, out, flags, gamma, work, stream);
}
