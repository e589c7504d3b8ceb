// K10: the chi-square gate of the feature blocks, in two entry points.
//
// Replaces uav_airvision_tpu/models/msckf/update.py::gating_test_batch
// (:170).  The port keeps the JAX package's branch structure in Python
// (update.py::gating_test_batch): the bounds first, a host read, then the
// exact test on the 32-row prefix or on all rows.  Each of the two pieces
// of work is one launch, one thread block per feature:
//
//   gate_bounds: rtr = r.r and tr = trace(H P H^T), then the flags
//     pass = rtr < thr s2 and fail = rtr > thr (s2 + tr);
//   gate_gamma: gamma = r^T S^-1 r with S = H P H^T + s2 I on the first m
//     rows, by an in-block Cholesky of S bordered with r (its last row of
//     L is L^-1 r); a pivot that is not > 0 makes gamma NaN, which fails
//     the gate as a failed factorisation does in the plain version.
//
// The block keeps H in shared memory and reads P (141 x 141, 79.5 KB in
// float32) through L2: every block reads the same P, so it stays resident
// there.  H P runs in the block's own loops (no library call): a thread
// takes one column of P and eight rows of H, so that each entry of P it
// reads from L2 serves eight products.  Rows of H past the last nonzero
// row (the feature's true height 4 n_obs - 3) add nothing to either
// result: their part of S is s2 I and their residual 0, so the block stops
// at that row.  The only exception is kept: with s2 <= 0 such a row fails
// the factorisation.
//
// Bound on the card: bytes at the main path's shapes.  Each feature's H
// (77 x 141, 43 KB in float32) is read whole, but only its ~4 n_obs - 3
// rows of data take the 2 nz D^2 FLOP of H P; a block of full height
// (3.1 MFLOP at nz = 77) would be bound by operations.  In practice the
// time is latency: the block's loops over D with L2 reads of P.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // rows of H P held at a time in gate_gamma
constexpr int kGroup = 8;   // rows of H per thread in hp_rows

// Load rows [0, m) of feature b's H into shared memory; returns the number
// of rows up to the last one with a nonzero entry of H or r.
template <typename T>
__device__ int load_rows(const T* H_b, const T* r_b, int m, int D, T* Hs, int* s_nz) {
  if (threadIdx.x == 0) *s_nz = 0;
  __syncthreads();
  int nz = 0;
  for (int e = threadIdx.x; e < m * D; e += kThreads) {
    const T h = H_b[(size_t)(e / D) * D + e % D];
    Hs[e] = h;
    if (h != T(0)) nz = max(nz, e / D + 1);
  }
  for (int i = threadIdx.x; i < m; i += kThreads)
    if (r_b[i] != T(0)) nz = max(nz, i + 1);
  atomicMax(s_nz, nz);
  __syncthreads();
  return *s_nz;
}

// (H P)_ic for the rows i in [i0, i0 + rows) of the shared H (m x D) and
// every column c; emit(i, c, value) receives each entry.  The sum over k
// runs in order, one accumulator per entry.
template <typename T, typename Emit>
__device__ void hp_rows(const T* Hs, const T* __restrict__ P, int D, int i0, int rows,
                        Emit emit) {
  const int groups = (rows + kGroup - 1) / kGroup;
  for (int e = threadIdx.x; e < groups * D; e += kThreads) {
    const int g = e / D, c = e % D;
    const int r0 = i0 + g * kGroup, nr = min(kGroup, i0 + rows - r0);
    int off[kGroup];
    T acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      off[j] = (r0 + min(j, nr - 1)) * D;  // rows past the range repeat the last one
      acc[j] = T(0);
    }
#pragma unroll 8  // eight reads of P in flight
    for (int k = 0; k < D; ++k) {
      const T p = P[(size_t)k * D + c];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[j] += Hs[off[j] + k] * p;
    }
    for (int j = 0; j < nr; ++j) emit(r0 + j, c, acc[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_bounds_kernel(const T* __restrict__ H, const T* __restrict__ r, int R, int D,
                   long long h_stride, long long r_stride, const T* __restrict__ P,
                   const T* __restrict__ obs_noise, const T* __restrict__ thresh,
                   uint8_t* __restrict__ pass, uint8_t* __restrict__ fail) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* Hs = reinterpret_cast<T*>(dyn_smem);  // R x D
  __shared__ T red[32];
  __shared__ int s_nz;
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* r_b = r + (size_t)b * r_stride;
  const int nz = load_rows(H + (size_t)b * h_stride, r_b, R, D, Hs, &s_nz);
  T rr = T(0);
  for (int i = tid; i < R; i += kThreads) rr += r_b[i] * r_b[i];
  // trace(H P H^T) = sum_ic (H P)_ic H_ic
  T acc = T(0);
  hp_rows(Hs, P, D, 0, nz, [&](int i, int c, T hp) { acc += hp * Hs[i * D + c]; });
  const T tr = msckf::block_sum(acc, red);
  const T rtr = msckf::block_sum(rr, red);
  if (tid == 0) {
    const T s2 = *obs_noise, thr = thresh[b];
    pass[b] = rtr < thr * s2 ? 1 : 0;
    fail[b] = rtr > thr * (s2 + tr) ? 1 : 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_gamma_kernel(const T* __restrict__ H, const T* __restrict__ r, int m, int D,
                  long long h_stride, long long r_stride, const T* __restrict__ P,
                  const T* __restrict__ obs_noise, T* __restrict__ gamma) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* Hs = reinterpret_cast<T*>(dyn_smem);  // m x D
  T* HP = Hs + m * D;                       // kChunk x D
  T* L = HP + kChunk * D;                   // (m + 1) x m: S, then L; row m is r, then L^-1 r
  __shared__ T red[32];
  __shared__ int s_nz, s_bad;
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* r_b = r + (size_t)b * r_stride;
  const int nz = load_rows(H + (size_t)b * h_stride, r_b, m, D, Hs, &s_nz);
  const T s2 = *obs_noise;
  for (int j = tid; j < nz; j += kThreads) L[m * m + j] = r_b[j];
  if (tid == 0) s_bad = (nz < m && !(s2 > T(0))) ? 1 : 0;

  // lower triangle of S = (H P) H^T + s2 I, kChunk rows of H P at a time
  for (int i0 = 0; i0 < nz; i0 += kChunk) {
    const int rows = min(kChunk, nz - i0);
    hp_rows(Hs, P, D, i0, rows, [&](int i, int c, T hp) { HP[(i - i0) * D + c] = hp; });
    __syncthreads();
    for (int e = tid; e < rows * nz; e += kThreads) {
      const int i = i0 + e / nz, k = e % nz;
      if (k > i) continue;
      const T* hp = HP + (i - i0) * D;
      const T* h = Hs + k * D;
      T s = T(0);
      for (int c = 0; c < D; ++c) s += hp[c] * h[c];
      L[i * m + k] = k == i ? s + s2 : s;
    }
    __syncthreads();
  }

  // Cholesky S = L L^T, column by column; the border row m becomes L^-1 r
  for (int j = 0; j < nz; ++j) {
    if (tid < 32) {
      T part = T(0);
      for (int k = tid; k < j; k += 32) part += L[j * m + k] * L[j * m + k];
      const T d = L[j * m + j] - msckf::warp_sum(part);
      if (tid == 0) {
        if (!(d > T(0))) s_bad = 1;
        L[j * m + j] = sqrt(d);
      }
    }
    __syncthreads();
    const int n_below = nz - j;  // rows j+1 .. nz-1, and the border row
    for (int t = tid; t < n_below; t += kThreads) {
      const int i = t < n_below - 1 ? j + 1 + t : m;
      T s = L[i * m + j];
      for (int k = 0; k < j; ++k) s -= L[i * m + k] * L[j * m + k];
      L[i * m + j] = s / L[j * m + j];
    }
    __syncthreads();
  }
  T part = T(0);
  for (int j = tid; j < nz; j += kThreads) part += L[m * m + j] * L[m * m + j];
  const T g = msckf::block_sum(part, red);
  if (tid == 0) gamma[b] = s_bad ? T(NAN) : g;
}

template <typename T>
int launch_bounds(const void* H, const void* r, int B, int R, int D, long long h_stride,
                  long long r_stride, const void* P, const void* obs_noise, const void* thresh,
                  void* pass, void* fail, void* stream) {
  static size_t smem_allowed = 0;
  if (B == 0) return 0;
  const size_t smem = (size_t)R * D * sizeof(T);
  const int err = msckf::allow_smem(gate_bounds_kernel<T>, smem, &smem_allowed);
  if (err != 0) return err;
  gate_bounds_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)r, R, D, h_stride, r_stride, (const T*)P, (const T*)obs_noise,
      (const T*)thresh, (uint8_t*)pass, (uint8_t*)fail);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gamma(const void* H, const void* r, int B, int m, int D, long long h_stride,
                 long long r_stride, const void* P, const void* obs_noise, void* gamma,
                 void* stream) {
  static size_t smem_allowed = 0;
  if (B == 0) return 0;
  const size_t smem = ((size_t)m * D + (size_t)kChunk * D + (size_t)(m + 1) * m) * sizeof(T);
  const int err = msckf::allow_smem(gate_gamma_kernel<T>, smem, &smem_allowed);
  if (err != 0) return err;
  gate_gamma_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)r, m, D, h_stride, r_stride, (const T*)P, (const T*)obs_noise,
      (T*)gamma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gate_bounds_f32(const void* H, const void* r, int B, int R, int D,
                               long long h_stride, long long r_stride, const void* P,
                               const void* obs_noise, const void* thresh, void* pass,
                               void* fail, void* stream) {
  return launch_bounds<float>(H, r, B, R, D, h_stride, r_stride, P, obs_noise, thresh, pass,
                              fail, stream);
}

extern "C" int gate_bounds_f64(const void* H, const void* r, int B, int R, int D,
                               long long h_stride, long long r_stride, const void* P,
                               const void* obs_noise, const void* thresh, void* pass,
                               void* fail, void* stream) {
  return launch_bounds<double>(H, r, B, R, D, h_stride, r_stride, P, obs_noise, thresh, pass,
                               fail, stream);
}

extern "C" int gate_gamma_f32(const void* H, const void* r, int B, int m, int D,
                              long long h_stride, long long r_stride, const void* P,
                              const void* obs_noise, void* gamma, void* stream) {
  return launch_gamma<float>(H, r, B, m, D, h_stride, r_stride, P, obs_noise, gamma, stream);
}

extern "C" int gate_gamma_f64(const void* H, const void* r, int B, int m, int D,
                              long long h_stride, long long r_stride, const void* P,
                              const void* obs_noise, void* gamma, void* stream) {
  return launch_gamma<double>(H, r, B, m, D, h_stride, r_stride, P, obs_noise, gamma, stream);
}
