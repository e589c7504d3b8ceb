// K12: the rank-12 EKF update of the camera prune, in push-through form.
//
// Replaces uav_airvision_tpu/models/msckf/update.py::apply_update_rank12
// (:239) up to the error-state injection (which stays in PyTorch, shared
// with the full update).  With B (n x 12) nonzero only in the 12 columns
// ``cols`` of the two pruned cameras, Pc = P[:, cols], P12 = Pc[cols]:
//   W = s2 I + B^T B P12 (not symmetric), [bsr | X] = W^-1 [B^T r | B^T B]
//   by LU with partial pivoting (never inverting P12, which can be exactly
//   singular after an IMU dropout), G = (X + X^T) / 2,
//   delta = Pc bsr, P_new = sym(P - (Pc G) Pc^T).
// Every block solves the small system itself (a few thousand FLOP, the
// same arithmetic in every block, so the same bits) and then writes a band
// of kRows rows of P_new, reading the transposed entries it needs from P:
// one launch, no cross-block step.  Block 0 also writes delta.
//
// Bound on the card: bytes.  P is read and P_new written once (159 KB in
// float32 at D = 141); the work is ~1.2 MFLOP.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows of P_new per block
constexpr int kA = 25;     // augmented row: 12 of W, then B^T r, then 12 of B^T B

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank12_kernel(const T* __restrict__ P, int D, const T* __restrict__ Bm, const T* __restrict__ r,
              int n, const int64_t* __restrict__ cols, const T* __restrict__ obs_noise,
              T* __restrict__ delta, T* __restrict__ P_out) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* Pc = reinterpret_cast<T*>(dyn_smem);  // D x 12
  T* PcG = Pc + D * 12;                     // D x 12
  __shared__ T P12[144], BtB[144], aug[12 * kA], G[144], bsr[12];
  __shared__ int cidx[12], s_piv;
  const int tid = threadIdx.x;

  if (tid < 12) cidx[tid] = (int)cols[tid];
  __syncthreads();
  for (int e = tid; e < D * 12; e += kThreads) Pc[e] = P[(size_t)(e / 12) * D + cidx[e % 12]];
  __syncthreads();
  if (tid < 144) {
    const int a = tid / 12, c = tid % 12;
    P12[tid] = Pc[cidx[a] * 12 + c];
    T acc = T(0);
#pragma unroll 8  // eight rows' reads in flight
    for (int k = 0; k < n; ++k) acc += Bm[k * 12 + a] * Bm[k * 12 + c];
    BtB[tid] = acc;
  } else if (tid < 156) {
    const int a = tid - 144;
    T acc = T(0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) acc += Bm[k * 12 + a] * r[k];
    aug[a * kA + 12] = acc;
  }
  __syncthreads();
  if (tid < 144) {
    const int a = tid / 12, c = tid % 12;
    T w = T(0);
    for (int k = 0; k < 12; ++k) w += BtB[a * 12 + k] * P12[k * 12 + c];
    aug[a * kA + c] = (a == c ? *obs_noise : T(0)) + w;
    aug[a * kA + 13 + c] = BtB[tid];
  }
  __syncthreads();

  // LU with partial pivoting on the augmented rows (getrf's pivot: the
  // first largest |W_ik|), then back substitution, one thread per column
  for (int k = 0; k < 12; ++k) {
    if (tid == 0) {
      int p = k;
      T best = fabs(aug[k * kA + k]);
      for (int i = k + 1; i < 12; ++i) {
        const T v = fabs(aug[i * kA + k]);
        if (v > best) {
          best = v;
          p = i;
        }
      }
      s_piv = p;
    }
    __syncthreads();
    const int p = s_piv;
    if (p != k && tid < kA) {
      const T t = aug[k * kA + tid];
      aug[k * kA + tid] = aug[p * kA + tid];
      aug[p * kA + tid] = t;
    }
    __syncthreads();
    const int w = kA - 1 - k;  // columns k+1 .. kA-1
    for (int e = tid; e < (11 - k) * w; e += kThreads) {
      const int i = k + 1 + e / w, c = k + 1 + e % w;
      aug[i * kA + c] = aug[i * kA + c] - aug[i * kA + k] / aug[k * kA + k] * aug[k * kA + c];
    }
    __syncthreads();
  }
  if (tid < 13) {
    const int c = 12 + tid;
    for (int i = 11; i >= 0; --i) {
      T s = aug[i * kA + c];
      for (int k = i + 1; k < 12; ++k) s -= aug[i * kA + k] * aug[k * kA + c];
      aug[i * kA + c] = s / aug[i * kA + i];
    }
  }
  __syncthreads();
  if (tid < 144) {
    const int a = tid / 12, c = tid % 12;
    G[tid] = (aug[a * kA + 13 + c] + aug[c * kA + 13 + a]) / T(2);
  } else if (tid < 156) {
    bsr[tid - 144] = aug[(tid - 144) * kA + 12];
  }
  __syncthreads();

  for (int e = tid; e < D * 12; e += kThreads) {
    const int i = e / 12, c = e % 12;
    T acc = T(0);
    for (int a = 0; a < 12; ++a) acc += Pc[i * 12 + a] * G[a * 12 + c];
    PcG[e] = acc;
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < D; i += kThreads) {
      T acc = T(0);
      for (int a = 0; a < 12; ++a) acc += Pc[i * 12 + a] * bsr[a];
      delta[i] = acc;
    }
  }
  __syncthreads();

  const int row0 = blockIdx.x * kRows;
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int i = row0 + e / D, j = e % D;
    if (i >= D) break;
    T mij = T(0), mji = T(0);
    for (int c = 0; c < 12; ++c) {
      mij += PcG[i * 12 + c] * Pc[j * 12 + c];
      mji += PcG[j * 12 + c] * Pc[i * 12 + c];
    }
    const T xij = P[(size_t)i * D + j] - mij, xji = P[(size_t)j * D + i] - mji;
    P_out[(size_t)i * D + j] = (xij + xji) / T(2);
  }
}

template <typename T>
int launch(const void* P, int D, const void* Bm, const void* r, int n, const void* cols,
           const void* obs_noise, void* delta, void* P_out, void* stream) {
  static size_t smem_allowed = 0;
  const size_t smem = (size_t)2 * D * 12 * sizeof(T);
  const int err = msckf::allow_smem(rank12_kernel<T>, smem, &smem_allowed);
  if (err != 0) return err;
  rank12_kernel<T><<<(D + kRows - 1) / kRows, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)P, D, (const T*)Bm, (const T*)r, n, (const int64_t*)cols, (const T*)obs_noise,
      (T*)delta, (T*)P_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rank12_f32(const void* P, int D, const void* Bm, const void* r, int n,
                          const void* cols, const void* obs_noise, void* delta, void* P_out,
                          void* stream) {
  return launch<float>(P, D, Bm, r, n, cols, obs_noise, delta, P_out, stream);
}

extern "C" int rank12_f64(const void* P, int D, const void* Bm, const void* r, int n,
                          const void* cols, const void* obs_noise, void* delta, void* P_out,
                          void* stream) {
  return launch<double>(P, D, Bm, r, n, cols, obs_noise, delta, P_out, stream);
}
