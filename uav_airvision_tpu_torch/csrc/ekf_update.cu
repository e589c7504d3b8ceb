// K11: the EKF measurement update from the stacked Jacobian.
//
// Replaces uav_airvision_tpu/models/msckf/update.py::apply_update (:296) up
// to the error-state injection (which stays in PyTorch, shared with the
// rank-12 update).  For H (m x D), r (m), P (D x D) and s2:
//   HP = H P,  S = HP H' + s2 I,  S = L L' (Cholesky of the lower triangle),
//   X = S^-1 HP (= K'),  delta = X' r,  P_new = sym(P - (X' H) P),
// the non-Joseph form the reference keeps.  ``ekf_qr`` first compresses a
// taller stack [H | r] (n x (D + 1)) by Householder reflections to R (D x D)
// and the first D entries of Q' r; X' H and X' r do not depend on the signs
// of R's rows, so no sign convention is matched.
//
// S at m = 2 D = 282 rows is 318 KB in float32 and 636 KB in float64, more
// than a block's 227 KB of shared memory, so the update is a chain of
// launches on one stream over global memory (P, S and the work arrays stay
// in L2):
//   1. HPt = P' H' (D x m), tiled product;
//   2. F = HPt' H' + s2 I (m x m), tiled product;
//   3. Cholesky in place, one block, a thread per row, left-looking by
//      column; L is written into both triangles of F (F[i][j] = F[j][i] =
//      L[i][j]) so that every later read runs along a row;
//   4. forward and backward substitution, a warp per column of HP with the
//      column in shared memory, lanes splitting each row's dot product;
//      the warp also leaves delta[c] = X[:, c]' r;
//   5. KH = X' H (D x D), tiled product;
//   6. P_new[i][j] = ((P - KH P)[i][j] + (P - KH P)[j][i]) / 2.
// Zero padding rows of H stay exact zeros: their row of HP is 0, their row
// of S is s2 e_i, so L has sqrt(s2) on the diagonal and zeros beside it, and
// their row of X is 0 / sqrt(s2).  A pivot that is not > 0 becomes NaN (no
// clamp) and reaches every entry of delta and P_new, as the plain version's
// failed factorisation does.
//
// Bound on the card: operations (2 m D^2 + 2 m^2 D + m^3 / 3 + 2 m^2 D +
// 2 m D^2 + 2 D^3, ~76 MFLOP at m = 282; ~1.2 us at the float32 rate)
// against 0.16 MB of P in and out.  The time is the Cholesky's and the
// substitutions' chains of dependent steps, not the FLOPs.

#include <cuda_runtime.h>
#include <math.h>

#include "msckf_common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kSolveWarps = 4;
constexpr int kQrThreads = 1024;

// C[i][j] = sum_k A(i, k) B(k, j) (+ *diag_add on the diagonal), row-major,
// A(i, k) = TA ? A[k lda + i] : A[i lda + k] and B likewise
template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(kTile* kTile)
gemm_kernel(int M, int N, int K, const T* __restrict__ A, int lda, const T* __restrict__ B,
            int ldb, T* __restrict__ C, int ldc, const T* __restrict__ diag_add) {
  __shared__ T As[kTile][kTile + 1], Bs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * kTile + ty, j = blockIdx.x * kTile + tx;
  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += kTile) {
    {  // As[ty][tx] = A(i0 + ty, k0 + tx), Bs[ty][tx] = B(k0 + ty, j0 + tx)
      const int ai = blockIdx.y * kTile + (TA ? tx : ty), ak = k0 + (TA ? ty : tx);
      const T a = (ai < M && ak < K) ? (TA ? A[(size_t)ak * lda + ai] : A[(size_t)ai * lda + ak])
                                     : T(0);
      if (TA) As[tx][ty] = a; else As[ty][tx] = a;
      const int bk = k0 + (TB ? tx : ty), bj = blockIdx.x * kTile + (TB ? ty : tx);
      const T b = (bk < K && bj < N) ? (TB ? B[(size_t)bj * ldb + bk] : B[(size_t)bk * ldb + bj])
                                     : T(0);
      if (TB) Bs[tx][ty] = b; else Bs[ty][tx] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc += As[ty][kk] * Bs[kk][tx];
    __syncthreads();
  }
  if (i < M && j < N) {
    if (diag_add != nullptr && i == j) acc += *diag_add;
    C[(size_t)i * ldc + j] = acc;
  }
}

template <typename T, bool TA, bool TB>
int gemm(int M, int N, int K, const T* A, int lda, const T* B, int ldb, T* C, int ldc,
         const T* diag_add, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile), block(kTile, kTile);
  gemm_kernel<T, TA, TB><<<grid, block, 0, stream>>>(M, N, K, A, lda, B, ldb, C, ldc, diag_add);
  return (int)cudaGetLastError();
}

// In-place Cholesky of the lower triangle of F (m x m), thread i owning row
// i.  Column j: s_i = F[i][j] - sum_{k<j} L[i][k] L[j][k], read as
// F[k][i] F[k][j] from the rows already written; L[j][j] = sqrt(s_j),
// L[i][j] = s_i / L[j][j], stored at F[i][j] and F[j][i].
template <typename T>
__global__ void __launch_bounds__(1024)
cholesky_kernel(T* __restrict__ F, int m) {
  __shared__ T s_diag;
  const int i = threadIdx.x;
  for (int j = 0; j < m; ++j) {
    T s = T(0);
    if (i >= j && i < m) {
      s = F[(size_t)i * m + j];
      int k = 0;
      for (; k + 4 <= j; k += 4) {  // four independent products in flight
        const T a0 = F[(size_t)k * m + i] * F[(size_t)k * m + j];
        const T a1 = F[(size_t)(k + 1) * m + i] * F[(size_t)(k + 1) * m + j];
        const T a2 = F[(size_t)(k + 2) * m + i] * F[(size_t)(k + 2) * m + j];
        const T a3 = F[(size_t)(k + 3) * m + i] * F[(size_t)(k + 3) * m + j];
        s -= (a0 + a1) + (a2 + a3);
      }
      for (; k < j; ++k) s -= F[(size_t)k * m + i] * F[(size_t)k * m + j];
      if (i == j) s_diag = s > T(0) ? sqrt(s) : T(NAN);
    }
    __syncthreads();
    if (i >= j && i < m) {
      const T d = s_diag;
      const T l = (i == j) ? d : s / d;
      F[(size_t)j * m + i] = l;
      F[(size_t)i * m + j] = l;
    }
    __syncthreads();
  }
}

// Warp w solves S x = b for column c of HP: b = HPt[c], L y = b down the
// rows, L' x = y back up, both reading row i of F.  Leaves Xt[c] = x and
// delta[c] = x' r.
template <typename T>
__global__ void __launch_bounds__(kSolveWarps * 32)
solve_kernel(const T* __restrict__ F, int m, const T* __restrict__ HPt, int D,
             const T* __restrict__ r, T* __restrict__ Xt, T* __restrict__ delta) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kSolveWarps + warp;
  if (c >= D) return;  // whole warps leave; only __syncwarp below
  T* y = reinterpret_cast<T*>(dyn_smem) + (size_t)warp * m;
  for (int i = lane; i < m; i += 32) y[i] = HPt[(size_t)c * m + i];
  __syncwarp();
  for (int i = 0; i < m; ++i) {
    const T* row = F + (size_t)i * m;
    T acc = T(0);
    for (int k = lane; k < i; k += 32) acc += row[k] * y[k];
    acc = msckf::warp_sum(acc);
    if (lane == 0) y[i] = (y[i] - acc) / row[i];
    __syncwarp();
  }
  for (int i = m - 1; i >= 0; --i) {
    const T* row = F + (size_t)i * m;
    T acc = T(0);
    for (int k = i + 1 + lane; k < m; k += 32) acc += row[k] * y[k];
    acc = msckf::warp_sum(acc);
    if (lane == 0) y[i] = (y[i] - acc) / row[i];
    __syncwarp();
  }
  T dot = T(0);
  for (int i = lane; i < m; i += 32) {
    Xt[(size_t)c * m + i] = y[i];
    dot += y[i] * r[i];
  }
  dot = msckf::warp_sum(dot);
  if (lane == 0) delta[c] = dot;
}

// P_out = sym(P - KH P): each thread forms entry (i, j) and its mirror
template <typename T>
__global__ void __launch_bounds__(kTile* kTile)
covariance_kernel(const T* __restrict__ P, const T* __restrict__ KH, int D,
                  T* __restrict__ P_out) {
  const int i = blockIdx.y * kTile + threadIdx.y, j = blockIdx.x * kTile + threadIdx.x;
  if (i >= D || j >= D) return;
  T mij = T(0), mji = T(0);
  for (int k = 0; k < D; ++k) {
    mij += KH[(size_t)i * D + k] * P[(size_t)k * D + j];
    mji += KH[(size_t)j * D + k] * P[(size_t)k * D + i];
  }
  const T xij = P[(size_t)i * D + j] - mij, xji = P[(size_t)j * D + i] - mji;
  P_out[(size_t)i * D + j] = (xij + xji) / T(2);
}

template <typename T>
int update(const void* P_, int D, const void* H_, const void* r_, int m, const void* noise_,
           void* work_, void* delta_, void* P_out_, void* stream_) {
  if (D < 1 || m < 1 || m > 1024) return (int)cudaErrorInvalidValue;
  const T *P = (const T*)P_, *H = (const T*)H_, *r = (const T*)r_, *noise = (const T*)noise_;
  T* HPt = (T*)work_;            // D x m
  T* F = HPt + (size_t)D * m;    // m x m
  T* Xt = F + (size_t)m * m;     // D x m
  T* KH = Xt + (size_t)D * m;    // D x D
  cudaStream_t stream = (cudaStream_t)stream_;
  int err = gemm<T, true, true>(D, m, D, P, D, H, D, HPt, m, nullptr, stream);
  if (err != 0) return err;
  err = gemm<T, true, true>(m, m, D, HPt, m, H, D, F, m, noise, stream);
  if (err != 0) return err;
  cholesky_kernel<T><<<1, (m + 31) / 32 * 32, 0, stream>>>(F, m);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  static size_t smem_allowed = 0;
  const size_t smem = (size_t)kSolveWarps * m * sizeof(T);
  if ((err = msckf::allow_smem(solve_kernel<T>, smem, &smem_allowed)) != 0) return err;
  solve_kernel<T><<<(D + kSolveWarps - 1) / kSolveWarps, kSolveWarps * 32, smem, stream>>>(
      F, m, HPt, D, r, Xt, (T*)delta_);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  err = gemm<T, false, false>(D, D, m, Xt, m, H, D, KH, D, nullptr, stream);
  if (err != 0) return err;
  const dim3 grid((D + kTile - 1) / kTile, (D + kTile - 1) / kTile), block(kTile, kTile);
  covariance_kernel<T><<<grid, block, 0, stream>>>(P, KH, D, (T*)P_out_);
  return (int)cudaGetLastError();
}

// A = [H | r], n x (D + 1)
template <typename T>
__global__ void qr_stack_kernel(const T* __restrict__ H, const T* __restrict__ r, int n, int D,
                                T* __restrict__ A) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)n * (D + 1)) return;
  const int i = (int)(e / (D + 1)), c = (int)(e % (D + 1));
  A[e] = c < D ? H[(size_t)i * D + c] : r[i];
}

// Householder reflections down the D columns of A (n x C, C = D + 1, n >= D),
// one block: the warps split the rows, the lanes the columns right of j.
template <typename T>
__global__ void __launch_bounds__(kQrThreads)
householder_kernel(T* __restrict__ A, int n, int D) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int C = D + 1;
  T* v = reinterpret_cast<T*>(dyn_smem);  // n
  T* part = v + n;                        // 32 x C
  T* wsum = part + 32 * C;                // C
  T* scratch = wsum + C;                  // 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < D; ++j) {
    const int rows = n - j, cols = C - j - 1;
    T sq = T(0);
    for (int q = tid; q < rows; q += kQrThreads) {
      const T x = A[(size_t)(j + q) * C + j];
      v[q] = x;
      sq += x * x;
    }
    const T norm2 = msckf::block_sum(sq, scratch);  // its barriers publish v
    const T x0 = v[0], normx = sqrt(norm2);
    const T sign = x0 >= T(0) ? T(1) : T(-1);
    // v = x + sign |x| e_0;  v'v = 2 |x| (|x| + |x_0|), without cancellation
    const T vnorm2 = T(2) * normx * (normx + fabs(x0));
    const T scale = vnorm2 > T(1e-30) ? T(2) / vnorm2 : T(0);
    __syncthreads();  // every thread has read x0
    if (tid == 0) {
      v[0] = x0 + sign * normx;
      A[(size_t)j * C + j] = -sign * normx;
    }
    __syncthreads();
    if (scale == T(0)) continue;  // a zero column: no reflection (uniform branch)
    for (int cb = 0; cb < cols; cb += 32) {
      const int c = cb + lane;
      T acc = T(0);
      if (c < cols)
        for (int q = warp; q < rows; q += 32) acc += v[q] * A[(size_t)(j + q) * C + j + 1 + c];
      if (c < cols) part[warp * C + c] = acc;
    }
    __syncthreads();
    for (int c = tid; c < cols; c += kQrThreads) {
      T s = T(0);
      for (int w = 0; w < 32; ++w) s += part[w * C + c];
      wsum[c] = s;
    }
    __syncthreads();
    for (int cb = 0; cb < cols; cb += 32) {
      const int c = cb + lane;
      if (c < cols) {
        const T wc = wsum[c];
        for (int q = warp; q < rows; q += 32) {
          T* a = A + (size_t)(j + q) * C + j + 1 + c;
          *a = *a - scale * v[q] * wc;
        }
      }
    }
    __syncthreads();
  }
}

// R = the upper triangle of A's first D rows, qtr = their last column
template <typename T>
__global__ void qr_extract_kernel(const T* __restrict__ A, int D, T* __restrict__ R,
                                  T* __restrict__ qtr) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= D * D) return;
  const int i = e / D, j = e % D;
  R[e] = j >= i ? A[(size_t)i * (D + 1) + j] : T(0);
  if (j == 0) qtr[i] = A[(size_t)i * (D + 1) + D];
}

template <typename T>
int qr(const void* H, const void* r, int n, int D, void* work, void* R, void* qtr,
       void* stream_) {
  if (D < 1 || n < D) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  T* A = (T*)work;
  const size_t total = (size_t)n * (D + 1);
  qr_stack_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const T*)H, (const T*)r, n, D, A);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  static size_t smem_allowed = 0;
  const size_t smem = ((size_t)n + 33 * (D + 1) + 32) * sizeof(T);
  if ((err = msckf::allow_smem(householder_kernel<T>, smem, &smem_allowed)) != 0) return err;
  householder_kernel<T><<<1, kQrThreads, smem, stream>>>(A, n, D);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  qr_extract_kernel<T><<<(D * D + 255) / 256, 256, 0, stream>>>(A, D, (T*)R, (T*)qtr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ekf_update_f32(const void* P, int D, const void* H, const void* r, int m,
                              const void* obs_noise, void* work, void* delta, void* P_out,
                              void* stream) {
  return update<float>(P, D, H, r, m, obs_noise, work, delta, P_out, stream);
}

extern "C" int ekf_update_f64(const void* P, int D, const void* H, const void* r, int m,
                              const void* obs_noise, void* work, void* delta, void* P_out,
                              void* stream) {
  return update<double>(P, D, H, r, m, obs_noise, work, delta, P_out, stream);
}

extern "C" int ekf_qr_f32(const void* H, const void* r, int n, int D, void* work, void* R,
                          void* qtr, void* stream) {
  return qr<float>(H, r, n, D, work, R, qtr, stream);
}

extern "C" int ekf_qr_f64(const void* H, const void* r, int n, int D, void* work, void* R,
                          void* qtr, void* stream) {
  return qr<double>(H, r, n, D, work, R, qtr, stream);
}
