// K9: the per-feature measurement block: stereo reprojection Jacobians of
// every observing camera, row compaction, and the three Householder
// reflections that project [H_f | r | H_x] onto the left nullspace of H_f.
// One thread block per feature.
//
// Replaces uav_airvision_tpu/models/msckf/update.py::feature_block (:103)
// with stereo_jacobian_per_cam (:48).  The JAX package builds the
// (4N, 4 + D) tile with one-hot compaction matmuls; here one thread per
// camera slot computes its 4x6 H_x block (OC-EKF projected: A - (A u) u^T /
// (u.u), then H_f = -H_x[:, 3:6] taken after the projection), its 4x3 H_f
// and its residual, scrubs non-finite values to 0, and writes them into the
// rows of its rank among the observing slots, at the columns of its slot.
// The tile lives in dynamic shared memory without the 21 IMU columns,
// which are zero and stay zero: 4N x (4 + 6N) values, 39.7 KB in float32
// and 79.4 KB in float64 at N = 20.  Where it does not fit (N >= 35 in
// float64, N >= 49 in float32) each block keeps its tile in a workspace in
// device memory that the caller allocates (B tiles), where it stays in L2.
// Then the three reflections (sign
// +1 when x[j] >= 0, no reflection when |v|^2 <= 1e-30) run over the tile,
// and the rows 3.. are written out with the IMU columns as zeros.  Rows
// past 4 n_obs hold zeros throughout, so they leave as exact zeros.
//
// Bound on the card: bytes.  A feature writes (4N - 3)(21 + 6N) values
// (43 KB at N = 20 in float32) and does ~0.2 MFLOP.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kImu = 21;  // IMU error-state columns of H_x

// H_x (4x6), H_f (4x3) and r (4) of one stereo observation z of the point
// p_w from window slot s (update.py::stereo_jacobian).
template <typename T>
__device__ void slot_jacobian(const T q[4], const T cp[3], const T qn[4], const T cpn[3],
                              const T p[3], const T z[4], const T g[3], const T Rc[9],
                              const T tc[3], T Hx[24], T Hf[12], T r[4]) {
  T R0[9], R1[9], t1[3], pc0[3], pc1[3];
  msckf::to_rotation(q, R0);  // world -> cam0
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R1[3 * i + j] = Rc[3 * i] * R0[j] + Rc[3 * i + 1] * R0[3 + j] + Rc[3 * i + 2] * R0[6 + j];
  for (int i = 0; i < 3; ++i)
    t1[i] = cp[i] - (R1[i] * tc[0] + R1[3 + i] * tc[1] + R1[6 + i] * tc[2]);
  const T d0[3] = {p[0] - cp[0], p[1] - cp[1], p[2] - cp[2]};
  const T d1[3] = {p[0] - t1[0], p[1] - t1[1], p[2] - t1[2]};
  for (int i = 0; i < 3; ++i) {
    pc0[i] = R0[3 * i] * d0[0] + R0[3 * i + 1] * d0[1] + R0[3 * i + 2] * d0[2];
    pc1[i] = R1[3 * i] * d1[0] + R1[3 * i + 1] * d1[1] + R1[3 * i + 2] * d1[2];
  }
  const T iz0 = T(1) / pc0[2], iz1 = T(1) / pc1[2];
  // d z / d p_c: rows 0-1 from cam0, rows 2-3 from cam1
  const T dz[4][3] = {{iz0, T(0), -pc0[0] * iz0 * iz0},
                      {T(0), iz0, -pc0[1] * iz0 * iz0},
                      {iz1, T(0), -pc1[0] * iz1 * iz1},
                      {T(0), iz1, -pc1[1] * iz1 * iz1}};
  // d p_c / d x_cam = [skew(p_c0) | -R] for cam0, [R_c0c1 skew(p_c0) | -R1] for cam1
  const T sk[9] = {T(0), -pc0[2], pc0[1], pc0[2], T(0), -pc0[0], -pc0[1], pc0[0], T(0)};
  T dp0[3][6], dp1[3][6];
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 3; ++c) {
      dp0[i][c] = sk[3 * i + c];
      dp0[i][3 + c] = -R0[3 * i + c];
      dp1[i][c] = Rc[3 * i] * sk[c] + Rc[3 * i + 1] * sk[3 + c] + Rc[3 * i + 2] * sk[6 + c];
      dp1[i][3 + c] = -R1[3 * i + c];
    }
  T A[4][6];
  for (int i = 0; i < 4; ++i)
    for (int c = 0; c < 6; ++c) {
      const T(*dp)[6] = i < 2 ? dp0 : dp1;
      A[i][c] = dz[i][0] * dp[0][c] + dz[i][1] * dp[1][c] + dz[i][2] * dp[2][c];
    }
  // OC-EKF: u = [R(q_null) g, skew(p - p_null) g]
  T Rn[9], u[6];
  msckf::to_rotation(qn, Rn);
  for (int i = 0; i < 3; ++i) u[i] = Rn[3 * i] * g[0] + Rn[3 * i + 1] * g[1] + Rn[3 * i + 2] * g[2];
  const T dn[3] = {p[0] - cpn[0], p[1] - cpn[1], p[2] - cpn[2]};
  u[3] = -dn[2] * g[1] + dn[1] * g[2];
  u[4] = dn[2] * g[0] - dn[0] * g[2];
  u[5] = -dn[1] * g[0] + dn[0] * g[1];
  T uu = T(0);
  for (int c = 0; c < 6; ++c) uu += u[c] * u[c];
  for (int i = 0; i < 4; ++i) {
    T au = T(0);
    for (int c = 0; c < 6; ++c) au += A[i][c] * u[c];
    for (int c = 0; c < 6; ++c) Hx[6 * i + c] = A[i][c] - au * u[c] / uu;
    for (int c = 0; c < 3; ++c) Hf[3 * i + c] = -Hx[6 * i + 3 + c];
  }
  const T pred[4] = {pc0[0] * iz0, pc0[1] * iz0, pc1[0] * iz1, pc1[1] * iz1};
  for (int i = 0; i < 4; ++i) r[i] = z[i] - pred[i];
}

template <typename T>
__device__ inline T finite_or_zero(T v) {
  return isfinite(v) ? v : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_block_kernel(const T* __restrict__ cams_q, const T* __restrict__ cams_p,
                     const T* __restrict__ cams_qn, const T* __restrict__ cams_pn, int N,
                     const T* __restrict__ obs, const uint8_t* __restrict__ obs_mask,
                     const T* __restrict__ p_w, const T* __restrict__ gravity,
                     const T* __restrict__ R_c0c1, const T* __restrict__ t_c0c1,
                     T* __restrict__ H_out, T* __restrict__ r_out, int* __restrict__ rows_out,
                     T* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int R = 4 * N, W = 4 + 6 * N, D = kImu + 6 * N;
  // R x W: [H_f | r | H_x of the slots], in shared memory or the workspace
  T* tile = work != nullptr ? work + (size_t)b * R * W : reinterpret_cast<T*>(dyn_smem);
  T* v = (work != nullptr ? reinterpret_cast<T*>(dyn_smem) : tile + R * W);  // R
  T* vT = v + R;                              // W
  T* red = vT + W;                            // 32
  int* rank = reinterpret_cast<int*>(red + 32);  // N
  __shared__ int s_nobs;

  const uint8_t* m_b = obs_mask + (size_t)b * N;
  for (int e = tid; e < R * W; e += kThreads) tile[e] = T(0);
  if (tid == 0) {
    int c = 0;
    for (int s = 0; s < N; ++s) rank[s] = m_b[s] ? c++ : -1;
    s_nobs = c;
  }
  __syncthreads();

  for (int s = tid; s < N; s += kThreads) {
    if (rank[s] < 0) continue;
    T Hx[24], Hf[12], r[4];
    slot_jacobian(cams_q + 4 * s, cams_p + 3 * s, cams_qn + 4 * s, cams_pn + 3 * s,
                  p_w + 3 * b, obs + ((size_t)b * N + s) * 4, gravity, R_c0c1, t_c0c1, Hx, Hf,
                  r);
    for (int i = 0; i < 4; ++i) {
      T* row = tile + (4 * rank[s] + i) * W;
      for (int c = 0; c < 3; ++c) row[c] = finite_or_zero(Hf[3 * i + c]);
      row[3] = finite_or_zero(r[i]);
      for (int c = 0; c < 6; ++c) row[4 + 6 * s + c] = finite_or_zero(Hx[6 * i + c]);
    }
  }
  __syncthreads();

  // three Householder reflections on the tile's first three columns
  for (int j = 0; j < 3; ++j) {
    T part = T(0);
    for (int r = tid; r < R; r += kThreads) {
      const T x = r >= j ? tile[r * W + j] : T(0);
      v[r] = x;
      part += x * x;
    }
    const T normx = sqrt(msckf::block_sum(part, red));
    if (tid == 0) {
      const T sign = v[j] >= T(0) ? T(1) : T(-1);
      v[j] = v[j] + sign * normx;
    }
    __syncthreads();
    part = T(0);
    for (int r = tid; r < R; r += kThreads) part += v[r] * v[r];
    const T vnorm2 = msckf::block_sum(part, red);
    const T scale = vnorm2 > T(1e-30) ? T(2) / vnorm2 : T(0);
    for (int c = tid; c < W; c += kThreads) {
      T acc = T(0);
      for (int r = j; r < R; ++r) acc += v[r] * tile[r * W + c];
      vT[c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < R * W; e += kThreads)
      tile[e] = tile[e] - scale * (v[e / W] * vT[e % W]);
    __syncthreads();
  }

  // rows 3.. : H_proj (IMU columns zero) and r_proj
  const size_t out_rows = (size_t)R - 3;
  T* H_b = H_out + (size_t)b * out_rows * D;
  for (int e = tid; e < (int)out_rows * D; e += kThreads) {
    const int i = e / D, c = e % D;
    H_b[e] = c < kImu ? T(0) : tile[(i + 3) * W + 4 + (c - kImu)];
  }
  for (int i = tid; i < (int)out_rows; i += kThreads) r_out[(size_t)b * out_rows + i] = tile[(i + 3) * W + 3];
  if (tid == 0) rows_out[b] = 4 * s_nobs - 3;
}

template <typename T>
int launch(const void* cams_q, const void* cams_p, const void* cams_qn, const void* cams_pn,
           int N, const void* obs, const void* obs_mask, const void* p_w, const void* gravity,
           const void* R_c0c1, const void* t_c0c1, int B, void* H_out, void* r_out,
           void* rows_out, void* work, void* stream) {
  static size_t smem_allowed = 0, budget = 0;
  if (N < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (budget == 0) budget = msckf::smem_budget(feature_block_kernel<T>);
  const int R = 4 * N, W = 4 + 6 * N;
  const size_t scratch = (size_t)(R + W + 32) * sizeof(T) + (size_t)N * sizeof(int);
  size_t smem = (size_t)R * W * sizeof(T) + scratch;
  if (smem > budget) {  // the tiles go to the workspace
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    smem = scratch;
  } else {
    work = nullptr;
  }
  const int err = msckf::allow_smem(feature_block_kernel<T>, smem, &smem_allowed);
  if (err != 0) return err;
  feature_block_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)cams_q, (const T*)cams_p, (const T*)cams_qn, (const T*)cams_pn, N,
      (const T*)obs, (const uint8_t*)obs_mask, (const T*)p_w, (const T*)gravity,
      (const T*)R_c0c1, (const T*)t_c0c1, (T*)H_out, (T*)r_out, (int*)rows_out, (T*)work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int feature_block_f32(const void* cams_q, const void* cams_p, const void* cams_qn,
                                 const void* cams_pn, int N, const void* obs,
                                 const void* obs_mask, const void* p_w, const void* gravity,
                                 const void* R_c0c1, const void* t_c0c1, int B, void* H_out,
                                 void* r_out, void* rows_out, void* work, void* stream) {
  return launch<float>(cams_q, cams_p, cams_qn, cams_pn, N, obs, obs_mask, p_w, gravity,
                       R_c0c1, t_c0c1, B, H_out, r_out, rows_out, work, stream);
}

extern "C" int feature_block_f64(const void* cams_q, const void* cams_p, const void* cams_qn,
                                 const void* cams_pn, int N, const void* obs,
                                 const void* obs_mask, const void* p_w, const void* gravity,
                                 const void* R_c0c1, const void* t_c0c1, int B, void* H_out,
                                 void* r_out, void* rows_out, void* work, void* stream) {
  return launch<double>(cams_q, cams_p, cams_qn, cams_pn, N, obs, obs_mask, p_w, gravity,
                        R_c0c1, t_c0c1, B, H_out, r_out, rows_out, work, stream);
}
