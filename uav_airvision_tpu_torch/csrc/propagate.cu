// K14: IMU propagation of the MSCKF state and covariance, one thread block.
//
// Replaces uav_airvision_tpu/models/msckf/propagation.py::propagate (with
// _omega_mat :67; the PROP_TIER slicing of propagate_tiered :36 is a
// TPU work-size tier whose result is identical, so it has no counterpart).
// The JAX package batches the per-sample work over the padded (64,) IMU
// slice and composes with log-depth scans; here one block walks the valid
// samples in order:
//   thread 0: the closed-form quaternion integrator (full and RK4-midpoint
//     steps), RK4 velocity/position, the OC-EKF anchors (the incoming
//     anchors for the first sample, the previous sample's state after it);
//   all threads: the 21x21 transition Phi = I + F dt + (F dt)^2/2 +
//     (F dt)^3/6 with the OC-EKF constraint rows, the noise
//     Q = Phi G diag(qc) G^T Phi^T dt, and the composition
//     (Phi_tot, Q_tot) <- (Phi Phi_tot, Phi Q_tot Phi^T + Q);
//   then P_ii = Phi P_ii Phi^T + Q, P_ic = Phi P_ic and the symmetrization
//   (P + P^T) / 2 of the whole covariance, written to a new buffer.
// Masked samples are the identity (Phi = I, Q = 0) and are skipped; the
// sequential composition rounds in another order than the JAX pairwise
// fold, which is exact in real arithmetic.
//
// Bound on the card: latency.  ~11 samples x ~10 barrier-separated 21x21
// steps; the covariance pass reads and writes 141x141 values once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "msckf_common.cuh"

namespace {

constexpr int kD = 21;  // IMU error-state dimension
constexpr int kThreads = 512;

using msckf::quat_normalize;
using msckf::to_rotation;

// _omega_mat: q(t+dt) = M q(t) for gyro g over half_dt.
template <typename T>
__device__ void omega_mat(const T g[3], T half_dt, T M[16]) {
  const T n = sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  // Omega = [[-skew(g), g], [-g^T, 0]]
  const T Om[16] = {T(0), g[2], -g[1], g[0],  -g[2], T(0), g[0], g[1],
                    g[1], -g[0], T(0), g[2],  -g[0], -g[1], -g[2], T(0)};
  const T c = cos(n * half_dt);
  if (n > T(1e-5)) {
    const T s = sin(n * half_dt) / n;
    for (int k = 0; k < 16; ++k) M[k] = c * ((k % 5 == 0) ? T(1) : T(0)) + s * Om[k];
  } else {
    for (int k = 0; k < 16; ++k) M[k] = c * (((k % 5 == 0) ? T(1) : T(0)) + Om[k] * half_dt);
  }
}

template <typename T>
__device__ void mat4vec(const T M[16], const T v[4], T out[4]) {
  for (int i = 0; i < 4; ++i)
    out[i] = M[4 * i] * v[0] + M[4 * i + 1] * v[1] + M[4 * i + 2] * v[2] + M[4 * i + 3] * v[3];
}

template <typename T>
__device__ void rt_mul(const T R[9], const T a[3], const T g[3], T out[3]) {
  // R^T a + g
  for (int i = 0; i < 3; ++i) out[i] = (R[i] * a[0] + R[3 + i] * a[1] + R[6 + i] * a[2]) + g[i];
}

template <typename T>
__device__ void skew_mul(const T v[3], const T g[3], T out[3]) {
  // skew(v) @ g = v x g
  out[0] = -v[2] * g[1] + v[1] * g[2];
  out[1] = v[2] * g[0] - v[0] * g[2];
  out[2] = -v[1] * g[0] + v[0] * g[1];
}

// C = A @ B for 21x21 row-major matrices in shared memory (all threads).
template <typename T>
__device__ void matmul21(const T* A, const T* B, T* C, bool transpose_b) {
  for (int e = threadIdx.x; e < kD * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    T acc = T(0);
    for (int k = 0; k < kD; ++k)
      acc += A[r * kD + k] * (transpose_b ? B[c * kD + k] : B[k * kD + c]);
    C[e] = acc;
  }
}

template <typename T>
struct Sample {
  T dt;
  T skg[9];   // skew(gyro)
  T RtSa[9];  // R_at^T skew(acc)
  T Rt[9];    // R_at^T
  T Phi00[9]; // R(q_next) R(q_null)^T
  T u[3], s[3], w1[3], w2[3];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
propagate_kernel(const T* __restrict__ imu_t, const T* __restrict__ imu_w,
                 const T* __restrict__ imu_a, const uint8_t* __restrict__ imu_mask,
                 int I, const T* __restrict__ st, const T* __restrict__ qc,
                 const T* __restrict__ cov, int D, T* __restrict__ out,
                 T* __restrict__ cov_out) {
  // state_in layout: q 0..3, p 4..6, v 7..9, bg 10..12, ba 13..15,
  // q_null 16..19, p_null 20..22, v_null 23..25, timestamp 26, gravity 27..29
  // state_out layout: q 0..3, v 4..6, p 7..9, timestamp 10, q_null 11..14,
  // v_null 15..17, p_null 18..20
  __shared__ T s_phi_tot[kD * kD], s_q_tot[kD * kD];
  __shared__ T s_a[kD * kD], s_b[kD * kD], s_c[kD * kD], s_phi[kD * kD];
  __shared__ T s_phig[kD * 12];
  __shared__ Sample<T> smp;
  __shared__ T s_corr[6];
  __shared__ int s_n_valid;

  const int tid = threadIdx.x;
  for (int e = tid; e < kD * kD; e += kThreads) {
    s_phi_tot[e] = (e / kD == e % kD) ? T(1) : T(0);
    s_q_tot[e] = T(0);
  }
  // running state, thread 0 only
  T q_run[4], v_run[3], p_run[3], rec[11];
  const T* g = st + 27;
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < I; ++i) n += imu_mask[i] ? 1 : 0;
    s_n_valid = n;
    for (int k = 0; k < 4; ++k) q_run[k] = st[k];
    for (int k = 0; k < 3; ++k) {
      p_run[k] = st[4 + k];
      v_run[k] = st[7 + k];
    }
  }
  __syncthreads();
  const int n_valid = s_n_valid;
  const int last = n_valid > 0 ? n_valid - 1 : 0;

  for (int i = 0; i < I; ++i) {
    const bool m = imu_mask[i] != 0;
    if (tid == 0) {
      if (m) {
        const T t_prev = i == 0 ? st[26] : imu_t[i - 1];
        const T dt = imu_t[i] - t_prev;
        T gyro[3], acc[3];
        for (int k = 0; k < 3; ++k) {
          gyro[k] = imu_w[3 * i + k] - st[10 + k];
          acc[k] = imu_a[3 * i + k] - st[13 + k];
        }
        T Mf[16], Mh[16], q_at[4], q_next[4], dqf[4], dqh[4];
        omega_mat(gyro, dt * T(0.5), Mf);
        omega_mat(gyro, dt * T(0.25), Mh);
        for (int k = 0; k < 4; ++k) q_at[k] = q_run[k];
        mat4vec(Mf, q_at, dqf);
        mat4vec(Mh, q_at, dqh);
        for (int k = 0; k < 4; ++k) q_next[k] = dqf[k];
        quat_normalize(q_next);
        T R_at[9], R_h[9], R_f[9], k1[3], k2[3], k4[3];
        to_rotation(q_at, R_at);
        to_rotation(dqh, R_h);
        to_rotation(dqf, R_f);
        rt_mul(R_at, acc, g, k1);
        rt_mul(R_h, acc, g, k2);
        rt_mul(R_f, acc, g, k4);
        T v_next[3], p_next[3];
        for (int k = 0; k < 3; ++k) {
          const T dv = (k1[k] + T(4) * k2[k] + k4[k]) * (dt / T(6));
          const T dp = v_run[k] * dt + (k1[k] + T(2) * k2[k]) * (dt * dt / T(6));
          v_next[k] = v_run[k] + dv;
          p_next[k] = p_run[k] + dp;
        }
        // OC-EKF anchors: incoming anchors for the first sample, else the
        // state after the previous sample
        T qn[4], vn[3], pn[3];
        for (int k = 0; k < 4; ++k) qn[k] = i == 0 ? st[16 + k] : q_run[k];
        for (int k = 0; k < 3; ++k) {
          pn[k] = i == 0 ? st[20 + k] : p_run[k];
          vn[k] = i == 0 ? st[23 + k] : v_run[k];
        }
        T R_null[9], R_next[9];
        to_rotation(qn, R_null);
        to_rotation(q_next, R_next);
        smp.dt = dt;
        const T sk[9] = {T(0), -gyro[2], gyro[1], gyro[2], T(0), -gyro[0], -gyro[1], gyro[0], T(0)};
        const T sa[9] = {T(0), -acc[2], acc[1], acc[2], T(0), -acc[0], -acc[1], acc[0], T(0)};
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) {
            smp.skg[3 * r + c] = sk[3 * r + c];
            smp.Rt[3 * r + c] = R_at[3 * c + r];
            T a = T(0), b = T(0);
            for (int k = 0; k < 3; ++k) {
              a += R_at[3 * k + r] * sa[3 * k + c];
              b += R_next[3 * r + k] * R_null[3 * c + k];
            }
            smp.RtSa[3 * r + c] = a;
            smp.Phi00[3 * r + c] = b;
          }
        T uu = T(0);
        for (int r = 0; r < 3; ++r) {
          smp.u[r] = R_null[3 * r] * g[0] + R_null[3 * r + 1] * g[1] + R_null[3 * r + 2] * g[2];
          uu += smp.u[r] * smp.u[r];
        }
        for (int r = 0; r < 3; ++r) smp.s[r] = smp.u[r] / uu;
        T d1[3], d2[3];
        for (int k = 0; k < 3; ++k) {
          d1[k] = vn[k] - v_next[k];
          d2[k] = dt * vn[k] + pn[k] - p_next[k];
        }
        skew_mul(d1, g, smp.w1);
        skew_mul(d2, g, smp.w2);
        for (int k = 0; k < 4; ++k) q_run[k] = q_next[k];
        for (int k = 0; k < 3; ++k) {
          v_run[k] = v_next[k];
          p_run[k] = p_next[k];
        }
      } else {
        quat_normalize(q_run);  // a masked slot repeats the normalized state
      }
      if (i == last) {
        for (int k = 0; k < 4; ++k) rec[k] = q_run[k];
        for (int k = 0; k < 3; ++k) {
          rec[4 + k] = v_run[k];
          rec[7 + k] = p_run[k];
        }
        rec[10] = imu_t[i];
      }
    }
    if (!m) continue;  // uniform across the block
    __syncthreads();

    // Fdt = F * dt (s_a)
    const T dt = smp.dt;
    for (int e = tid; e < kD * kD; e += kThreads) {
      const int r = e / kD, c = e % kD;
      T f = T(0);
      if (r < 3 && c < 3) f = -smp.skg[3 * r + c];
      else if (r < 3 && c >= 3 && c < 6) f = (r == c - 3) ? T(-1) : T(0);
      else if (r >= 6 && r < 9 && c < 3) f = -smp.RtSa[3 * (r - 6) + c];
      else if (r >= 6 && r < 9 && c >= 9 && c < 12) f = -smp.Rt[3 * (r - 6) + (c - 9)];
      else if (r >= 12 && r < 15 && c >= 6 && c < 9) f = (r - 12 == c - 6) ? T(1) : T(0);
      s_a[e] = f * dt;
    }
    __syncthreads();
    matmul21(s_a, s_a, s_b, false);  // Fdt^2
    __syncthreads();
    matmul21(s_b, s_a, s_c, false);  // Fdt^3
    __syncthreads();
    for (int e = tid; e < kD * kD; e += kThreads) {
      const int r = e / kD, c = e % kD;
      T phi = (((r == c) ? T(1) : T(0)) + s_a[e] + s_b[e] / T(2)) + s_c[e] / T(6);
      if (r < 3 && c < 3) phi = smp.Phi00[3 * r + c];
      s_phi[e] = phi;
    }
    __syncthreads();
    if (tid < 6) {  // corr = A u - w for the rows 6:9 (A1) and 12:15 (A2)
      const int r = tid < 3 ? 6 + tid : 12 + tid - 3;
      const T* w = tid < 3 ? smp.w1 : smp.w2;
      const T au = s_phi[r * kD] * smp.u[0] + s_phi[r * kD + 1] * smp.u[1] +
                   s_phi[r * kD + 2] * smp.u[2];
      s_corr[tid] = au - w[tid % 3];
    }
    __syncthreads();
    if (tid < 18) {
      const int k = tid / 3, c = tid % 3;
      const int r = k < 3 ? 6 + k : 12 + k - 3;
      s_phi[r * kD + c] = s_phi[r * kD + c] - s_corr[k] * smp.s[c];
    }
    __syncthreads();
    // PhiG = Phi @ G (21x12)
    for (int e = tid; e < kD * 12; e += kThreads) {
      const int r = e / 12, c = e % 12;
      T acc = T(0);
      for (int k = 0; k < kD; ++k) {
        T gk = T(0);
        if (k < 3 && c < 3) gk = (k == c) ? T(-1) : T(0);
        else if (k >= 3 && k < 6 && c >= 3 && c < 6) gk = (k == c) ? T(1) : T(0);
        else if (k >= 6 && k < 9 && c >= 6 && c < 9) gk = -smp.Rt[3 * (k - 6) + (c - 6)];
        else if (k >= 9 && k < 12 && c >= 9 && c < 12) gk = (k == c) ? T(1) : T(0);
        acc += s_phi[r * kD + k] * gk;
      }
      s_phig[e] = acc;
    }
    __syncthreads();
    // Q (s_c) = PhiG diag(qc) PhiG^T dt ; Phi_tot' (s_a) = Phi Phi_tot ;
    // Phi Q_tot (s_b)
    for (int e = tid; e < kD * kD; e += kThreads) {
      const int r = e / kD, c = e % kD;
      T q = T(0);
      for (int k = 0; k < 12; ++k) q += s_phig[r * 12 + k] * qc[k] * s_phig[c * 12 + k];
      s_c[e] = q * dt;
    }
    matmul21(s_phi, s_phi_tot, s_a, false);
    matmul21(s_phi, s_q_tot, s_b, false);
    __syncthreads();
    for (int e = tid; e < kD * kD; e += kThreads) s_phi_tot[e] = s_a[e];
    matmul21(s_b, s_phi, s_a, true);  // Phi Q_tot Phi^T
    __syncthreads();
    for (int e = tid; e < kD * kD; e += kThreads) s_q_tot[e] = s_a[e] + s_c[e];
    __syncthreads();
  }
  __syncthreads();

  // ---- apply to the covariance ----
  for (int e = tid; e < kD * kD; e += kThreads) {  // s_a = Phi P_ii
    const int r = e / kD, c = e % kD;
    T acc = T(0);
    for (int k = 0; k < kD; ++k) acc += s_phi_tot[r * kD + k] * cov[k * D + c];
    s_a[e] = acc;
  }
  __syncthreads();
  matmul21(s_a, s_phi_tot, s_b, true);  // Phi P_ii Phi^T
  __syncthreads();
  for (int e = tid; e < kD * kD; e += kThreads) s_b[e] = s_b[e] + s_q_tot[e];
  __syncthreads();
  for (int e = tid; e < D * D; e += kThreads) {
    const int r = e / D, c = e % D;
    T v;
    if (r < kD && c < kD) {
      v = (s_b[r * kD + c] + s_b[c * kD + r]) / T(2);
    } else if (r < kD || c < kD) {  // P_ic = Phi P[:21, 21:] and its transpose
      const int ri = r < kD ? r : c, cc = r < kD ? c : r;
      T acc = T(0);
      for (int k = 0; k < kD; ++k) acc += s_phi_tot[ri * kD + k] * cov[k * D + cc];
      v = (acc + acc) / T(2);
    } else {
      v = (cov[r * D + c] + cov[c * D + r]) / T(2);
    }
    cov_out[e] = v;
  }
  if (tid == 0) {
    if (n_valid > 0) {  // the anchors move to the new state
      for (int k = 0; k < 11; ++k) out[k] = rec[k];
      for (int k = 0; k < 10; ++k) out[11 + k] = rec[k];
    } else {  // nothing ran: state and anchors stay
      for (int k = 0; k < 4; ++k) {
        out[k] = st[k];
        out[11 + k] = st[16 + k];
      }
      for (int k = 0; k < 3; ++k) {
        out[4 + k] = st[7 + k];
        out[7 + k] = st[4 + k];
        out[15 + k] = st[23 + k];
        out[18 + k] = st[20 + k];
      }
      out[10] = st[26];
    }
  }
}

template <typename T>
int launch(const void* imu_t, const void* imu_w, const void* imu_a,
           const void* imu_mask, int I, const void* state_in, const void* qc,
           const void* cov_in, int D, void* state_out, void* cov_out,
           void* stream) {
  propagate_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)imu_t, (const T*)imu_w, (const T*)imu_a,
      (const uint8_t*)imu_mask, I, (const T*)state_in, (const T*)qc,
      (const T*)cov_in, D, (T*)state_out, (T*)cov_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int propagate_f32(const void* imu_t, const void* imu_w,
                             const void* imu_a, const void* imu_mask, int I,
                             const void* state_in, const void* qc,
                             const void* cov_in, int D, void* state_out,
                             void* cov_out, void* stream) {
  return launch<float>(imu_t, imu_w, imu_a, imu_mask, I, state_in, qc, cov_in,
                       D, state_out, cov_out, stream);
}

extern "C" int propagate_f64(const void* imu_t, const void* imu_w,
                             const void* imu_a, const void* imu_mask, int I,
                             const void* state_in, const void* qc,
                             const void* cov_in, int D, void* state_out,
                             void* cov_out, void* stream) {
  return launch<double>(imu_t, imu_w, imu_a, imu_mask, I, state_in, qc, cov_in,
                        D, state_out, cov_out, stream);
}
